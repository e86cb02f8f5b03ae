"""Profiling hooks (ccdm_tpu/utils/profiling.py): a torch.profiler trace
around a block, written as a Chrome trace, and a throughput probe.

The JAX package's `utils/compilation_cache.py` has no counterpart here: the
port compiles nothing at run time but its CUDA and C++ libraries, which
ops/_build.py and data/native_loader.py cache under build/ccdm_tpu_torch/,
keyed by the hash of their sources and flags.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the CPU, and the card where
    one is in use) and write `logdir/trace.json`, a Chrome trace (open it
    in chrome://tracing or Perfetto). Yields the profiler, whose
    key_averages() tables the block's ops."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def throughput_probe(fn: Callable, args: tuple, n_warmup: int = 2, n_iter: int = 5):
    """(mean seconds, the per-call seconds) of fn(*args) after n_warmup
    calls, each call closed by torch.cuda.synchronize where a card is in use."""
    for _ in range(n_warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), times

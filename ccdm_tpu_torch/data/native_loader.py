"""ctypes bridge to the native mmap dataset cache (ccdm_tpu/data/native_loader.py).

The dataset is written once to a flat binary cache (uint8 NHWC images, then
f32 labels); the C++ library of `native/dataset_cache.cpp` mmaps it and
gathers uint8 batches (with an optional per-image horizontal flip) on
threads, into numpy arrays or caller-owned tensors such as pinned host
buffers that a non-blocking copy then moves to the card.

The library is built from that source with g++ at first use into
`build/ccdm_tpu_torch/<hash>/libccdm_io.so` beside the package, keyed by the
source's hash and the flags as ops/_build.py keys the CUDA libraries; the
`native/` directory is only read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataset_cache.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ccdm_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libccdm_io.so"


def build() -> Path:
    """Compile native/dataset_cache.cpp unless its library is built."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the dataset cache library")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libccdm_io.", suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u64, ptr = ctypes.c_uint64, ctypes.c_void_p
    lib.ccdm_cache_open.restype = ptr
    lib.ccdm_cache_open.argtypes = [ctypes.c_char_p]
    lib.ccdm_cache_close.argtypes = [ptr]
    lib.ccdm_cache_info.argtypes = [ptr, ctypes.POINTER(u64)]
    lib.ccdm_cache_gather.argtypes = [ptr, ptr, ctypes.c_int64, ptr, ptr, ctypes.c_int, u64,
                                      ctypes.c_int]
    lib.ccdm_cache_write.argtypes = [ctypes.c_char_p, ptr, ptr, u64, u64, u64, u64, u64]
    return lib


def _address(a) -> int:
    """The data address of a contiguous numpy array or CPU tensor."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or not a.is_contiguous():
            raise ValueError("gather writes into contiguous host tensors")
        return a.data_ptr()
    if not a.flags.c_contiguous:
        raise ValueError("gather writes into C-contiguous arrays")
    return a.ctypes.data


class NativeDatasetCache:
    """mmap-backed uint8 image + f32 label store with a threaded gather."""

    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._handle = lib.ccdm_cache_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open dataset cache {path}")
        self.n, self.h, self.w, self.c, self.ldim = self.info()

    @staticmethod
    def available() -> bool:
        """Whether the library is built or can be built here."""
        try:
            _load_lib()
        except (RuntimeError, OSError):
            return False
        return True

    @staticmethod
    def write(path: str, images: np.ndarray, labels: np.ndarray) -> None:
        """Serialize uint8 NHWC images and labels [N] or [N, D] to the cache."""
        images = np.ascontiguousarray(images, dtype=np.uint8)
        labels2d = np.ascontiguousarray(
            np.asarray(labels, np.float32).reshape(len(labels), -1))
        n, h, w, c = images.shape
        rc = _load_lib().ccdm_cache_write(path.encode(), images.ctypes.data,
                                          labels2d.ctypes.data, n, h, w, c, labels2d.shape[1])
        if rc != 0:
            raise IOError(f"cache write failed: {path}")

    def info(self) -> Tuple[int, int, int, int, int]:
        """(n, h, w, c, label dims) of the cache's header."""
        out = (ctypes.c_uint64 * 5)()
        if self._lib.ccdm_cache_info(self._handle, out) != 0:
            raise RuntimeError("cannot read the dataset cache's header")
        return tuple(int(v) for v in out)

    def gather(self, indices, hflip: bool = False, seed: int = 0, num_threads: int = 0,
               out: Optional[tuple] = None):
        """(images [B, H, W, C] uint8, labels [B, D] f32) of `indices`, each
        image flipped horizontally with probability 1/2 under `hflip` (the
        library's draw from `seed`, per thread). `out` may be caller-owned
        numpy arrays or contiguous host tensors (pinned ones included),
        which are filled and returned."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        bs = len(idx)
        if out is None:
            out = (np.empty((bs, self.h, self.w, self.c), np.uint8),
                   np.empty((bs, self.ldim), np.float32))
        imgs, labs = out
        if (tuple(imgs.shape) != (bs, self.h, self.w, self.c)
                or tuple(labs.shape) != (bs, self.ldim)
                or str(imgs.dtype).rsplit(".", 1)[-1] != "uint8"
                or str(labs.dtype).rsplit(".", 1)[-1] != "float32"):
            raise ValueError("the output buffers must be uint8 [B, H, W, C] and f32 [B, D]")
        rc = self._lib.ccdm_cache_gather(self._handle, idx.ctypes.data, bs, _address(imgs),
                                         _address(labs), int(hflip), seed, num_threads)
        if rc != 0:
            raise RuntimeError("native gather failed")
        return imgs, labs

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ccdm_cache_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

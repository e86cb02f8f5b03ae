"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """"cuda" unless the caller names a device; raises if CUDA is asked for
    (or left as the default) and no card is present. Never falls back."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """cuDNN convs and cuBLAS matmuls in full f32 inside the block, where
    PyTorch by default lets cuDNN round f32 products to TF32's 10-bit
    mantissa. The caller's settings come back after the block."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before

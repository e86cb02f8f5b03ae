"""Image helpers of the sampling path (ccdm_tpu/ops/image.py:27-38)."""

from __future__ import annotations

import torch


def unnormalize_to_zero_to_one(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) * 0.5


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """Clip [0,1] floats, scale by 255 and truncate to uint8."""
    return (x01.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

"""Resnet block: conv3x3 + RMSNorm + FiLM + SiLU, twice, plus the residual.

Counterpart of `resnet_block_reference` (ccdm_tpu/ops/resnet_block.py:33-64).
The JAX main path runs this composition as XLA convs (its Pallas kernel is
opt-in and off by default), so the port runs it as cuDNN convs. The fused
kernel comes in a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ccdm_tpu_torch.ops.attn_block import _rms_norm


def resnet_block_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                           w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor,
                           wres: Optional[torch.Tensor],
                           bres: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, Cin, H, W]; scale/shift [B, Cout]; w1 [Cout, Cin, 3, 3];
    w2 [Cout, Cout, 3, 3]; wres [Cout, Cin, 1, 1] or None (identity
    residual). Conv compute dtype follows x."""
    dt = x.dtype
    film = lambda v: v.to(dt)[:, :, None, None]
    h = F.conv2d(x, w1.to(dt), b1.to(dt), padding=1)
    h = _rms_norm(h, g1, dim=1)
    h = F.silu(h * (film(scale) + 1.0) + film(shift))
    h = F.conv2d(h, w2.to(dt), b2.to(dt), padding=1)
    h = F.silu(_rms_norm(h, g2, dim=1))
    res = x if wres is None else F.conv2d(x, wres.to(dt), bres.to(dt))
    return h + res

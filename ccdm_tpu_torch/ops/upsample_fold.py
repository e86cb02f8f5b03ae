"""Folded nearest-2x upsample + conv3x3 (ccdm_tpu/ops/upsample_fold.py).

Nearest-2x repeats each source pixel 2x2, so a 3x3 conv over the upsampled
map reads, for each output parity (di, dj), a 2x2 neighbourhood of the
source map with the taps that alias one source pixel summed:

    row fold  di=0: rows (i-1: w0), (i: w1+w2)
              di=1: rows (i: w0+w1), (i+1: w2)      (the same for columns)

so conv3x3(nearest2x(x), W) is a conv at source resolution with folded
weights followed by a depth-to-space, exact up to the f32 pre-sum of the
aliased taps. Two foldings, selected by `variant`:
  - "conv3": one 3x3 conv to 4 Cout channels (parity-major), then
    depth-to-space;
  - "conv2x3": two [2, 3] convs (one per row parity, rows padded on one
    side), each to 2 Cout channels: 2/3 of the reference's products.

Tensors are NCHW and the weight is the conv's own [Cout, Cin, 3, 3], so the
parameter tree is the reference composition's. CCDM_TPU_UPSAMPLE selects
the default variant as in the JAX package. `models/layers.Upsample` does
not take the fold: on an H100 the fold ran 2.1x (conv3) and 4.3x (conv2x3)
slower than the reference composition at the 64x64 UNet's 32^2 level
(chip_smoke.py phase 26 (e)), where cuDNN's conv on the upsampled map wins.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

# tap-fold matrices R[parity, folded_row, source_tap_row] (the same for columns)
_FOLD = torch.tensor([[[1, 0, 0], [0, 1, 1], [0, 0, 0]],
                      [[0, 0, 0], [1, 1, 0], [0, 0, 1]]], dtype=torch.float32)

UPSAMPLE_VARIANT = os.environ.get("CCDM_TPU_UPSAMPLE", "reference")


def upsample_conv3x3_folded(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            variant: str | None = None) -> torch.Tensor:
    """nearest2x + conv3x3(weight, bias) computed at source resolution.

    x [B, Cin, h, w]; weight [Cout, Cin, 3, 3]; bias [Cout]. Returns
    [B, Cout, 2h, 2w] in x's dtype."""
    variant = variant or UPSAMPLE_VARIANT
    dt = x.dtype
    cout, cin = weight.shape[:2]
    fold = _FOLD.to(weight.device)
    w32 = weight.float()
    b, _, h, w = x.shape

    if variant == "conv3":
        # K[(p, q, o), i, a, b] = sum_{u, v} FOLD[p, a, u] FOLD[q, b, v] W[o, i, u, v]
        k4 = torch.einsum("pau,qbv,oiuv->pqoiab", fold, fold, w32).reshape(4 * cout, cin, 3, 3)
        y4 = F.conv2d(x, k4.to(dt), padding=1)
        y4 = y4 + bias.repeat(4).to(dt).view(1, -1, 1, 1)
        y = y4.reshape(b, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(b, cout, 2 * h, 2 * w).to(dt)

    if variant == "conv2x3":
        halves = []
        for di, (top, bottom) in ((0, (1, 0)), (1, (0, 1))):
            rf = fold[di][:2] if di == 0 else fold[di][1:]  # [2, 3] row fold
            k2 = torch.einsum("au,qbv,oiuv->qoiab", rf, fold, w32).reshape(2 * cout, cin, 2, 3)
            y2 = F.conv2d(F.pad(x, (1, 1, top, bottom)), k2.to(dt))
            y2 = y2 + bias.repeat(2).to(dt).view(1, -1, 1, 1)
            halves.append(y2.reshape(b, 2, cout, h, w))
        y = torch.stack(halves, dim=1)  # [B, 2 (di), 2 (dj), Cout, h, w]
        return y.permute(0, 3, 4, 1, 5, 2).reshape(b, cout, 2 * h, 2 * w).to(dt)

    raise ValueError(f"unknown folded-upsample variant {variant!r}")


def upsample_conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """The materialized nearest-2x, then the conv in x's dtype."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return F.conv2d(up, weight.to(x.dtype), bias.to(x.dtype), padding=1)

"""Linear attention: the plain version the attention block is built from.

Counterpart of ccdm_tpu/ops/linear_attention.py:28-53. The standalone
linear-attention kernels there (used by the LinearAttention module, which
the Unet does not use) come in a later slice.
"""

from __future__ import annotations

import torch


def make_blockdiag(heads: int, dim_head: int, dtype=torch.float32) -> torch.Tensor:
    """[F, F] block-diagonal ones mask, F = heads * dim_head."""
    return torch.kron(torch.eye(heads, dtype=dtype),
                      torch.ones(dim_head, dim_head, dtype=dtype))


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, N, H, D] -> out [B, N, H, D]; softmaxes and products in
    f32, the output in q's dtype."""
    d = q.shape[-1]
    qf = torch.softmax(q.float(), dim=-1) * (d ** -0.5)
    kf = torch.softmax(k.float(), dim=1)
    ctx = torch.einsum("bnhd,bnhe->bhde", kf, v.float())
    out = torch.einsum("bhde,bnhd->bnhe", ctx, qf)
    return out.to(q.dtype)

"""Non-learned label embeddings: the sinusoidal type.

Counterpart of ccdm_tpu/embedding/analytic.py:37-46 and 60-112 for scalar
labels. The Gaussian-Fourier type draws its projection W from jax.random,
which torch cannot reproduce: its W has to be carried across as data, like
weights, and that comes in a later slice (ROADMAP.md), as do multi-dim
labels.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def sinusoidal_embedding(y: torch.Tensor, embed_dim: int) -> torch.Tensor:
    """[B] scalars -> [B, embed_dim] cos||sin embedding (raw, in [-1, 1])."""
    y = y.reshape(-1).float()
    half = embed_dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=y.device) / half)
    args = y[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if embed_dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def make_fn_y2h(embed_dim: int = 128, embed_type: str = "sinusoidal",
                label_dim: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn_y2h(labels [B] or [B, 1]) -> [B, embed_dim] in [0, 1]."""
    if embed_type != "sinusoidal":
        raise NotImplementedError(
            f"y2h embedding type {embed_type!r}: only 'sinusoidal' is ported; "
            "'gaussian' needs its W carried across as data and 'resnet' is "
            "the ILI slice (ROADMAP.md)")
    if label_dim != 1:
        raise NotImplementedError("multi-dim labels come in a later slice (ROADMAP.md)")

    def fn(labels: torch.Tensor) -> torch.Tensor:
        return (sinusoidal_embedding(labels.reshape(-1), embed_dim) + 1.0) / 2.0

    return fn

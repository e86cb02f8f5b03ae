"""Non-learned label embeddings: sinusoidal and Gaussian-Fourier.

Counterpart of ccdm_tpu/embedding/analytic.py:37-112 for scalar labels.
- sinusoidal: cos||sin with base-10000 geometric frequencies;
- gaussian: sin||cos of 2 pi W y, with a fixed projection W.
y2h rescales to [0, 1] by (e + 1) / 2, y2cov to non-negative by e + 1.

The JAX package draws W from jax.random (PRNGKey(seed), times gfp_scale),
which torch cannot reproduce, so W is data, carried like weights:
`make_fn_y2h` and `make_fn_y2cov` take it. `gaussian_projection` reads it
from <setting>/embed_models/, where scripts/jax_milestone_to_torch.py writes
JAX's; a run of the port that finds none draws one from a torch.Generator
seeded alike and writes it there, so that serving reads the same one.
Multi-dim labels come in a later slice (ROADMAP.md).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch

Y2H_SEED, Y2COV_SEED, GFP_SCALE = 2023, 2024, 30.0


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


def gaussian_fourier_embedding(y: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """[B] scalars x fixed weights [half] -> [B, 2 half] sin||cos features."""
    y = y.reshape(-1).float()
    proj = y[:, None] * W.to(y.device)[None, :] * 2.0 * math.pi
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def projection_path(embed_dir: str, kind: str, embed_dim: int, seed: int) -> str:
    """Where the W of the `kind` ("y2h" or "y2cov") embedding lives."""
    return os.path.join(embed_dir, f"gaussian_W-{kind}_d{embed_dim}_seed{seed}.pt")


def save_projection(path: str, W: torch.Tensor) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"W": W.detach().cpu().float()}, tmp)
    os.replace(tmp, path)


def gaussian_projection(embed_dir: str, kind: str, embed_dim: int, seed: int,
                        write: bool = True) -> torch.Tensor:
    """W [1, embed_dim // 2] of the `kind` embedding: the file under
    `embed_dir` if there is one, else a draw of N(0, 1) * GFP_SCALE from a
    torch.Generator seeded with `seed`, written there when `write`."""
    path = projection_path(embed_dir, kind, embed_dim, seed)
    if os.path.isfile(path):
        W = torch.load(path, map_location="cpu", weights_only=True)["W"]
        if tuple(W.shape) != (1, embed_dim // 2):
            raise ValueError(f"{path} holds W of shape {tuple(W.shape)}, "
                             f"expected {(1, embed_dim // 2)}")
        return W
    gen = torch.Generator().manual_seed(seed)
    W = torch.randn((1, embed_dim // 2), generator=gen) * GFP_SCALE
    if write:
        save_projection(path, W)
    return W


def _make_fn(embed_dim: int, embed_type: str, unit: bool, label_dim: int,
             W: Optional[torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
    if label_dim != 1:
        raise NotImplementedError("multi-dim labels (embedding/combine.py) come in a "
                                  "later slice (ROADMAP.md)")
    if embed_type == "gaussian":
        if W is None:
            raise ValueError("the gaussian embedding needs its projection W "
                             "(embedding/analytic.gaussian_projection)")
        W = W.reshape(-1, embed_dim // 2)[0].float()
    elif embed_type != "sinusoidal":
        raise ValueError(f"analytic embedding got type {embed_type!r}; 'resnet' is the "
                         "trained ILI embedding (embedding/ili.py)")

    def fn(labels: torch.Tensor) -> torch.Tensor:
        y = labels.reshape(-1)
        e = (gaussian_fourier_embedding(y, W) if embed_type == "gaussian"
             else sinusoidal_embedding(y, embed_dim))
        return (e + 1.0) / 2.0 if unit else e + 1.0

    return fn


def make_fn_y2h(embed_dim: int = 128, embed_type: str = "sinusoidal", label_dim: int = 1,
                W: Optional[torch.Tensor] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn_y2h(labels [B] or [B, 1]) -> [B, embed_dim] in [0, 1]."""
    return _make_fn(embed_dim, embed_type, True, label_dim, W)


def make_fn_y2cov(cov_dim: int, embed_type: str = "sinusoidal", label_dim: int = 1,
                  W: Optional[torch.Tensor] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn_y2cov(labels) -> [B, C*H*W] non-negative (feeds H(y) = exp(-.))."""
    return _make_fn(cov_dim, embed_type, False, label_dim, W)

"""Non-learned label embeddings: sinusoidal and Gaussian-Fourier.

Counterpart of ccdm_tpu/embedding/analytic.py:28-112.
- sinusoidal: cos||sin with base-10000 geometric frequencies;
- gaussian: sin||cos of 2 pi W y, with a fixed projection W, one row per
  selected label dim.
y2h rescales to [0, 1] by (e + 1) / 2, y2cov to non-negative by e + 1.
Multi-dim labels [B, D]: every dim up to 20, above that every (D // 10)-th,
at most 10 (`selected_dims`), each embedded on its own, then the mean or a
combiner of embedding/combine.py. Labels [B] or [B, 1] take dim 0's
embedding, whatever label_dim is (the EMA grid and the trajectory GIF pass
scalar labels on multi-dim data).

The JAX package draws W from jax.random (PRNGKey(seed), times gfp_scale)
and a combiner's weights from PRNGKey(seed + 7), which torch cannot
reproduce, so both are data, carried like weights: `make_fn_y2h` and
`make_fn_y2cov` take them. `gaussian_projection` reads W from
<setting>/embed_models/, where scripts/jax_milestone_to_torch.py writes
JAX's; a run of the port that finds none draws one from a torch.Generator
seeded alike and writes it there, so that serving reads the same one
(combine.combiner_weights does the same for a combiner).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ccdm_tpu_torch.embedding.combine import combine

Y2H_SEED, Y2COV_SEED, GFP_SCALE = 2023, 2024, 30.0
COMBINER_SEED_OFFSET = 7  # a combiner's weights come from seed + 7


def selected_dims(label_dim: int) -> Sequence[int]:
    """Every dim up to 20; above that every (label_dim // 10)-th, at most 10."""
    if label_dim <= 20:
        return list(range(label_dim))
    return list(range(0, label_dim, max(1, label_dim // 10)))[:10]


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


def projection_path(embed_dir: str, kind: str, embed_dim: int, seed: int,
                    num_dims: int = 1) -> str:
    """Where the W of the `kind` ("y2h" or "y2cov") embedding over
    `num_dims` selected label dims lives."""
    dims = "" if num_dims == 1 else f"_n{num_dims}"
    return os.path.join(embed_dir, f"gaussian_W-{kind}_d{embed_dim}{dims}_seed{seed}.pt")


def save_projection(path: str, W: torch.Tensor) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"W": W.detach().cpu().float()}, tmp)
    os.replace(tmp, path)


def gaussian_projection(embed_dir: str, kind: str, embed_dim: int, seed: int,
                        write: bool = True, num_dims: int = 1) -> torch.Tensor:
    """W [num_dims, embed_dim // 2] of the `kind` embedding (num_dims:
    len(selected_dims(label_dim))): the file under `embed_dir` if there is
    one, else a draw of N(0, 1) * GFP_SCALE from a torch.Generator seeded
    with `seed`, written there when `write`."""
    path = projection_path(embed_dir, kind, embed_dim, seed, num_dims)
    shape = (num_dims, embed_dim // 2)
    if os.path.isfile(path):
        W = torch.load(path, map_location="cpu", weights_only=True)["W"]
        if tuple(W.shape) != shape:
            raise ValueError(f"{path} holds W of shape {tuple(W.shape)}, expected {shape}")
        return W
    gen = torch.Generator().manual_seed(seed)
    W = torch.randn(shape, generator=gen) * GFP_SCALE
    if write:
        save_projection(path, W)
    return W


def _make_fn(embed_dim: int, embed_type: str, unit: bool, label_dim: int,
             W: Optional[torch.Tensor], dim_combination: str,
             combiner: Optional[nn.Module]) -> Callable[[torch.Tensor], torch.Tensor]:
    dims = selected_dims(label_dim)
    if embed_type == "gaussian":
        if W is None:
            raise ValueError("the gaussian embedding needs its projection W "
                             "(embedding/analytic.gaussian_projection)")
        W = W.reshape(-1, embed_dim // 2).float()
        if W.shape[0] != len(dims):
            raise ValueError(f"W has {W.shape[0]} rows for {len(dims)} selected label dims")
    elif embed_type != "sinusoidal":
        raise ValueError(f"analytic embedding got type {embed_type!r}; 'resnet' is the "
                         "trained ILI embedding (embedding/ili.py)")
    if dim_combination != "mean" and label_dim > 1 and combiner is None:
        raise ValueError(f"--dim_combination {dim_combination} needs its combiner's weights "
                         "(embedding/combine.combiner_weights)")
    if label_dim == 1:
        combiner = None

    def embed(y: torch.Tensor, i: int) -> torch.Tensor:
        e = (gaussian_fourier_embedding(y, W[i]) if embed_type == "gaussian"
             else sinusoidal_embedding(y, embed_dim))
        return (e + 1.0) / 2.0 if unit else e + 1.0

    def fn(labels: torch.Tensor) -> torch.Tensor:
        labels = labels.float()
        if labels.ndim == 1 or labels.shape[-1] == 1:
            return embed(labels.reshape(-1), 0)
        per_dim = torch.stack([embed(labels[:, d], i) for i, d in enumerate(dims)])
        with torch.no_grad():
            return combine(per_dim, combiner)

    return fn


def make_fn_y2h(embed_dim: int = 128, embed_type: str = "sinusoidal", label_dim: int = 1,
                W: Optional[torch.Tensor] = None, dim_combination: str = "mean",
                combiner: Optional[nn.Module] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn_y2h(labels [B] or [B, D]) -> [B, embed_dim] in [0, 1] (a combiner
    other than the mean may leave that range, as in the JAX package)."""
    return _make_fn(embed_dim, embed_type, True, label_dim, W, dim_combination, combiner)


def make_fn_y2cov(cov_dim: int, embed_type: str = "sinusoidal", label_dim: int = 1,
                  W: Optional[torch.Tensor] = None, dim_combination: str = "mean",
                  combiner: Optional[nn.Module] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn_y2cov(labels) -> [B, C*H*W] non-negative (feeds H(y) = exp(-.))."""
    return _make_fn(cov_dim, embed_type, False, label_dim, W, dim_combination, combiner)

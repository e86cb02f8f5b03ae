"""Combiners of per-dimension label embeddings (multi-dim labels).

Counterpart of ccdm_tpu/embedding/combine.py: given per-dimension
embeddings stacked [D, B, E], each gives [B, E]:
- mean: the plain average (no module; `make_combiner` returns None);
- weighted: softmax of the learned per-dim weights `dim_weights` (ones at
  init), then the weighted sum;
- attention: a score per (B, D) from `attn_fc1` (64 hidden units), tanh and
  `attn_fc2`, softmax over D, the weighted sum;
- cross: [B, D*E] through `fc1` to 2E, ReLU, `fc2` to E;
- cross_attention: 4 heads; the query is the mean over D through `q_proj`,
  keys and values the per-dim embeddings through `k_proj` and `v_proj`;
  `out_proj`, then the residual with the mean and LayerNorm `norm`
  (eps 1e-6, flax's).
The parameter names are flax's, so utils/convert.state_dict_from_jax maps
JAX's variables one to one (a Dense kernel [in, out] becomes a Linear
weight [out, in]).

The JAX package draws a combiner's weights from PRNGKey(seed) and never
trains or saves them, and torch cannot reproduce that draw. So the weights
are data, as the gaussian embedding's W is (embedding/analytic.py):
`combiner_weights` reads them from <setting>/embed_models/, where
scripts/jax_milestone_to_torch.py writes JAX's init, or draws them with
flax's initialisers from a torch.Generator seeded with `seed` and writes
them there (not when load-only), so that serving reads the same ones.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import flax_init_


class WeightedCombiner(nn.Module):
    def __init__(self, num_dims: int):
        super().__init__()
        self.dim_weights = nn.Parameter(torch.ones(num_dims))

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:  # [D, B, E]
        return (stacked * torch.softmax(self.dim_weights, 0)[:, None, None]).sum(0)


class AttentionCombiner(nn.Module):
    def __init__(self, embed_dim: int, hidden: int = 64):
        super().__init__()
        self.attn_fc1 = nn.Linear(embed_dim, hidden)
        self.attn_fc2 = nn.Linear(hidden, 1)

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:
        x = stacked.transpose(0, 1)  # [B, D, E]
        scores = self.attn_fc2(torch.tanh(self.attn_fc1(x)))[..., 0]  # [B, D]
        return (x * torch.softmax(scores, -1)[..., None]).sum(1)


class CrossCombiner(nn.Module):
    def __init__(self, embed_dim: int, num_dims: int):
        super().__init__()
        self.fc1 = nn.Linear(num_dims * embed_dim, 2 * embed_dim)
        self.fc2 = nn.Linear(2 * embed_dim, embed_dim)

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:
        x = stacked.transpose(0, 1).reshape(stacked.shape[1], -1)  # [B, D*E]
        return self.fc2(F.relu(self.fc1(x)))


class CrossAttentionCombiner(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(embed_dim, embed_dim))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:
        x = stacked.transpose(0, 1)  # [B, D, E]
        b, d, _ = x.shape
        h, hd = self.num_heads, self.embed_dim // self.num_heads
        q_in = x.mean(1, keepdim=True)  # [B, 1, E]
        q = self.q_proj(q_in).reshape(b, 1, h, hd)
        k = self.k_proj(x).reshape(b, d, h, hd)
        v = self.v_proj(x).reshape(b, d, h, hd)
        attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", q * hd ** -0.5, k), -1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, self.embed_dim)
        return self.norm(self.out_proj(out) + q_in[:, 0])


def make_combiner(kind: str, embed_dim: int, num_dims: int) -> Optional[nn.Module]:
    """The combiner module of --dim_combination `kind`; None for mean."""
    if kind == "mean":
        return None
    if kind == "weighted":
        return WeightedCombiner(num_dims)
    if kind == "attention":
        return AttentionCombiner(embed_dim)
    if kind == "cross":
        return CrossCombiner(embed_dim, num_dims)
    if kind == "cross_attention":
        return CrossAttentionCombiner(embed_dim)
    raise ValueError(f"unknown dim_combination {kind}")


def combine(per_dim: torch.Tensor, combiner: Optional[nn.Module]) -> torch.Tensor:
    """[D, B, E] -> [B, E]: the mean, or `combiner` (on the input's device)."""
    if combiner is None:
        return per_dim.mean(0)
    return combiner(per_dim)


def combiner_path(embed_dir: str, kind: str, dim_combination: str, embed_dim: int,
                  num_dims: int, seed: int) -> str:
    """Where the weights of the `kind` ("y2h" or "y2cov") combiner live."""
    return os.path.join(embed_dir, f"combiner-{kind}_{dim_combination}_d{embed_dim}"
                                   f"_n{num_dims}_seed{seed}.pt")


def save_combiner(path: str, combiner: nn.Module) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu().float() for k, v in combiner.state_dict().items()}, tmp)
    os.replace(tmp, path)


def combiner_weights(embed_dir: str, kind: str, dim_combination: str, embed_dim: int,
                     num_dims: int, seed: int, write: bool = True,
                     device=None) -> Optional[nn.Module]:
    """The frozen combiner of `dim_combination` over `num_dims` dims (None
    for mean) on `device` (the CPU if None): the weights in the file under
    `embed_dir` if there is one, else flax's initialisers drawn from a
    torch.Generator seeded with `seed`, written there when `write`."""
    combiner = make_combiner(dim_combination, embed_dim, num_dims)
    if combiner is None:
        return None
    path = combiner_path(embed_dir, kind, dim_combination, embed_dim, num_dims, seed)
    if os.path.isfile(path):
        combiner.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    else:
        flax_init_(combiner, torch.Generator().manual_seed(seed))
        if write:
            save_combiner(path, combiner)
    return combiner.to(device).eval().requires_grad_(False)

"""The DiT-style ViT denoiser (--architecture vit), in PyTorch.

Counterpart of ccdm_tpu/models/vit.py: a 7x7 init conv at full spatial
resolution straight to the transformer width dim * dim_mults[-1] (JAX's
deviation from the reference, whose blocks run at dims[-1] while its init
conv emits init_dim), num_blocks DiTBlocks over every pixel as a token
(attention, then FiLM scale and shift from concat(t_emb, c_emb), then the
MLP), a 1x1 out conv. The null embedding (trainable, width dim) replaces the
label features before cond_dense_2 where keep_mask is False.

dtype: init_conv computes in the model's dtype (bf16 under --train_amp)
and final_conv in f32; every other layer in the promoted dtype of its input
and weights, as flax's layers with dtype=None do, so block 0's norm1 sees
the bf16 map and the model runs in f32 from block 0's first residual on.
The t and c embeddings are cast to the model's dtype, and their SiLU
rounds each op to it as XLA does (layers.flax_silu).

The token attention computes softmax(q k^T / sqrt(d)) v in f32 through
F.scaled_dot_product_attention; on the card it is pinned to the
memory-efficient backend, so a silent drop to the math backend (which
would hold the [B, heads, N, N] scores: 256 MiB an image and block at 64x64)
raises instead. JAX computes it with einsums (`token_attention_einsum`).

`forward` takes and returns NHWC like the JAX module; the two convolutions
run NCHW in channels_last, the blocks on the [B, H, W, C] view of it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import (
    PromotingConv2d,
    PromotingLinear,
    flax_batch_norm,
    flax_init_,
    flax_silu,
    sinusoidal_pos_emb,
)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis with gain g and bias b:
    biased variance, eps 1e-5, the statistics rounded to the input's dtype
    (jnp.mean and jnp.var of a bf16 map), the output promoted by g and b."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True).to(x.dtype)
        var = xf.var(-1, unbiased=False, keepdim=True).to(x.dtype)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.g + self.b


def token_attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """JAX's form: [B, heads, N, D] f32, q scaled by D^-1/2, the scores
    materialised."""
    sim = torch.einsum("bhid,bhjd->bhij", q * (q.shape[-1] ** -0.5), k)
    return torch.einsum("bhij,bhjd->bhid", torch.softmax(sim, dim=-1), v)


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T D^-1/2) v of [B, heads, N, D], by
    F.scaled_dot_product_attention; on a CUDA tensor only its
    memory-efficient backend may run."""
    scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, scale=scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)


class TokenAttention(nn.Module):
    """Multi-head attention over the spatial tokens: qkv Dense (with bias),
    channels split as (3, heads, head_dim), the attention in f32 cast back
    to the input's dtype, a Dense out."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = PromotingLinear(dim, 3 * dim, bias=qkv_bias)
        self.proj = PromotingLinear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C]."""
        b, hh, ww, c = x.shape
        n = hh * ww
        qkv = self.qkv(x.reshape(b, n, c)).reshape(b, n, 3, self.num_heads, -1)
        q, k, v = (qkv[:, :, i].transpose(1, 2).float() for i in range(3))
        out = token_attention(q, k, v).transpose(1, 2).reshape(b, n, self.dim).to(x.dtype)
        return self.proj(out).reshape(b, hh, ww, self.dim)


class DiTBlock(nn.Module):
    """x + attn(norm1(x)); FiLM x (1 + scale) + shift from
    tc_mlp(silu(concat(t_emb, c_emb))); x + mlp_fc2(silu(mlp_fc1(norm2(x))))."""

    def __init__(self, dim: int, num_heads: int, cond_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.tc_mlp = PromotingLinear(cond_dim, 2 * dim)
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = TokenAttention(dim, num_heads)
        self.norm2 = ChannelLayerNorm(dim)
        self.mlp_fc1 = PromotingLinear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = PromotingLinear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, c_emb: torch.Tensor) -> torch.Tensor:
        tc = self.tc_mlp(flax_silu(torch.cat([t_emb, c_emb], dim=-1)))[:, None, None, :]
        scale, shift = tc.chunk(2, dim=-1)
        x = x + self.attn(self.norm1(x))
        x = x * (scale + 1.0) + shift
        h = self.mlp_fc2(F.silu(self.mlp_fc1(self.norm2(x))))
        return x + h


class ViT(nn.Module):
    def __init__(self, dim: int, embed_input_dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), in_channels: int = 3,
                 out_dim: Optional[int] = None, learned_variance: bool = False,
                 attn_heads: int = 4, num_blocks: int = 8,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.dim, self.dtype, self.num_blocks = dim, dtype, num_blocks
        width = dim * dim_mults[-1]
        time_dim = cond_emb_dim = 4 * dim
        if out_dim is None:
            out_dim = in_channels * (2 if learned_variance else 1)

        self.cond_dense_1 = PromotingLinear(embed_input_dim, dim)
        self.cond_bn_1 = nn.BatchNorm1d(dim, eps=1e-5)
        self.null_cond_emb = nn.Parameter(torch.empty(dim))
        self.cond_dense_2 = PromotingLinear(dim, cond_emb_dim)
        self.cond_bn_2 = nn.BatchNorm1d(cond_emb_dim, eps=1e-5)
        self.time_dense_1 = PromotingLinear(dim, time_dim)
        self.time_dense_2 = PromotingLinear(time_dim, time_dim)
        self.init_conv = PromotingConv2d(in_channels, width, 7, padding=3, compute_dtype=dtype)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", DiTBlock(width, attn_heads, time_dim + cond_emb_dim))
        self.final_conv = PromotingConv2d(width, out_dim, 1, compute_dtype=torch.float32)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, t: torch.Tensor, labels_emb: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """x [B, H, W, Cin]; t [B] int; labels_emb [B, embed_input_dim];
        keep_mask [B] bool, False rows get the null embedding (None keeps
        all); train: BatchNorm on batch statistics, updating the running
        ones. Returns [B, H, W, Cout] f32."""
        dt = self.dtype
        c = F.relu(flax_batch_norm(self.cond_bn_1, self.cond_dense_1(labels_emb), train))
        if keep_mask is not None:
            c = torch.where(keep_mask[:, None], c, self.null_cond_emb[None, :].to(c.dtype))
        c_emb = F.relu(flax_batch_norm(self.cond_bn_2, self.cond_dense_2(c), train))
        t_emb = self.time_dense_1(sinusoidal_pos_emb(t, self.dim))
        t_emb = self.time_dense_2(F.gelu(t_emb, approximate="tanh"))

        x = self.init_conv(x.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        x = x.permute(0, 2, 3, 1)  # the [B, H, W, C] view of channels_last
        t_emb, c_emb = t_emb.to(dt), c_emb.to(dt)
        for i in range(self.num_blocks):
            x = self.get_submodule(f"block_{i}")(x, t_emb, c_emb)
        out = self.final_conv(x.permute(0, 3, 1, 2))
        return out.float().permute(0, 2, 3, 1)

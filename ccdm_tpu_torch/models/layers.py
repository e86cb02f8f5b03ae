"""Building blocks of the denoiser, in PyTorch.

Counterpart of ccdm_tpu/models/layers.py. Tensors are NCHW in channels_last
memory format, so a [B, H, W, C] view of them is free. Parameters are f32;
each layer casts its weights to the activation dtype at use, as flax's
`dtype=` does, and the parameter names follow the flax tree so that
utils/convert.py maps one onto the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.ops import attn_block, resnet_block
from ccdm_tpu_torch.ops.attn_block import _rms_norm
from ccdm_tpu_torch.ops.linear_attention import linear_attention
from ccdm_tpu_torch.parallel.mesh import global_moments


class Conv2d(nn.Conv2d):
    """nn.Conv2d computed in the input's dtype (flax nn.Conv(dtype=...))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computed in the input's dtype (flax nn.Dense(dtype=...))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def _promoted(x: torch.Tensor, dtype, *params) -> torch.dtype:
    """flax's compute dtype of a layer: `dtype` where given, else the
    promoted dtype of the input and the parameters (dtype=None)."""
    if dtype is not None:
        return dtype
    out = x.dtype
    for p in params:
        if p is not None:
            out = torch.promote_types(out, p.dtype)
    return out


class PromotingConv2d(nn.Conv2d):
    """nn.Conv2d computed as flax nn.Conv computes: in `compute_dtype`
    where given, else in the promoted dtype of the input and the weights
    (a bf16 input or bf16 weights meet f32 ones in f32)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.compute_dtype, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class PromotingLinear(nn.Linear):
    """nn.Linear computed as flax nn.Dense computes (PromotingConv2d's rule)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.compute_dtype, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def flax_silu(x: torch.Tensor) -> torch.Tensor:
    """nn.silu as XLA computes it: x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype. In f32 that is F.silu; on a bf16 input (the
    t and c embeddings under --train_amp) F.silu would round once where
    XLA rounds four times, a bf16 ulp apart."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm(num_groups) over the channels of NCHW: eps 1e-6,
    statistics and output in f32 whatever the input's dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__(num_groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def flax_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """flax nn.BatchNorm (momentum 0.99, eps 1e-5) in f32. train: batch
    statistics, with the variance mean(x^2) - mean(x)^2 (biased), and the
    running statistics moved 1% towards them; else the running ones. Under
    a data-parallel step (`bn.sync_mesh`, set by parallel.sharded_apply)
    the statistics are the global batch's."""
    x = x.float()
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    mean, var = global_moments(x, [0], getattr(bn, "sync_mesh", None))
    with torch.no_grad():
        bn.running_mean.mul_(0.99).add_(0.01 * mean)
        bn.running_var.mul_(0.99).add_(0.01 * var)
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to +-2 std, scaled to
    variance 1/fan_in (drawn by the inverse CDF)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=gen) * (hi - lo) + lo
    with torch.no_grad():
        w.copy_(torch.erfinv(2 * u - 1) * math.sqrt(2) * std)


@torch.no_grad()
def flax_init_(model: nn.Module, gen: torch.Generator, flax_layout: tuple = ()) -> None:
    """flax's initialisers over `model`, in named_parameters() order:
    lecun_normal kernels (fan-in: every axis but the output one, dim 0 in
    torch's layouts, dim 1 in the kernels named in `flax_layout`), zero
    biases, unit norm gains and BatchNorm scales, null embeddings
    -|N(0, 1)|; BatchNorm running statistics reset."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2:
            lecun_normal_(p, p.shape[0] if leaf in flax_layout else p[0].numel(), gen)
        elif leaf.startswith("null_"):
            p.copy_(-torch.randn(p.shape, generator=gen).abs())
        elif leaf.endswith("bias") or leaf == "b":
            p.zero_()
        else:
            p.fill_(1.0)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.reset_running_stats()


class RMSNorm(nn.Module):
    """Channel RMSNorm with a learned gain; f32 statistics, output in the
    activation dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.g, dim=1)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Timestep embedding sin||cos with frequencies exp(-log(1e4) i/(half-1))
    (SinusoidalPosEmb)."""
    t = t.reshape(-1).float()
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class FusedResnetBlock(nn.Module):
    """Resnet block with FiLM from concat(t_emb, c_emb); the parameter tree
    of the flax FusedResnetBlock, with conv kernels in OIHW. The block runs
    through ops/resnet_block.fused_resnet_block: kernels #10 + #11 with
    CCDM_TPU_FUSED_RESBLOCK=1, else the cuDNN composition."""

    def __init__(self, dim_in: int, dim_out: int, cond_dim: int):
        super().__init__()
        self.tc_mlp = Linear(cond_dim, dim_out * 2)
        self.conv1_weight = nn.Parameter(torch.empty(dim_out, dim_in, 3, 3))
        self.conv1_bias = nn.Parameter(torch.zeros(dim_out))
        self.norm1_g = nn.Parameter(torch.ones(dim_out))
        self.conv2_weight = nn.Parameter(torch.empty(dim_out, dim_out, 3, 3))
        self.conv2_bias = nn.Parameter(torch.zeros(dim_out))
        self.norm2_g = nn.Parameter(torch.ones(dim_out))
        if dim_in != dim_out:
            self.res_weight = nn.Parameter(torch.empty(dim_out, dim_in, 1, 1))
            self.res_bias = nn.Parameter(torch.zeros(dim_out))
        else:
            self.res_weight = self.res_bias = None

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                c_emb: torch.Tensor) -> torch.Tensor:
        tc = self.tc_mlp(F.silu(torch.cat([t_emb, c_emb], dim=-1)))
        scale, shift = tc.chunk(2, dim=-1)
        return resnet_block.fused_resnet_block(
            x, scale, shift, self.conv1_weight, self.conv1_bias, self.norm1_g,
            self.conv2_weight, self.conv2_bias, self.norm2_g,
            self.res_weight, self.res_bias)


class LinearAttention(nn.Module):
    """Linear attention over the spatial map: 1x1 conv to q, k, v (no bias),
    `ops/linear_attention.linear_attention` on [B, N, H, D] (kernel #6 on the
    card), 1x1 conv out, RMSNorm. No model builds it: the Unet's blocks are
    `FusedLinearAttentionBlock`, which computes PreNormResidual(this)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)
        self.out_norm = RMSNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).reshape(b, hh * ww, 3, self.heads,
                                                          self.dim_head)
        out = linear_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out = out.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
        return self.out_norm(self.to_out(out))


class FusedLinearAttentionBlock(nn.Module):
    """x + out_norm(Wout . linattn(Wqkv . pre_norm(x))) through the fused
    kernel; weights in the flax layout (qkv_kernel [C, 3F], out_kernel
    [F, C])."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm_g = nn.Parameter(torch.ones(dim))
        self.qkv_kernel = nn.Parameter(torch.empty(dim, 3 * hidden))
        self.out_kernel = nn.Parameter(torch.empty(hidden, dim))
        self.out_bias = nn.Parameter(torch.zeros(dim))
        self.out_norm_g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        x2d = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c).contiguous()
        y = attn_block.fused_attn_block(x2d, self.norm_g, self.qkv_kernel,
                                        self.out_kernel, self.out_bias,
                                        self.out_norm_g, self.heads, self.dim_head)
        return y.view(b, hh, ww, c).permute(0, 3, 1, 2)


class Attention(nn.Module):
    """Full softmax attention over the spatial map (the mid block); the
    attention math runs in f32 whatever the activation dtype."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        n = hh * ww
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = q.float() * (self.dim_head ** -0.5)
        sim = torch.einsum("bihd,bjhd->bhij", q, k.float())
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v.float()).to(x.dtype)
        return self.to_out(out.reshape(b, hh, ww, -1).permute(0, 3, 1, 2))


class PreNormResidual(nn.Module):
    """x + fn(RMSNorm(x))."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(self.norm(x))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """4x4 conv, stride 2, padding 1."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)

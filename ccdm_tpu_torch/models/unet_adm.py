"""The ADM GroupNorm UNet denoiser (--architecture adm), in PyTorch.

Counterpart of ccdm_tpu/models/unet_adm.py: init 3x3 conv -> per level
[ADMResBlock (+ ADMAttentionBlock where the level's downsampling factor
`ds` is in attention_resolutions)] x num_res_blocks, then a stride-2 conv
(not at the last level) -> mid [resnet block, attention, resnet block],
both time-only -> the mirrored up path, num_res_blocks + 1 blocks a level
over the skip concats, nearest 2x + 3x3 conv between levels -> GroupNorm,
SiLU, 3x3 out conv. FiLM (use_scale_shift_norm) from concat(t_emb, c_emb)
in every block but the mid ones. The null embedding -|N(0, 1)| at
4 * model_channels replaces the label embedding after classes_bn where
keep_mask is False; it is frozen (stop_gradient in JAX, detached here), so
its gradient is exactly 0 and Adam never moves it.

dtype: only init_conv computes in the model's dtype (bf16 under
--train_amp) and out_conv in f32; every other layer computes in the
promoted dtype of its input and its weights, as flax's layers with
dtype=None do. So the model runs in f32 from the first resnet block on,
and bf16 weights (--samp_precast_bf16) are used in f32. The t and c
embeddings are cast to the model's dtype, and their SiLU rounds each op
to it as XLA does (layers.flax_silu).

`forward` takes and returns NHWC like the JAX module; inside, tensors are
NCHW in channels_last memory format. Module and parameter names follow the
flax tree, so utils/convert.py maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import (
    GroupNorm,
    PromotingConv2d,
    PromotingLinear,
    flax_batch_norm,
    flax_init_,
    flax_silu,
)


def adm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """cos || sin with frequencies exp(-ln(1e4) i / half), half = dim // 2
    (the divisor is half, unlike sinusoidal_pos_emb's half - 1), a zero
    column appended at odd dim."""
    t = t.reshape(-1).float()
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ADMResBlock(nn.Module):
    """GroupNorm, SiLU, 3x3 conv; FiLM from tc_mlp(silu(tc)) around norm2
    (scale and shift with use_scale_shift_norm, else added before it);
    SiLU, 3x3 conv; a 1x1 shortcut where the width changes."""

    def __init__(self, in_channels: int, out_channels: int, tc_dim: int, num_groups: int = 32,
                 use_scale_shift_norm: bool = True, has_cond: bool = True):
        super().__init__()
        self.use_scale_shift_norm, self.has_cond = use_scale_shift_norm, has_cond
        self.norm1 = GroupNorm(num_groups, in_channels)
        self.conv1 = PromotingConv2d(in_channels, out_channels, 3, padding=1)
        self.tc_mlp = PromotingLinear(
            tc_dim, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.norm2 = GroupNorm(num_groups, out_channels)
        self.conv2 = PromotingConv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (PromotingConv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                c_emb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        tc = t_emb if (c_emb is None or not self.has_cond) else torch.cat([t_emb, c_emb], -1)
        tc = self.tc_mlp(flax_silu(tc))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = tc.chunk(2, dim=1)
            h = self.norm2(h) * (1.0 + scale) + shift
            h = self.conv2(F.silu(h))
        else:
            h = self.conv2(F.silu(self.norm2(h + tc)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return h + x


class ADMAttentionBlock(nn.Module):
    """x + proj(attention(qkv(GroupNorm(x)))): a 1x1 conv to q, k, v (no
    bias), channels split as (3, heads, head_dim), softmax attention with q
    and k each scaled by head_dim^-1/4 in f32, cast back to the input's
    dtype, a 1x1 conv out. N <= 256 at 64x64 with attention at 4_8, so the
    scores stay in einsum form."""

    def __init__(self, channels: int, num_heads: int = 4, num_groups: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(num_groups, channels)
        self.qkv = PromotingConv2d(channels, 3 * channels, 1, bias=False)
        self.proj = PromotingConv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(self.norm(x)).permute(0, 2, 3, 1).reshape(
            b, hh * ww, 3, self.num_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / (head_dim ** 0.25)
        sim = torch.einsum("bihd,bjhd->bhij", (q * scale).float(), (k * scale).float())
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(sim, dim=-1), v.float())
        out = out.to(x.dtype).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj(out) + x


class ADMUnet(nn.Module):
    def __init__(self, embed_input_dim: int = 128, in_channels: int = 3,
                 model_channels: int = 128, out_channels: Optional[int] = None,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (8, 16),
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_heads: int = 4,
                 use_scale_shift_norm: bool = True, learned_variance: bool = False,
                 num_groups: int = 32, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        mc = self.model_channels = model_channels
        self.dtype = dtype
        self.channel_mult, self.num_res_blocks = tuple(channel_mult), num_res_blocks
        time_dim = cond_dim = 4 * mc
        if out_channels is None:
            out_channels = in_channels * (2 if learned_variance else 1)

        self.time_dense_1 = PromotingLinear(mc, time_dim)
        self.time_dense_2 = PromotingLinear(time_dim, time_dim)
        self.classes_dense = PromotingLinear(embed_input_dim, cond_dim)
        self.classes_bn = nn.BatchNorm1d(cond_dim, eps=1e-5)
        self.null_classes_emb = nn.Parameter(torch.empty(cond_dim))
        self.init_conv = PromotingConv2d(in_channels, mc, 3, padding=1, compute_dtype=dtype)

        res = lambda cin, cout, cond=True: ADMResBlock(
            cin, cout, time_dim + cond_dim if cond else time_dim, num_groups,
            use_scale_shift_norm, has_cond=cond)
        attn = lambda c: ADMAttentionBlock(c, num_heads, num_groups)
        ch, skips, ds = mc, [mc], 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}", res(ch, mult * mc))
                ch = mult * mc
                if ds in attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                skips.append(ch)
            if level != len(self.channel_mult) - 1:
                self.add_module(f"down_{level}_downsample",
                                PromotingConv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
                ds *= 2
        self.mid_block1 = res(ch, ch, cond=False)
        self.mid_attn = attn(ch)
        self.mid_block2 = res(ch, ch, cond=False)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}", res(ch + skips.pop(), mult * mc))
                ch = mult * mc
                if ds in attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn", attn(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"up_{level}_upsample", PromotingConv2d(ch, ch, 3, padding=1))
                    ds //= 2
        self.out_norm = GroupNorm(num_groups, ch)
        self.out_conv = PromotingConv2d(ch, out_channels, 3, padding=1,
                                        compute_dtype=torch.float32)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def _block(self, name: str, h: torch.Tensor, *cond) -> torch.Tensor:
        h = self.get_submodule(name)(h, *cond)
        attn = getattr(self, f"{name}_attn", None)
        return h if attn is None else attn(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor, labels_emb: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """x [B, H, W, Cin]; t [B] int; labels_emb [B, embed_input_dim];
        keep_mask [B] bool, False rows get the null embedding (None keeps
        all); train: BatchNorm on batch statistics, updating the running
        ones. Returns [B, H, W, Cout] f32."""
        dt = self.dtype
        t_emb = self.time_dense_1(adm_timestep_embedding(t, self.model_channels))
        t_emb = self.time_dense_2(F.silu(t_emb))
        c = F.relu(flax_batch_norm(self.classes_bn, self.classes_dense(labels_emb), train))
        if keep_mask is not None:
            null = self.null_classes_emb.detach()  # frozen: stop_gradient
            c = torch.where(keep_mask[:, None], c, null[None, :].to(c.dtype))
        t_emb, c_emb = t_emb.to(dt), c.to(dt)

        h = self.init_conv(x.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        skips = [h]
        last = len(self.channel_mult) - 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = self._block(f"down_{level}_{i}", h, t_emb, c_emb)
                skips.append(h)
            if level != last:
                h = self.get_submodule(f"down_{level}_downsample")(h)
                skips.append(h)

        h = self.mid_block1(h, t_emb, None)
        h = self.mid_attn(h)
        h = self.mid_block2(h, t_emb, None)

        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)  # promotes, as jnp.concatenate
                h = self._block(f"up_{level}_{i}", h, t_emb, c_emb)
                if level and i == self.num_res_blocks:
                    h = self.get_submodule(f"up_{level}_upsample")(
                        F.interpolate(h, scale_factor=2, mode="nearest"))

        out = self.out_conv(F.silu(self.out_norm(h)))
        return out.float().permute(0, 2, 3, 1)

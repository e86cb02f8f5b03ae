"""Conditional UNet denoiser, in PyTorch.

Counterpart of ccdm_tpu/models/unet.py:45-151: init 7x7 conv -> per level
[resnet block x2 + fused linear-attention block + downsample] -> mid
[resnet block, full attention, resnet block] -> the mirrored up path with
skip concats -> a final resnet block over concat(x, r) -> 1x1 out conv.
Conditioning: sinusoidal time MLP and the label-embedding MLP pair with
BatchNorm (batch statistics when training, else running ones), FiLM in
every resnet block, and the null embedding substituted where keep_mask is
False.

`forward` takes and returns NHWC like the JAX module; inside, tensors are
NCHW in channels_last memory format.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import (
    Attention,
    Conv2d,
    Downsample,
    FusedLinearAttentionBlock,
    FusedResnetBlock,
    Linear,
    PreNormResidual,
    Upsample,
    flax_batch_norm,
    flax_init_,
    sinusoidal_pos_emb,
)


class Unet(nn.Module):
    def __init__(self, dim: int, embed_input_dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), in_channels: int = 3,
                 attn_heads: int = 4, attn_dim_head: int = 32,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        time_dim = cond_emb_dim = dim * 4
        cond_dim = time_dim + cond_emb_dim

        self.cond_dense_1 = Linear(embed_input_dim, dim)
        self.cond_bn_1 = nn.BatchNorm1d(dim, eps=1e-5)
        self.null_cond_emb = nn.Parameter(torch.empty(dim))
        self.cond_dense_2 = Linear(dim, cond_emb_dim)
        self.cond_bn_2 = nn.BatchNorm1d(cond_emb_dim, eps=1e-5)
        self.time_dense_1 = Linear(dim, time_dim)
        self.time_dense_2 = Linear(time_dim, time_dim)

        dims = [dim] + [dim * m for m in dim_mults]
        self.in_out = list(zip(dims[:-1], dims[1:]))
        attn = lambda d: FusedLinearAttentionBlock(d, attn_heads, attn_dim_head)
        self.init_conv = Conv2d(in_channels, dim, 7, padding=3)
        for ind, (dim_in, dim_out) in enumerate(self.in_out):
            self.add_module(f"down_{ind}_block1", FusedResnetBlock(dim_in, dim_in, cond_dim))
            self.add_module(f"down_{ind}_block2", FusedResnetBlock(dim_in, dim_in, cond_dim))
            self.add_module(f"down_{ind}_attn", attn(dim_in))
            if ind < len(self.in_out) - 1:
                self.add_module(f"down_{ind}_downsample", Downsample(dim_in, dim_out))
            else:
                self.add_module(f"down_{ind}_conv", Conv2d(dim_in, dim_out, 3, padding=1))
        mid_dim = dims[-1]
        self.mid_block1 = FusedResnetBlock(mid_dim, mid_dim, cond_dim)
        self.mid_attn = PreNormResidual(mid_dim, Attention(mid_dim, attn_heads, attn_dim_head))
        self.mid_block2 = FusedResnetBlock(mid_dim, mid_dim, cond_dim)
        for ind, (dim_in, dim_out) in enumerate(reversed(self.in_out)):
            self.add_module(f"up_{ind}_block1",
                            FusedResnetBlock(dim_out + dim_in, dim_out, cond_dim))
            self.add_module(f"up_{ind}_block2",
                            FusedResnetBlock(dim_out + dim_in, dim_out, cond_dim))
            self.add_module(f"up_{ind}_attn", attn(dim_out))
            if ind < len(self.in_out) - 1:
                self.add_module(f"up_{ind}_upsample", Upsample(dim_out, dim_in))
            else:
                self.add_module(f"up_{ind}_conv", Conv2d(dim_out, dim_in, 3, padding=1))
        self.final_res_block = FusedResnetBlock(dim * 2, dim, cond_dim)
        self.final_conv = Conv2d(dim, in_channels, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's initialisers; the attention kernels are in flax's layout."""
        flax_init_(self, gen, flax_layout=("qkv_kernel", "out_kernel"))

    def forward(self, x: torch.Tensor, t: torch.Tensor, labels_emb: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """x [B, H, W, Cin]; t [B] int; labels_emb [B, embed_input_dim];
        keep_mask [B] bool, False rows get the null condition (None keeps
        all); train: BatchNorm on batch statistics, updating the running
        ones (flax's train=True). Returns [B, H, W, Cout] f32."""
        dt = self.dtype
        c = F.relu(flax_batch_norm(self.cond_bn_1, self.cond_dense_1(labels_emb.float()), train))
        if keep_mask is not None:
            c = torch.where(keep_mask[:, None], c, self.null_cond_emb[None, :].to(c.dtype))
        c_emb = F.relu(flax_batch_norm(self.cond_bn_2, self.cond_dense_2(c), train))
        t_emb = self.time_dense_1(sinusoidal_pos_emb(t, self.dim))
        t_emb = self.time_dense_2(F.gelu(t_emb, approximate="tanh"))
        t_emb, c_emb = t_emb.to(dt), c_emb.to(dt)

        x = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.init_conv(x)
        r = x
        skips = []
        last = len(self.in_out) - 1
        for ind in range(len(self.in_out)):
            x = self.get_submodule(f"down_{ind}_block1")(x, t_emb, c_emb)
            skips.append(x)
            x = self.get_submodule(f"down_{ind}_block2")(x, t_emb, c_emb)
            x = self.get_submodule(f"down_{ind}_attn")(x)
            skips.append(x)
            tail = "conv" if ind == last else "downsample"
            x = self.get_submodule(f"down_{ind}_{tail}")(x)

        x = self.mid_block1(x, t_emb, c_emb)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t_emb, c_emb)

        for ind in range(len(self.in_out)):
            x = torch.cat([x, skips.pop()], dim=1)
            x = self.get_submodule(f"up_{ind}_block1")(x, t_emb, c_emb)
            x = torch.cat([x, skips.pop()], dim=1)
            x = self.get_submodule(f"up_{ind}_block2")(x, t_emb, c_emb)
            x = self.get_submodule(f"up_{ind}_attn")(x)
            tail = "conv" if ind == last else "upsample"
            x = self.get_submodule(f"up_{ind}_{tail}")(x)

        x = torch.cat([x, r], dim=1)
        x = self.final_res_block(x, t_emb, c_emb)
        out = self.final_conv(x.float())
        return out.permute(0, 2, 3, 1)

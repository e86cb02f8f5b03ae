"""SAGAN generator and discriminator (ccdm_tpu/models/sagan.py), NCHW.

Spectral norm on every conv and dense (the generator's included, unlike
SNGAN), ConditionalBatchNorm conditioning at momentum 0.999 (the last
BatchNorm of the generator 0.9999), and a self-attention block (1x1
theta, phi and g convs, phi and g 2x2 max-pooled, a learned gate sigma)
at the 16x16 map of G and after block1 of D. The spectral norm,
ConditionalBatchNorm and the initialisers are models/sngan.py's. The
attention tokens run in flax's NHWC row-major order (i * W + j), which is
what flattening an NCHW map's spatial axes gives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.resnet_embed import BatchNorm
from ccdm_tpu_torch.models.sngan import (
    ConditionalBatchNorm,
    SNLinear,
    _check_size,
    _SNConv,
    _xavier,
    avgpool2,
    disc_widths,
    reset_gan_parameters,
    upsample_nearest_2x,
)


class SNConv(_SNConv):
    """A spectral-normalised conv, xavier-uniform with gain 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__(in_channels, out_channels, kernel, gain=1.0)


class SNDense(nn.Module):
    """A spectral-normalised dense, xavier-uniform with gain 1."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.dense = _xavier(SNLinear(in_features, out_features, bias=use_bias), 1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.dense(x, update=train)


class SelfAttn(nn.Module):
    """SAGAN self-attention with max-pooled phi and g and a gate sigma
    (sagan.py:34-77)."""

    def __init__(self, ch: int):
        super().__init__()
        self.theta = SNConv(ch, ch // 8, 1)
        self.phi = SNConv(ch, ch // 8, 1)
        self.g = SNConv(ch, ch // 2, 1)
        self.attn_out = SNConv(ch // 2, ch, 1)
        self.sigma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, ch, h, w = x.shape
        theta = self.theta(x, train).flatten(2).transpose(1, 2)                   # [b, n, c/8]
        phi = F.max_pool2d(self.phi(x, train), 2).flatten(2).transpose(1, 2)      # [b, n/4, c/8]
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", theta, phi), dim=-1)
        g = F.max_pool2d(self.g(x, train), 2).flatten(2).transpose(1, 2)          # [b, n/4, c/2]
        attn_g = torch.einsum("bnm,bmc->bnc", attn, g).transpose(1, 2).reshape(b, ch // 2, h, w)
        return x + self.sigma * self.attn_out(attn_g, train)


class GenBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dim_embed: int = 128):
        super().__init__()
        self.cond_bn1 = ConditionalBatchNorm(in_channels, dim_embed, momentum=0.999)
        self.snconv1 = SNConv(in_channels, out_channels)
        self.cond_bn2 = ConditionalBatchNorm(out_channels, dim_embed, momentum=0.999)
        self.snconv2 = SNConv(out_channels, out_channels)
        self.snconv0 = SNConv(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool) -> torch.Tensor:
        h = upsample_nearest_2x(F.relu(self.cond_bn1(x, y, train)))
        h = F.relu(self.cond_bn2(self.snconv1(h, train), y, train))
        h = self.snconv2(h, train)
        return h + self.snconv0(upsample_nearest_2x(x), train)


class SAGANGenerator(nn.Module):
    def __init__(self, dim_z: int = 128, dim_embed: int = 128, nc: int = 3, img_size: int = 64,
                 gene_ch: int = 32, ch_multi: Sequence[int] = (16, 8, 4, 2, 1), seed: int = 0):
        super().__init__()
        self.init_size = _check_size(img_size)
        m = ch_multi
        self.c0, self.dim_z = gene_ch * m[0], dim_z
        self.snlinear0 = SNDense(dim_z, self.c0 * self.init_size ** 2)
        self.block1 = GenBlock(gene_ch * m[0], gene_ch * m[1], dim_embed)
        self.block2 = GenBlock(gene_ch * m[1], gene_ch * m[2], dim_embed)
        self.self_attn = SelfAttn(gene_ch * m[2])
        self.block3 = GenBlock(gene_ch * m[2], gene_ch * m[3], dim_embed)
        self.block4 = GenBlock(gene_ch * m[3], gene_ch * m[4], dim_embed)
        self.block5 = (GenBlock(gene_ch * m[4], gene_ch, dim_embed)
                       if img_size in (128, 192) else None)
        last = gene_ch if self.block5 is not None else gene_ch * m[4]
        self.bn = BatchNorm(last, momentum=0.9999)
        self.snconv_out = SNConv(last, nc)
        reset_gan_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, z: torch.Tensor, y: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.init_size
        h = self.snlinear0(z, train).view(-1, s, s, self.c0).permute(0, 3, 1, 2)
        h = self.block2(self.block1(h, y, train), y, train)
        h = self.self_attn(h, train)
        h = self.block4(self.block3(h, y, train), y, train)
        if self.block5 is not None:
            h = self.block5(h, y, train)
        h = F.relu(self.bn(h, train))
        return torch.tanh(self.snconv_out(h, train))


class DiscBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, downsample: bool = True,
                 first: bool = False):
        super().__init__()
        self.downsample, self.first = downsample, first
        self.snconv1 = SNConv(in_channels, out_channels)
        self.snconv2 = SNConv(out_channels, out_channels)
        self.snconv0 = (SNConv(in_channels, out_channels, 1)
                        if first or downsample or in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.first:
            h = self.snconv2(F.relu(self.snconv1(x, train)), train)
            return avgpool2(h) + self.snconv0(avgpool2(x), train)
        h = self.snconv2(F.relu(self.snconv1(F.relu(x), train)), train)
        if self.downsample:
            h = avgpool2(h)
        x0 = x
        if self.snconv0 is not None:
            x0 = self.snconv0(x0, train)
            if self.downsample:
                x0 = avgpool2(x0)
        return h + x0


class SAGANDiscriminator(nn.Module):
    def __init__(self, dim_embed: int = 128, nc: int = 3, img_size: int = 64, disc_ch: int = 32,
                 ch_multi: Optional[Sequence[int]] = None, seed: int = 0):
        super().__init__()
        init_size = _check_size(img_size)
        w = disc_widths(img_size, disc_ch, ch_multi)
        self.opt_block1 = DiscBlock(nc, w[0], first=True)
        self.block1 = DiscBlock(w[0], w[1])
        self.self_attn = SelfAttn(w[1])
        self.block2 = DiscBlock(w[1], w[2])
        self.block3 = DiscBlock(w[2], w[3])
        if img_size == 64:
            self.block4 = DiscBlock(w[3], w[4], downsample=False)
            self.block5 = None
        else:
            self.block4 = DiscBlock(w[3], w[4])
            self.block5 = DiscBlock(w[4], w[5], downsample=False)
        feat_dim = w[-1] * init_size ** 2
        self.snlinear1 = SNDense(feat_dim, 1)
        self.sn_embedding1 = SNDense(dim_embed, feat_dim, use_bias=False)
        reset_gan_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.block1(self.opt_block1(x, train), train)
        h = self.self_attn(h, train)
        h = self.block4(self.block3(self.block2(h, train), train), train)
        if self.block5 is not None:
            h = self.block5(h, train)
        phi = F.relu(h).reshape(h.shape[0], -1)
        out1 = self.snlinear1(phi, train)[:, 0]
        return out1 + torch.sum(phi * self.sn_embedding1(y, train), dim=1)

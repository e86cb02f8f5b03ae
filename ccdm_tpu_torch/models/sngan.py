"""SNGAN generator and discriminator with projection conditioning.

Counterpart of ccdm_tpu/models/sngan.py, with the flax modules' names, so
that utils/convert.gan_state_dict_from_jax maps their variables one to one.
Images are NCHW; the generator's dense output is laid out as flax's NHWC
reshape and permuted to NCHW.

- Generator: dense z -> init_size^2 map, 4 (5 at 128/192) upsampling
  resnet blocks with ConditionalBatchNorm (out + out * gamma(y) + beta(y)
  over a BatchNorm without affine), a final BatchNorm, ReLU, 3x3 conv,
  tanh.
- Discriminator: resnet blocks of spectral-normalised convs, average
  pooling, and the projection head sum(phi * W y) + linear(phi), phi the
  ReLU'd features flattened in NCHW order (the reference's layout).

The spectral norm is flax's (SpectralNorm._spectral_normalize), not
torch.nn.utils.spectral_norm's: the kernel in flax's layout (HWIO for a
conv, [in, out] for a dense) reshaped to [-1, out]; one power-iteration
step from the stored u [1, out] in every forward, eval included; the l2
normalisation x * rsqrt(sum(x^2) + 1e-12); sigma = v W u^T with u and v
detached, so that the gradient flows through sigma; u and sigma stored
only when the forward updates statistics (train). The norms are flax's
(models/resnet_embed.BatchNorm: the biased variance, eps 1e-5, flax's
momentum convention). Weights are drawn with the JAX modules'
initialisers (xavier-uniform with the reference's gains, lecun-normal for
the conditional gains, u ~ N(0, 1)) from a torch.Generator seeded with
`seed`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.resnet_embed import BatchNorm
from ccdm_tpu_torch.models.layers import lecun_normal_

SN_EPS = 1e-12
GAN_SIZES = (64, 128, 192)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral_sigma(w2d: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, the new u) of a kernel in flax's [K, out] layout after one
    power-iteration step from u [1, out]; the gradient flows to w2d
    through sigma only."""
    with torch.no_grad():
        w = w2d.detach()
        v = _l2_normalize(u @ w.T)
        u_new = _l2_normalize(v @ w)
    return (v @ w2d @ u_new.T)[0, 0], u_new


class _SpectralNormed:
    """The u [1, out] and sigma buffers of a spectral-normalised layer,
    and its normalised weight."""

    def _sn_buffers(self, out_features: int) -> None:
        self.register_buffer("u", torch.empty(1, out_features))
        self.register_buffer("sigma", torch.ones(()))

    def _normalized(self, w2d: torch.Tensor, update: bool) -> torch.Tensor:
        sigma, u_new = spectral_sigma(w2d, self.u)
        if update:
            with torch.no_grad():
                self.u.copy_(u_new)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv2d(nn.Conv2d, _SpectralNormed):
    """nn.Conv2d (OIHW) with flax's spectral norm of its HWIO kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_buffers(self.out_channels)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        hwio = self.weight.permute(2, 3, 1, 0)
        w = self._normalized(hwio.reshape(-1, self.out_channels), update)
        return self._conv_forward(x, w, self.bias)


class SNLinear(nn.Linear, _SpectralNormed):
    """nn.Linear ([out, in]) with flax's spectral norm of its [in, out]
    kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_buffers(self.out_features)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        return F.linear(x, self._normalized(self.weight.T, update), self.bias)


def _xavier(module: nn.Module, gain: float) -> nn.Module:
    """Mark a conv or dense for xavier-uniform with `gain` (flax
    variance_scaling(gain^2, fan_avg, uniform)) at reset_parameters."""
    module.xavier_gain = gain
    return module


@torch.no_grad()
def reset_gan_parameters(net: nn.Module, gen: torch.Generator) -> None:
    """The JAX modules' initialisers: a marked kernel xavier-uniform with
    its gain, another (the conditional gains) lecun-normal; biases zero;
    u ~ N(0, 1), sigma 1; norm scales 1 and running statistics 0 and 1;
    the self-attention gate 0."""
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
            gain = getattr(module, "xavier_gain", None)
            if gain is None:
                lecun_normal_(w, fan_in, gen)
            else:
                bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
                w.uniform_(-bound, bound, generator=gen)
            if module.bias is not None:
                module.bias.zero_()
            if isinstance(module, _SpectralNormed):
                module.u.copy_(torch.randn(module.u.shape, generator=gen))
                module.sigma.fill_(1.0)
        elif isinstance(module, BatchNorm):
            if module.weight is not None:
                module.weight.fill_(1.0)
                module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    for name, p in net.named_parameters():
        if name.endswith("attn.sigma"):  # SAGAN's SelfAttn gate
            p.zero_()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConditionalBatchNorm(nn.Module):
    """BatchNorm without affine, modulated by the label embedding: out +
    out * gamma(y) + beta(y) (sngan.py:19-35). Momentum 0.9 (torch's
    default 0.1) in SNGAN, 0.999 in SAGAN."""

    def __init__(self, features: int, dim_embed: int = 128, momentum: float = 0.9):
        super().__init__()
        self.bn = BatchNorm(features, momentum=momentum, affine=False)
        self.embed_gamma = nn.Linear(dim_embed, features, bias=False)
        self.embed_beta = nn.Linear(dim_embed, features, bias=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.bn(x, train)
        gamma = self.embed_gamma(y)[:, :, None, None]
        beta = self.embed_beta(y)[:, :, None, None]
        return out + out * gamma + beta


class GenResBlock(nn.Module):
    """Conditional upsampling generator block (sngan.py:38-84)."""

    def __init__(self, in_channels: int, out_channels: int, dim_embed: int = 128):
        super().__init__()
        self.condbn1 = ConditionalBatchNorm(in_channels, dim_embed)
        self.conv1 = _xavier(nn.Conv2d(in_channels, out_channels, 3, padding=1), 2 ** 0.5)
        self.condbn2 = ConditionalBatchNorm(out_channels, dim_embed)
        self.conv2 = _xavier(nn.Conv2d(out_channels, out_channels, 3, padding=1), 2 ** 0.5)
        self.bypass_conv = _xavier(nn.Conv2d(in_channels, out_channels, 1), 1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool) -> torch.Tensor:
        h = upsample_nearest_2x(F.relu(self.condbn1(x, y, train)))
        h = self.condbn2(self.conv1(h), y, train)
        h = self.conv2(F.relu(h))
        return h + self.bypass_conv(upsample_nearest_2x(x))


def _check_size(img_size: int) -> int:
    if img_size not in GAN_SIZES:
        raise ValueError(f"the GANs take image sizes {GAN_SIZES}, got {img_size}")
    return 6 if img_size == 192 else 4


class SNGANGenerator(nn.Module):
    def __init__(self, dim_z: int = 128, dim_embed: int = 128, nc: int = 3, img_size: int = 64,
                 gene_ch: int = 32, ch_multi: Sequence[int] = (16, 8, 4, 2, 1), seed: int = 0):
        super().__init__()
        self.init_size = _check_size(img_size)
        self.c0 = gene_ch * ch_multi[0]
        self.dim_z = dim_z
        self.dense = _xavier(nn.Linear(dim_z, self.init_size ** 2 * self.c0), 1.0)
        widths = [gene_ch * ch_multi[i + 1] for i in range(4)] + [gene_ch]
        n_blocks = 5 if img_size in (128, 192) else 4
        ins = [self.c0] + widths
        for i in range(n_blocks):
            self.add_module(f"genblock{i}", GenResBlock(ins[i], widths[i], dim_embed))
        self.n_blocks = n_blocks
        self.final_bn = BatchNorm(widths[n_blocks - 1], momentum=0.9)
        self.final_conv = _xavier(nn.Conv2d(widths[n_blocks - 1], nc, 3, padding=1), 1.0)
        reset_gan_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, z: torch.Tensor, y: torch.Tensor, train: bool = False) -> torch.Tensor:
        """z [B, dim_z], y [B, dim_embed] -> images [B, nc, H, W] in [-1, 1]."""
        s = self.init_size
        h = self.dense(z).view(-1, s, s, self.c0).permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            h = self.get_submodule(f"genblock{i}")(h, y, train)
        h = F.relu(self.final_bn(h, train))
        return torch.tanh(self.final_conv(h))


class _SNConv(nn.Module):
    """A spectral-normalised conv, its kernel xavier-uniform with `gain`."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 gain: float = 2 ** 0.5):
        super().__init__()
        self.conv = _xavier(SNConv2d(in_channels, out_channels, kernel,
                                     padding=(kernel - 1) // 2), gain)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.conv(x, update=train)


def avgpool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


class DiscResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 first: bool = False):
        super().__init__()
        self.stride, self.first = stride, first
        self.conv1 = _SNConv(in_channels, out_channels)
        self.conv2 = _SNConv(out_channels, out_channels)
        self.bypass_conv = _SNConv(in_channels, out_channels, 1, 1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.first:  # no ReLU on raw pixels (sngan.py:189-214)
            h = self.conv2(F.relu(self.conv1(x, train)), train)
            return avgpool2(h) + self.bypass_conv(avgpool2(x), train)
        h = self.conv2(F.relu(self.conv1(F.relu(x), train)), train)
        bypass = self.bypass_conv(x, train)
        if self.stride != 1:
            h, bypass = avgpool2(h), avgpool2(bypass)
        return h + bypass


def disc_widths(img_size: int, disc_ch: int, ch_multi: Optional[Sequence[int]]) -> list:
    m = ch_multi or ((1, 2, 4, 8, 16) if img_size == 64 else (1, 2, 2, 4, 8, 16))
    return [disc_ch * k for k in m]


class SNGANDiscriminator(nn.Module):
    def __init__(self, dim_embed: int = 128, nc: int = 3, img_size: int = 64, disc_ch: int = 32,
                 ch_multi: Optional[Sequence[int]] = None, seed: int = 0):
        super().__init__()
        init_size = _check_size(img_size)
        w = disc_widths(img_size, disc_ch, ch_multi)
        strides = [2, 2, 2, 2, 1] if img_size == 64 else [2, 2, 2, 2, 2, 1]
        ins = [nc] + w
        self.n_blocks = len(strides)
        for i, stride in enumerate(strides):
            self.add_module(f"block{i}", DiscResBlock(ins[i], w[i], stride, first=i == 0))
        feat_dim = w[self.n_blocks - 1] * init_size ** 2
        self.linear1 = _xavier(SNLinear(feat_dim, 1), 1.0)
        self.linear2 = _xavier(SNLinear(dim_embed, feat_dim, bias=False), 1.0)
        reset_gan_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False,
                return_features: bool = False):
        """x [B, nc, H, W], y [B, dim_embed] -> [B] (and phi [B, feat])."""
        h = x
        for i in range(self.n_blocks):
            h = self.get_submodule(f"block{i}")(h, train)
        phi = F.relu(h).reshape(h.shape[0], -1)  # NCHW order
        out = self.linear1(phi, update=train)[:, 0]
        out = out + torch.sum(phi * self.linear2(y, update=train), dim=1)
        return (out, phi) if return_features else out

"""The ILI embedding networks: a ResNet regressor x -> (y_hat, h) and the
label MLPs y -> h (ModelY2H) and y -> cov (ModelY2Cov).

Counterpart of ccdm_tpu/models/resnet_embed.py, with the flax modules'
names, so that utils/convert.state_dict_from_jax maps their variables one
to one. `forward` takes NHWC like the JAX module; inside, tensors are NCHW
in channels_last memory format. The norms follow flax, not torch:
- BatchNorm (momentum 0.9, eps 1e-5): in training the batch statistics,
  with the biased variance mean(x^2) - mean(x)^2, and the running ones
  moved 10% towards them (nn.BatchNorm2d would move running_var towards
  the unbiased variance); otherwise the running statistics;
- GroupNorm(8) of the label MLPs: eps 1e-6 (torch's default is 1e-5), the
  same fast variance.
The 1x1 stride-2 shortcut conv has flax's SAME padding, which pads nothing
for a 1x1 kernel. Weights are drawn with flax's initialisers (lecun_normal
kernels, zero biases, unit scales) from a torch.Generator seeded with
`seed`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import flax_init_
from ccdm_tpu_torch.parallel.mesh import global_moments

BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over every axis but dim 1 (the channels); without
    `affine`, flax's use_scale=False, use_bias=False. Under a data-parallel
    step (`sync_mesh`, set by parallel.sharded_apply) the statistics are the
    global batch's."""

    sync_mesh = None

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            mean, var = global_moments(x, [d for d in range(x.ndim) if d != 1],
                                       self.sync_mesh)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is None:
            return (x - mean.view(shape)) * mul.view(shape)
        mul = mul * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) of [B, C] features, eps 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape
        g = x.reshape(b, self.num_groups, c // self.num_groups)
        mean, var = global_moments(g, [2], None)
        g = (g - mean[:, :, None]) * torch.rsqrt(var + self.eps)[:, :, None]
        return g.reshape(b, c) * self.weight + self.bias


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = _conv(in_planes, planes, 1, stride)
            self.shortcut_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        if self.has_shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x), train)
        return F.relu(h + x)


class ResNetEmbed(nn.Module):
    """ResNet regressor x [B, H, W, C] -> (y_hat [B, label_dim], h [B,
    dim_embed]); (3, 4, 6, 3) blocks is ResNet34, (2, 2, 2, 2) ResNet18.
    Every stage's first block has stride 2."""

    def __init__(self, dim_embed: int = 128, label_dim: int = 1,
                 num_blocks: Sequence[int] = (3, 4, 6, 3), in_channels: int = 3,
                 seed: int = 0):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.stem_conv = _conv(in_channels, 64, 3)
        self.stem_bn = BatchNorm(64)
        in_planes = 64
        for stage, nb in enumerate(self.num_blocks):
            planes = 64 * 2 ** stage
            for b in range(nb):
                self.add_module(f"stage{stage}_block{b}",
                                BasicBlock(in_planes, planes, 2 if b == 0 else 1))
                in_planes = planes
        self.x2h_dense1 = nn.Linear(in_planes, 512)
        self.x2h_bn1 = BatchNorm(512)
        self.x2h_dense2 = nn.Linear(512, dim_embed)
        self.x2h_bn2 = BatchNorm(dim_embed)
        self.h2y = nn.Linear(dim_embed, label_dim)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = False):
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = F.relu(self.stem_bn(self.stem_conv(h), train))
        for stage, nb in enumerate(self.num_blocks):
            for b in range(nb):
                h = self.get_submodule(f"stage{stage}_block{b}")(h, train)
        h = h.mean((2, 3))
        h = F.relu(self.x2h_bn1(self.x2h_dense1(h), train))
        features = F.relu(self.x2h_bn2(self.x2h_dense2(h), train))
        return self.h2y_head(features), features

    def h2y_head(self, features: torch.Tensor) -> torch.Tensor:
        """The h2y head (Dense + ReLU) on any features."""
        return F.relu(self.h2y(features))


class _LabelMLP(nn.Module):
    """1 -> widths[0] -> ... -> out_dim: Dense, GroupNorm(8), ReLU per hidden
    layer, then Dense and ReLU; the input is y.reshape(-1, 1) + 1e-8."""

    def __init__(self, widths: Sequence[int], out_dim: int, num_groups: int, seed: int):
        super().__init__()
        fan_in = 1
        for i, width in enumerate(widths):
            self.add_module(f"dense{i}", nn.Linear(fan_in, width))
            self.add_module(f"gn{i}", GroupNorm(num_groups, width))
            fan_in = width
        self.depth = len(widths)
        self.dense_out = nn.Linear(fan_in, out_dim)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        h = y.reshape(-1, 1) + 1e-8
        for i in range(self.depth):
            h = self.get_submodule(f"dense{i}")(h)
            h = F.relu(self.get_submodule(f"gn{i}")(h))
        return F.relu(self.dense_out(h))


class ModelY2H(_LabelMLP):
    """y -> h: 1 -> dim -> dim -> dim -> dim -> dim."""

    def __init__(self, dim_embed: int = 128, num_groups: int = 8, seed: int = 0):
        super().__init__((dim_embed,) * 4, dim_embed, num_groups, seed)


class ModelY2Cov(_LabelMLP):
    """y -> cov: 1 -> 512 -> 1024 -> 2048 -> 4096 -> cov_dim."""

    def __init__(self, cov_dim: int, num_groups: int = 8, seed: int = 0):
        super().__init__((512, 1024, 2048, 4096), cov_dim, num_groups, seed)

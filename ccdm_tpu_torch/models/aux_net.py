"""The auxiliary label regressors of the elastic aux loss.

Counterpart of ccdm_tpu/models/aux_net.py, with the flax modules' names
(utils/convert.state_dict_from_jax maps their variables one to one):
- `VGGAux`: the VGG11/13/16/19 stacks of VGG_CFG (3x3 conv with bias,
  BatchNorm, ReLU; "M" a 2x2 max pool), flattened in NHWC order;
- `ResNetAux`: a 3x3 stem conv without bias, BatchNorm, ReLU, then
  models/resnet_embed.BasicBlock stages (ResNet18 (2, 2, 2, 2), ResNet34
  (3, 4, 6, 3); every stage's first block has stride 2), the spatial mean;
- both end in the head 512 -> 512 -> 1: Dense, BatchNorm, ReLU twice, then
  Dense and ReLU.
With `use_t_emb` (off by default, as in JAX) the sinusoidal embedding of t
(128 wide) goes through `t_proj` and is added after the first conv. The
aux nets' own BatchNorms take flax's default momentum 0.99 (the residual
blocks keep resnet_embed's 0.9), eps 1e-5. `forward` takes NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import flax_init_, sinusoidal_pos_emb
from ccdm_tpu_torch.models.resnet_embed import BasicBlock, BatchNorm

VGG_CFG = {
    "VGG11": [64, "M", 128, "M", 128, "M", 128, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 128, "M", 128, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 128, 128, "M", 128, 128, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 128, 128, 128, "M", 128, 128, 128, "M"],
}
AUX_BN_MOMENTUM = 0.99  # flax nn.BatchNorm's default
T_EMB_DIM = 128


class _RegressorHead(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 512)
        self.bn1 = BatchNorm(512, AUX_BN_MOMENTUM)
        self.fc2 = nn.Linear(512, 512)
        self.bn2 = BatchNorm(512, AUX_BN_MOMENTUM)
        self.fc3 = nn.Linear(512, 1)

    def forward(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.relu(self.bn1(self.fc1(h), train))
        h = F.relu(self.bn2(self.fc2(h), train))
        return F.relu(self.fc3(h))


class VGGAux(nn.Module):
    def __init__(self, vgg_name: str = "VGG19", use_t_emb: bool = False, in_channels: int = 3,
                 image_size: int = 64, seed: int = 0):
        super().__init__()
        self.cfg, self.use_t_emb = VGG_CFG[vgg_name], use_t_emb
        cin, ci, size = in_channels, 0, image_size
        for spec in self.cfg:
            if spec == "M":
                size //= 2
                continue
            self.add_module(f"conv{ci}", nn.Conv2d(cin, spec, 3, padding=1))
            self.add_module(f"bn{ci}", BatchNorm(spec, AUX_BN_MOMENTUM))
            if ci == 0 and use_t_emb:
                self.t_proj = nn.Linear(T_EMB_DIM, spec)
            cin, ci = spec, ci + 1
        self.head = _RegressorHead(cin * size * size)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        ci = 0
        for spec in self.cfg:
            if spec == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(self.get_submodule(f"bn{ci}")(self.get_submodule(f"conv{ci}")(h), train))
            if ci == 0 and self.use_t_emb and t is not None:
                h = h + self.t_proj(sinusoidal_pos_emb(t.to(h.device), T_EMB_DIM))[:, :, None, None]
            ci += 1
        return self.head(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1), train)


class ResNetAux(nn.Module):
    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3), use_t_emb: bool = False,
                 in_channels: int = 3, seed: int = 0):
        super().__init__()
        self.num_blocks, self.use_t_emb = tuple(num_blocks), use_t_emb
        self.stem_conv = nn.Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.stem_bn = BatchNorm(64, AUX_BN_MOMENTUM)
        if use_t_emb:
            self.t_proj = nn.Linear(T_EMB_DIM, 64)
        in_planes = 64
        for stage, nb in enumerate(self.num_blocks):
            planes = 64 * 2 ** stage
            for b in range(nb):
                self.add_module(f"stage{stage}_block{b}",
                                BasicBlock(in_planes, planes, 2 if b == 0 else 1))
                in_planes = planes
        self.head = _RegressorHead(in_planes)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = F.relu(self.stem_bn(self.stem_conv(h), train))
        if self.use_t_emb and t is not None:
            h = h + self.t_proj(sinusoidal_pos_emb(t.to(h.device), T_EMB_DIM))[:, :, None, None]
        for stage, nb in enumerate(self.num_blocks):
            for b in range(nb):
                h = self.get_submodule(f"stage{stage}_block{b}")(h, train)
        return self.head(h.mean((2, 3)), train)


def make_aux_net(name: str, use_t_emb: bool = False, in_channels: int = 3,
                 image_size: int = 64, seed: int = 0) -> nn.Module:
    """The aux regressor --net_aux `name`, weights drawn from `seed` with
    flax's initialisers (VGG's head width follows from `image_size`)."""
    if "VGG" in name:
        return VGGAux(name, use_t_emb, in_channels, image_size, seed)
    if name == "ResNet18":
        return ResNetAux((2, 2, 2, 2), use_t_emb, in_channels, seed)
    if name == "ResNet34":
        return ResNetAux((3, 4, 6, 3), use_t_emb, in_channels, seed)
    raise ValueError(f"unknown aux name {name}")

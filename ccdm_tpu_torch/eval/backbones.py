"""The eval backbones (counterpart of ccdm_tpu/eval/backbones.py):
- `AEEncoder`: eight convs (stride 2 and 1 in turn) to a 512-d bottleneck,
  the SFID feature extractor (vanilla models/autoencoder.py:6-51), and
  `AEDecoder` to pretrain it as an autoencoder (:55-98);
- `ResNetEval`: a ResNet34 trunk with a classification head (Diversity
  entropy, ResNet_class_eval.py:79-126) or a regression head (Label Score,
  ResNet_regre_eval.py:75-169);
- `NoisyClassifier`: a ResNet18 over noisy images with an additive
  sinusoidal timestep embedding after the stem (ADM-G's classifier).

`forward` takes NHWC like the flax modules; inside, tensors are NCHW in
channels_last memory format, the convs cuDNN's in f32. The names follow
the flax trees, so utils/convert maps their variables one to one. What
differs from a plain PyTorch translation, each for agreement with JAX:
- the BatchNorms are models/resnet_embed.BatchNorm (flax's: the biased
  batch variance); the stems' and the autoencoder's take flax's default
  momentum 0.99, the BasicBlocks inside the ResNets keep their 0.9;
- AEEncoder flattens [B, H/16, W/16, 8 ch] in NHWC order before its
  Dense, and AEDecoder reshapes its Dense output to NHWC;
- AEDecoder's ConvTranspose(4, stride 2, "SAME") is
  nn.ConvTranspose2d(stride 2, padding 1) holding flax's kernel flipped in
  both spatial axes (utils/convert does the flip);
- ResNetEval's regression head trains through leaky_relu(0.01)
  (`leaky_head`) and infers through relu.
Weights are drawn with flax's initialisers from a torch.Generator seeded
with `seed`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccdm_tpu_torch.models.layers import flax_init_, lecun_normal_, sinusoidal_pos_emb
from ccdm_tpu_torch.models.resnet_embed import BasicBlock, BatchNorm, _conv

FLAX_BN_MOMENTUM = 0.99


def _init_(module: nn.Module, seed: int) -> None:
    """flax's initialisers; a transposed conv's lecun_normal counts its
    fan-in over [in, kh, kw], which torch lays out as weight[:, 0]."""
    flax_init_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            w = m.weight
            lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], gen)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class AEEncoder(nn.Module):
    """x [B, S, S, C] -> features [B, dim_bottleneck]."""

    LAYERS = ((1, 2), (1, 1), (2, 2), (2, 1), (4, 2), (4, 1), (8, 2), (8, 1))  # (mult, stride)

    def __init__(self, dim_bottleneck: int = 512, ch: int = 64, in_channels: int = 3,
                 image_size: int = 64, seed: int = 0):
        super().__init__()
        cin = in_channels
        for i, (mult, stride) in enumerate(self.LAYERS):
            k = 4 if stride == 2 else 3
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch * mult, k, stride=stride, padding=1))
            self.add_module(f"bn{i}", BatchNorm(ch * mult, momentum=FLAX_BN_MOMENTUM))
            cin = ch * mult
        self.linear = nn.Linear(cin * (image_size // 16) ** 2, dim_bottleneck)
        _init_(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _nchw(x)
        for i in range(len(self.LAYERS)):
            h = F.relu(self.get_submodule(f"bn{i}")(self.get_submodule(f"conv{i}")(h), train))
        return self.linear(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))


class AEDecoder(nn.Module):
    """features [B, dim_bottleneck] -> x [B, 16 init_size, 16 init_size, nc]
    in [-1, 1]."""

    MULTS = (8, 4, 2, 1)

    def __init__(self, ch: int = 64, nc: int = 3, init_size: int = 4,
                 dim_bottleneck: int = 512, seed: int = 0):
        super().__init__()
        self.ch, self.init_size = ch, init_size
        self.linear = nn.Linear(dim_bottleneck, ch * 16 * init_size ** 2)
        cin = ch * 16
        for i, mult in enumerate(self.MULTS):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(cin, ch * mult, 4, stride=2,
                                                             padding=1))
            self.add_module(f"dbn{i}", BatchNorm(ch * mult, momentum=FLAX_BN_MOMENTUM))
            if mult > 1:
                self.add_module(f"conv{i}", nn.Conv2d(ch * mult, ch * mult, 3, padding=1))
                self.add_module(f"cbn{i}", BatchNorm(ch * mult, momentum=FLAX_BN_MOMENTUM))
            cin = ch * mult
        self.out_conv = nn.Conv2d(cin, nc, 3, padding=1)
        _init_(self, seed)

    def forward(self, f: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.init_size
        h = _nchw(self.linear(f).reshape(-1, s, s, self.ch * 16))
        for i, mult in enumerate(self.MULTS):
            h = F.relu(self.get_submodule(f"dbn{i}")(self.get_submodule(f"deconv{i}")(h), train))
            if mult > 1:
                h = F.relu(self.get_submodule(f"cbn{i}")(self.get_submodule(f"conv{i}")(h),
                                                         train))
        return torch.tanh(self.out_conv(h)).permute(0, 2, 3, 1)


class _ResNetTrunk(nn.Module):
    """stem conv (3x3, no bias) + BatchNorm(0.99) + ReLU, then the
    BasicBlocks, every stage's first with stride 2."""

    def __init__(self, num_blocks: Sequence[int], in_channels: int):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.stem_conv = _conv(in_channels, 64, 3)
        self.stem_bn = BatchNorm(64, momentum=FLAX_BN_MOMENTUM)
        in_planes = 64
        for stage, nb in enumerate(self.num_blocks):
            planes = 64 * 2 ** stage
            for b in range(nb):
                self.add_module(f"stage{stage}_block{b}",
                                BasicBlock(in_planes, planes, 2 if b == 0 else 1))
                in_planes = planes
        self.width = in_planes

    def stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.stem_bn(self.stem_conv(_nchw(x)), train))

    def blocks(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        for stage, nb in enumerate(self.num_blocks):
            for b in range(nb):
                h = self.get_submodule(f"stage{stage}_block{b}")(h, train)
        return h.mean((2, 3))


class ResNetEval(_ResNetTrunk):
    """mode "class": x -> (logits [B, num_outputs], features [B, 512]);
    mode "regre": x -> (relu(head) [B, 1] in [0, 1], features)."""

    def __init__(self, num_outputs: int, mode: str = "class",
                 num_blocks: Sequence[int] = (3, 4, 6, 3), in_channels: int = 3,
                 seed: int = 0):
        super().__init__(num_blocks, in_channels)
        if mode not in ("class", "regre"):
            raise ValueError(f"mode is class or regre, not {mode!r}")
        self.mode = mode
        self.head = nn.Linear(self.width, num_outputs)
        _init_(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False, leaky_head: bool = False):
        feat = self.blocks(self.stem(x, train), train)
        out = self.head(feat)
        if self.mode == "regre":
            # leaky_head: the training surrogate; with targets in [0, 1] its
            # fixed points are relu's, but a head driven negative keeps a
            # gradient instead of dying
            out = F.leaky_relu(out, 0.01) if leaky_head else F.relu(out)
        return out, feat


class NoisyClassifier(_ResNetTrunk):
    """(x_t, t) -> class logits [B, num_classes]: the trunk with
    Dense(64)(sinusoidal(t, 128)) added after the stem."""

    def __init__(self, num_classes: int, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 in_channels: int = 3, seed: int = 0):
        super().__init__(num_blocks, in_channels)
        self.t_proj = nn.Linear(128, 64)
        self.head = nn.Linear(self.width, num_classes)
        _init_(self, seed)

    def forward(self, x: torch.Tensor, t: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.stem(x, train)
        h = h + self.t_proj(sinusoidal_pos_emb(t, 128))[:, :, None, None]
        return self.head(self.blocks(h, train))

"""Image helpers and the per-dataset augmentation (ccdm_tpu/ops/image.py).

Layout: NHWC uint8 in, NHWC float out. The random augmentations take an
explicit torch.Generator, or their draws as tensors (so the tests can hand
in the JAX draws): a [B] bool flip mask, a [B] int rotation count.
"""

from __future__ import annotations

from typing import Optional

import torch


def normalize_images(images: torch.Tensor, to_neg_one_to_one: bool = False) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (or [-1, 1])."""
    out = images.float() / 255.0
    return out * 2.0 - 1.0 if to_neg_one_to_one else out


def normalize_to_neg_one_to_one(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 - 1.0


def unnormalize_to_zero_to_one(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) * 0.5


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """Clip [0,1] floats, scale by 255 and truncate to uint8."""
    return (x01.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def _draw_flags(images, gen, flags, p=0.5):
    if flags is None:
        flags = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    return flags.to(images.device).view(-1, 1, 1, 1)


def random_hflip(images: torch.Tensor, gen: Optional[torch.Generator] = None,
                 flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample horizontal flip (the W axis) where `flip` [B] is True."""
    return torch.where(_draw_flags(images, gen, flip), images.flip(2), images)


def random_vflip(images: torch.Tensor, gen: Optional[torch.Generator] = None,
                 flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample vertical flip (the H axis) where `flip` [B] is True."""
    return torch.where(_draw_flags(images, gen, flip), images.flip(1), images)


def random_rot90(images: torch.Tensor, gen: Optional[torch.Generator] = None,
                 k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample rotation by k * 90 degrees, k [B] in {0, 1, 2, 3} (H == W),
    with JAX's orientation (ccdm_tpu/ops/image.py:55-68)."""
    if k is None:
        k = torch.randint(0, 4, (images.shape[0],), generator=gen, device=images.device)
    k = k.to(images.device).view(-1, 1, 1, 1)
    r1 = images.transpose(1, 2).flip(1)
    r2 = images.flip(1).flip(2)
    r3 = images.transpose(1, 2).flip(2)
    return torch.where(k == 0, images, torch.where(k == 1, r1, torch.where(k == 2, r2, r3)))


def augment_for_dataset(data_name: str, images: torch.Tensor,
                        gen: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None) -> torch.Tensor:
    """UTKFace: hflip; Cell200: rot90, hflip, vflip; others: none
    (ccdm_tpu/ops/image.py:71-79). `draws` may hold "hflip", "vflip" and
    "rot90" tensors in place of the generator's."""
    draws = draws or {}
    if data_name == "UTKFace":
        return random_hflip(images, gen, draws.get("hflip"))
    if data_name == "Cell200":
        images = random_rot90(images, gen, draws.get("rot90"))
        images = random_hflip(images, gen, draws.get("hflip"))
        return random_vflip(images, gen, draws.get("vflip"))
    return images

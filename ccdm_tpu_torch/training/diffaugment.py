"""DiffAugment: differentiable GAN augmentation (ccdm_tpu/training/diffaugment.py).

On NCHW images in [-1, 1]:
- color: brightness (+U[-0.5, 0.5]), saturation (centred on the channel
  mean, times U[0, 2]), contrast (centred on the image mean, times
  U[0.5, 1.5]);
- translation: a shift by U{-r, r} pixels on each axis, r = int(size / 8
  + 0.5), zero-padded;
- cutout: a zeroed square of half the size at a uniform centre.

Every op is differentiable with respect to x (the shifts and masks are
constants of the draw). The draws come from an explicit torch.Generator,
or as tensors in `draws` (so that the tests can hand in JAX's):
"brightness", "saturation", "contrast" [B] uniform in [0, 1); "tx", "ty"
[B] integer shifts of rows and columns; "cy", "cx" [B] integer centres.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DEFAULT_POLICY = "color,translation,cutout"


def _draw(draws: dict, name: str, make) -> torch.Tensor:
    value = draws.get(name)
    return make() if value is None else value


def _uniform(x: torch.Tensor, gen, draws: dict, name: str) -> torch.Tensor:
    u = _draw(draws, name, lambda: torch.rand(x.shape[0], generator=gen, device=x.device))
    return u.to(x.device, torch.float32).view(-1, 1, 1, 1)


def _randint(x: torch.Tensor, gen, draws: dict, name: str, lo: int, hi: int) -> torch.Tensor:
    """[B] integers in [lo, hi)."""
    v = _draw(draws, name, lambda: torch.randint(lo, hi, (x.shape[0],), generator=gen,
                                                 device=x.device))
    return v.to(x.device, torch.long)


def rand_color(x: torch.Tensor, gen=None, draws: Optional[dict] = None) -> torch.Tensor:
    """Brightness, then saturation, then contrast."""
    draws = draws or {}
    x = x + (_uniform(x, gen, draws, "brightness") - 0.5)
    mean = x.mean(dim=1, keepdim=True)
    x = (x - mean) * (_uniform(x, gen, draws, "saturation") * 2.0) + mean
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_uniform(x, gen, draws, "contrast") + 0.5) + mean


def rand_translation(x: torch.Tensor, gen=None, draws: Optional[dict] = None,
                     ratio: float = 0.125) -> torch.Tensor:
    """out[b, :, i, j] = x[b, :, i + tx[b], j + ty[b]], zero outside."""
    draws = draws or {}
    b, c, h, w = x.shape
    sh, sw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    tx = _randint(x, gen, draws, "tx", -sh, sh + 1)
    ty = _randint(x, gen, draws, "ty", -sw, sw + 1)
    padded = F.pad(x, (sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None, :] + sh + tx[:, None]  # [B, H]
    cols = torch.arange(w, device=x.device)[None, :] + sw + ty[:, None]  # [B, W]
    out = torch.gather(padded, 2, rows[:, None, :, None].expand(b, c, h, w + 2 * sw))
    return torch.gather(out, 3, cols[:, None, None, :].expand(b, c, h, w))


def rand_cutout(x: torch.Tensor, gen=None, draws: Optional[dict] = None,
                ratio: float = 0.5) -> torch.Tensor:
    """Zero the pixels with |i - cy| < ch // 2 and |j - cx| < cw // 2."""
    draws = draws or {}
    _, _, h, w = x.shape
    ch, cw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    cy = _randint(x, gen, draws, "cy", 0, h + (1 - ch % 2)).view(-1, 1, 1)
    cx = _randint(x, gen, draws, "cx", 0, w + (1 - cw % 2)).view(-1, 1, 1)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    mask = ((ys - cy).abs() >= ch // 2) | ((xs - cx).abs() >= cw // 2)  # [B, H, W]
    return x * mask[:, None].to(x.dtype)


_POLICIES = {"color": rand_color, "translation": rand_translation, "cutout": rand_cutout}


def diff_augment(x: torch.Tensor, policy: str = DEFAULT_POLICY,
                 gen: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> torch.Tensor:
    """The comma-separated policy, in its order (the reference's default
    'color,translation,cutout', DiffAugment_pytorch.py:9-28)."""
    for name in (p.strip() for p in (policy or "").split(",")):
        if name:
            x = _POLICIES[name](x, gen, draws)
    return x

"""Gaussian diffusion: the guided DDIM sampler.

Counterpart of ccdm_tpu/diffusion/gaussian.py for sampling: DiffusionConfig,
`model_predictions` (the cond and null passes batched as one 2B forward,
cond rows first, then `apply_cfg`) and `ddim_sample` (gaussian.py:384-448).
The JAX sampler is one lax.scan; here it is a Python loop over the same
(t, t_next) pairs. The training loss, the ancestral sampler
(`--sampler ddpm`), CFG++ and the H(y) covariance come in later slices
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ccdm_tpu_torch.ops.guidance import apply_cfg
from ccdm_tpu_torch.ops.image import unnormalize_to_zero_to_one
from ccdm_tpu_torch.ops.schedule import (
    make_schedule,
    predict_noise_from_start,
    predict_start_from_noise,
    predict_start_from_v,
)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    image_size: int
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    objective: str = "pred_noise"
    beta_schedule: str = "cosine"
    ddim_sampling_eta: float = 0.0

    @property
    def effective_sampling_timesteps(self) -> int:
        return self.sampling_timesteps or self.timesteps


def ddim_time_pairs(timesteps: int, sampling_timesteps: int) -> list[tuple[int, int]]:
    """(t, t_next) from np.linspace(-1, T-1, S+1) truncated, in descending
    order; t_next is -1 on the last step."""
    times = np.linspace(-1, timesteps - 1, sampling_timesteps + 1).astype(np.int64)
    times = list(reversed(times.tolist()))
    return list(zip(times[:-1], times[1:]))


class GaussianDiffusion:
    """Holds the config, the schedule buffers on `device`, and the denoiser
    (an nn.Module with the Unet's forward(x, t, labels_emb, keep_mask))."""

    def __init__(self, model: nn.Module, config: DiffusionConfig, device="cpu"):
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.schedule = make_schedule(config.timesteps, config.beta_schedule,
                                      config.objective, device=self.device)

    def model_predictions(self, x: torch.Tensor, t: torch.Tensor, labels_emb: torch.Tensor,
                          cond_scale: float = 6.0, rescaled_phi: float = 0.7,
                          clip_x_start: bool = False):
        """(pred_noise, x_start) with classifier-free guidance."""
        c = self.config
        sched = self.schedule
        b = x.shape[0]
        if float(cond_scale) == 1.0:
            keep = torch.ones(b, dtype=torch.bool, device=x.device)
            guided = self.model(x, t, labels_emb, keep)
        else:
            keep2 = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                               torch.zeros(b, dtype=torch.bool, device=x.device)])
            out2 = self.model(torch.cat([x, x]), torch.cat([t, t]),
                              torch.cat([labels_emb, labels_emb]), keep2)
            guided, _ = apply_cfg(out2[:b], out2[b:], cond_scale, rescaled_phi)

        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
        if c.objective == "pred_noise":
            pred_noise = guided
            x_start = clip(predict_start_from_noise(sched, x, t, guided))
        else:
            x_start = clip(guided if c.objective == "pred_x0"
                           else predict_start_from_v(sched, x, t, guided))
            pred_noise = predict_noise_from_start(sched, x, t, x_start)
        return pred_noise, x_start

    @torch.no_grad()
    def ddim_sample(self, labels_emb: torch.Tensor, cond_scale: float = 6.0,
                    rescaled_phi: float = 0.7, clip_denoised: bool = True,
                    sampling_timesteps: Optional[int] = None,
                    ddim_eta: Optional[float] = None,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM from `noise` (or a draw from `generator`) to images in [0, 1],
        NHWC f32. `generator` also draws the per-step noise when eta > 0."""
        c = self.config
        b = labels_emb.shape[0]
        shape = (b, c.image_size, c.image_size, c.channels)
        steps = sampling_timesteps or c.effective_sampling_timesteps
        eta = c.ddim_sampling_eta if ddim_eta is None else ddim_eta
        ac = self.schedule.alphas_cumprod

        if noise is None:
            noise = torch.randn(shape, generator=generator, device=self.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must have shape {shape}, got {tuple(noise.shape)}")
        img = noise.to(self.device, torch.float32)
        for time, time_next in ddim_time_pairs(c.timesteps, steps):
            t_cond = torch.full((b,), time, dtype=torch.long, device=self.device)
            pred_noise, x_start = self.model_predictions(
                img, t_cond, labels_emb, cond_scale, rescaled_phi, clip_x_start=clip_denoised)
            if time_next < 0:
                img = x_start
                continue
            alpha, alpha_next = ac[time], ac[time_next]
            if eta == 0.0:
                coef = torch.sqrt(torch.clamp(1 - alpha_next, min=0.0))
                img = x_start * torch.sqrt(alpha_next) + coef * pred_noise
            else:
                sigma = eta * torch.sqrt(torch.clamp(
                    (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), min=0.0))
                coef = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
                step_noise = torch.randn(shape, generator=generator, device=self.device)
                img = x_start * torch.sqrt(alpha_next) + coef * pred_noise + sigma * step_noise
        return unnormalize_to_zero_to_one(img)

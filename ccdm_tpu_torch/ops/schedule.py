"""Diffusion noise schedules and the closed-form conversions of sampling.

Counterpart of ccdm_tpu/ops/schedule.py:26-185, with q_sample (and its
offset noise) and predict_v for the training loss and q_posterior for the
ancestral sampler. The betas and every buffer are computed on the host in
float64 with numpy and stored as float32 tensors, so they equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


def linear_betas(timesteps: int) -> np.ndarray:
    """Linear schedule scaled so that T=1000 spans [1e-4, 2e-2] (f64)."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule of Nichol & Dhariwal (f64)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1.0 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0.0, 0.999)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """f32 schedule buffers, each of shape [T], on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    loss_weight: torch.Tensor
    num_timesteps: int
    objective: str


def make_schedule(timesteps: int = 1000, beta_schedule: str = "cosine",
                  objective: str = "pred_noise", min_snr_loss_weight: bool = False,
                  min_snr_gamma: float = 5.0, device="cpu") -> Schedule:
    """All DDPM buffers in f64, stored as f32 tensors on `device`."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective}")
    if beta_schedule == "linear":
        betas = linear_betas(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_betas(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")

    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    snr = ac / (1.0 - ac)
    clipped_snr = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight else snr
    if objective == "pred_noise":
        loss_weight = clipped_snr / snr
    elif objective == "pred_x0":
        loss_weight = clipped_snr
    else:
        loss_weight = clipped_snr / (snr + 1.0)

    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
        snr=f32(snr),
        loss_weight=f32(loss_weight),
        num_timesteps=int(timesteps),
        objective=objective,
    )


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """buf[t] shaped to broadcast against an ndim-rank tensor."""
    out = buf[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def predict_start_from_noise(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                             noise: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def predict_noise_from_start(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                             x0: torch.Tensor) -> torch.Tensor:
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def predict_start_from_v(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)


def q_sample(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             offset_noise_strength: float = 0.0,
             offset_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(ac_t) x_0 + sqrt(1 - ac_t) eps (NHWC),
    with the offset noise [B, C] of ccdm_tpu/ops/schedule.py:134-147 added
    to eps over every pixel when its strength is positive."""
    if offset_noise_strength > 0.0 and offset_noise is not None:
        noise = noise + offset_noise_strength * offset_noise[:, None, None, :]
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def predict_v(sched: Schedule, x_start: torch.Tensor, t: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start)


def q_posterior(sched: Schedule, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
    """(mean, variance, clipped log-variance) of q(x_{t-1} | x_t, x_0)
    (ccdm_tpu/ops/schedule.py:177-185)."""
    mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    return (mean, extract(sched.posterior_variance, t, x_t.ndim),
            extract(sched.posterior_log_variance_clipped, t, x_t.ndim))

"""Respaced diffusion schedules (ccdm_tpu/diffusion/respace.py).

ADM-G's SpacedDiffusion respacing: a subset of the base timesteps, the
betas rebuilt so that the subset is a valid chain (beta'_i = 1 -
ac[s_i] / ac[s_{i-1}]), and a timestep_map so that the model is always
called with the ORIGINAL timestep indices. The buffers are computed in f64
with numpy and stored as f32 tensors, as make_schedule does, so they equal
the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ccdm_tpu_torch.ops.schedule import Schedule, make_schedule


def space_timesteps(num_timesteps: int, section_counts) -> list:
    """ADM-G's section-based spacing: "ddimN" for DDIM striding, or per-section
    counts (a list, or a comma-separated string)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with striding")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return sorted(set(all_steps))


def make_respaced_schedule(timesteps: int, beta_schedule: str, objective: str,
                           use_timesteps: Iterable[int], device="cpu",
                           **schedule_kwargs) -> Tuple[Schedule, np.ndarray]:
    """(the respaced Schedule over len(use_timesteps) steps, timestep_map
    int32). The Schedule's buffers index by the NEW timestep;
    timestep_map[new] is the ORIGINAL index to give the model."""
    base = make_schedule(timesteps, beta_schedule, objective, **schedule_kwargs)
    ac = base.alphas_cumprod.numpy().astype(np.float64)
    use = sorted(set(int(t) for t in use_timesteps))
    last = 1.0
    new_betas = []
    for t in use:
        new_betas.append(1.0 - ac[t] / last)
        last = ac[t]
    new_betas = np.asarray(new_betas)

    alphas = 1.0 - new_betas
    ac_new = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac_new[:-1]])
    post_var = new_betas * (1.0 - ac_prev) / (1.0 - ac_new)
    snr = ac_new / (1.0 - ac_new)
    if objective == "pred_noise":
        lw = np.ones_like(snr)
    elif objective == "pred_x0":
        lw = snr
    else:
        lw = snr / (snr + 1.0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    sched = Schedule(
        betas=f32(new_betas),
        alphas_cumprod=f32(ac_new),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac_new)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - ac_new)),
        log_one_minus_alphas_cumprod=f32(np.log(1 - ac_new)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / ac_new)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / ac_new - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
        posterior_mean_coef1=f32(new_betas * np.sqrt(ac_prev) / (1 - ac_new)),
        posterior_mean_coef2=f32((1 - ac_prev) * np.sqrt(alphas) / (1 - ac_new)),
        snr=f32(snr),
        loss_weight=f32(lw),
        num_timesteps=len(use),
        objective=objective,
    )
    return sched, np.asarray(use, np.int32)

"""Classifier-guided sampling and the class-conditional helpers
(ccdm_tpu/diffusion/guided.py).

- ADM-G: ancestral sampling whose posterior mean is shifted by
  guidance_scale * variance * grad_x log p(y | x_t), the gradient taken
  by autograd through the classifier in eval mode.
- CFG on classes: `make_fn_class_embed` maps integer classes to the rows
  of a fixed N(0, 1) table, so that the diffusion's CFG machinery runs
  unchanged. JAX draws that table from PRNGKey(seed) at every start; the
  port carries it as data: `class_table` reads it from a folder, or draws
  it from a torch.Generator seeded with `seed` and writes it there, and
  utils/convert.save_class_table_from_jax writes JAX's draw in its place.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccdm_tpu_torch.ops.image import unnormalize_to_zero_to_one
from ccdm_tpu_torch.ops.schedule import q_posterior

CLASS_EMBED_DIM = 128


def class_table_path(folder: str, num_classes: int, dim: int, seed: int) -> str:
    return os.path.join(folder, f"class_table_c{num_classes}_d{dim}_seed{seed}.pt")


def save_class_table(path: str, table: torch.Tensor) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"table": torch.as_tensor(table).detach().cpu().float()}, tmp)
    os.replace(tmp, path)


def class_table(folder: str, num_classes: int, dim: int = CLASS_EMBED_DIM,
                seed: int = 7) -> torch.Tensor:
    """The [num_classes, dim] table: the file under `folder` if there is
    one, else N(0, 1) from a torch.Generator seeded with `seed`, written
    there."""
    path = class_table_path(folder, num_classes, dim, seed)
    if os.path.isfile(path):
        table = torch.load(path, map_location="cpu", weights_only=True)["table"]
        if tuple(table.shape) != (num_classes, dim):
            raise ValueError(f"{path} holds a table of shape {tuple(table.shape)}, "
                             f"expected {(num_classes, dim)}")
        return table
    table = torch.randn(num_classes, dim, generator=torch.Generator().manual_seed(seed))
    save_class_table(path, table)
    return table


def make_fn_class_embed(table, device="cpu") -> Callable:
    """Integer classes [B] -> the table's rows [B, dim] on `device`."""
    table = torch.as_tensor(table, dtype=torch.float32).to(device)

    def fn(classes: torch.Tensor) -> torch.Tensor:
        return table[torch.as_tensor(classes, device=device).long().reshape(-1)]

    return fn


def classifier_grad_fn(classifier: torch.nn.Module, takes_t: bool = False) -> Callable:
    """cond_fn(x_t, t, y) -> grad_x of sum_i log softmax(classifier(x_t[,
    t]))[i, y_i], the classifier in eval mode (train=False); an output
    (logits, ...) takes its first entry. takes_t for the NoisyClassifier,
    without for the clean-image ResNetEval."""

    def cond_fn(x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            out = classifier(xi, t, train=False) if takes_t else classifier(xi, train=False)
            logits = out[0] if isinstance(out, tuple) else out
            lsm = F.log_softmax(logits, dim=-1)
            picked = torch.gather(lsm, 1, y.to(lsm.device).long()[:, None]).sum()
            return torch.autograd.grad(picked, xi)[0]

    return cond_fn


@torch.no_grad()
def classifier_guided_sample(diffusion, labels_emb: torch.Tensor, classes: torch.Tensor,
                             cond_fn: Callable, guidance_scale: float = 1.0,
                             sampling_timesteps: Optional[int] = None,
                             clip_denoised: bool = True,
                             noise: Optional[torch.Tensor] = None,
                             step_noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Ancestral sampling with classifier guidance (ADM-G's condition_mean):
    t = S-1, ..., 0 against the full schedule (S < T is not a respaced
    chain, as in the JAX package), the model's x_0 at cond_scale 1 clipped,
    mean' = mean + s * posterior_variance * cond_fn(x_t, t, classes), plus
    exp(log_var / 2) * step_noise[i] except at t = 0. The initial noise
    and step_noise [S, B, H, W, C] are drawn from `generator` where not
    given. Returns [0, 1], NHWC f32."""
    c = diffusion.config
    sched = diffusion.schedule
    b = labels_emb.shape[0]
    shape = (b, c.image_size, c.image_size, c.channels)
    steps = sampling_timesteps or c.effective_sampling_timesteps
    if step_noise is not None:
        step_noise = diffusion._draw((steps, *shape), step_noise, None, "step_noise")
    img = diffusion._draw(shape, noise, generator, "noise")
    classes = torch.as_tensor(classes, device=diffusion.device)
    for i, time in enumerate(range(steps - 1, -1, -1)):
        t_cond = torch.full((b,), time, dtype=torch.long, device=diffusion.device)
        _, x_start = diffusion.model_predictions(img, t_cond, labels_emb, cond_scale=1.0)
        if clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        mean, var, log_var = q_posterior(sched, x_start, img, t_cond)
        mean = mean + guidance_scale * var * cond_fn(img, t_cond, classes)
        if time == 0:
            img = mean
            continue
        z = step_noise[i] if step_noise is not None else torch.randn(
            shape, generator=generator, device=diffusion.device)
        img = mean + torch.exp(0.5 * log_var) * z
    return unnormalize_to_zero_to_one(img)


def bin_labels(labels_raw, num_classes: int, label_min: float, label_max: float) -> np.ndarray:
    """Continuous labels -> integer bins of equal width over [label_min,
    label_max] (e.g. RC-49 yaw -> 49 classes)."""
    lab = np.asarray(labels_raw, float)
    edges = np.linspace(label_min, label_max, num_classes + 1)
    return np.clip(np.digitize(lab, edges[1:-1]), 0, num_classes - 1)

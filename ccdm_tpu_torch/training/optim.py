"""Optimizer plumbing shared by the ILI embedding's training
(embedding/ili.py) and the aux regressor's (training/train_aux.py):
optax's piecewise-constant lr schedule in its f32 arithmetic, the lr set
on a torch optimizer before each step, the per-step generator and the
device sync that closes an epoch's timing."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ccdm_tpu_torch.training.trainer import chunk_seed


def lr_schedule(lr_base: float, decay_epochs, steps_per_epoch: int,
                factor: float = 0.1) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule(lr_base, {int(e * steps_per_epoch):
    factor}) in its f32 arithmetic: the lr of the update that follows
    `count` updates."""
    boundaries = {int(e * steps_per_epoch): factor for e in decay_epochs}

    def schedule(count: int) -> float:
        v = np.float32(lr_base)
        for threshold, scale in boundaries.items():
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s draws, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(chunk_seed(seed, step))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

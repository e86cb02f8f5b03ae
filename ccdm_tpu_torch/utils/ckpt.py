"""Milestone checkpoints with the reference's resume semantics.

Counterpart of ccdm_tpu/utils/ckpt.py. A milestone lives at
<results_folder>/model-<milestone>/ (a directory, as the JAX package's orbax
milestones do) and holds one file, state.pt, written with torch.save: the
tree of the JAX milestone, {step, params, batch_stats, opt_state {mu, nu,
count}, ema_step, ema_params, ema_batch_stats}, with tensors on the CPU.
It is written to a temporary name and moved into place, so a milestone is
either whole or absent. A JAX (orbax) milestone is carried across offline
by scripts/jax_milestone_to_torch.py.
"""

from __future__ import annotations

import os
from typing import Any

import torch

STATE_FILE = "state.pt"


def milestone_path(results_folder: str, milestone) -> str:
    return os.path.abspath(os.path.join(results_folder, f"model-{milestone}"))


def checkpoint_exists(results_folder: str, milestone) -> bool:
    return os.path.isfile(os.path.join(milestone_path(results_folder, milestone), STATE_FILE))


def save_checkpoint(results_folder: str, milestone, tree: dict) -> str:
    path = milestone_path(results_folder, milestone)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{STATE_FILE}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(results_folder: str, milestone) -> Any:
    path = os.path.join(milestone_path(results_folder, milestone), STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"milestone {milestone} not found: no {path}")
    return torch.load(path, map_location="cpu", weights_only=True)

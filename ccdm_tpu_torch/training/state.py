"""The train state: online weights, Adam, and the EMA shadow.

Counterpart of ccdm_tpu/training/state.py. The EMA follows the lucidrains
ema_pytorch semantics as the JAX package does: a per-call counter, an
`update_every` stride, copy-through until `update_after_step`, then
ema = d ema + (1 - d) online with d = clamp(1 - (1 + epoch/inv_gamma)^-power,
min_value, beta), epoch = ema_step - update_after_step - 1. The BatchNorm
running statistics are shadowed beside the parameters.

`clip_by_global_norm` and `adam_update` are optax's formulas written out
(optax.clip_by_global_norm scales by max_norm / norm only when norm >
max_norm; optax.adam with eps 1e-8, eps_root 0 and f32 moments, and
optax.adamw's decoupled decay), in place on lists of tensors with torch's
foreach ops.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


def ema_decay_value(step: int, cfg: EmaConfig) -> torch.Tensor:
    """The decay of ema.update() call number `step`, in f32 as JAX
    computes it (state.py:58-63)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    epoch = torch.clamp(f32(step) - f32(cfg.update_after_step) - f32(1.0), min=0.0)
    value = f32(1.0) - (f32(1.0) + epoch / f32(cfg.inv_gamma)) ** (-f32(cfg.power))
    value = torch.clamp(value, f32(cfg.min_value), f32(cfg.beta))
    return torch.where(epoch <= 0.0, f32(0.0), value)


def shadowed_tensors(model: nn.Module) -> list[torch.Tensor]:
    """What the EMA shadows, in a fixed order: every parameter, then every
    floating-point buffer (the BatchNorm running statistics)."""
    return ([p.data for p in model.parameters()]
            + [b for b in model.buffers() if b.is_floating_point()])


@dataclasses.dataclass
class TrainState:
    """step: completed optimizer steps; model: the online parameters and
    BatchNorm statistics; mu, nu, count: Adam's moments (one per
    parameter, in model.parameters() order) and its step count; ema_step:
    ema.update() calls so far; ema_model: the EMA shadow, a copy of model."""

    step: int
    model: nn.Module
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int
    ema_step: int
    ema_model: nn.Module


def create_train_state(model: nn.Module) -> TrainState:
    params = [p.data for p in model.parameters()]
    ema_model = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, model=model, mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params], count=0, ema_step=0,
                      ema_model=ema_model)


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max_norm where norm > max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if bool(norm < max_norm):
        return grads
    return [g / norm * max_norm for g in grads]


@torch.no_grad()
def adam_update(state, grads: list[torch.Tensor], lr: float,
                b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                weight_decay: float = 0.0, params: list[torch.Tensor] | None = None) -> None:
    """One optax.adam step (optax.adamw with weight_decay > 0) in place on
    `params` (default: state.model's), with the moments state.mu, state.nu
    and the count state.count (a TrainState or an AdamState):
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu;
    p += -lr ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)."""
    if params is None:
        params = [p.data for p in state.model.parameters()]
    state.count += 1
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    bc1 = float(f32(1.0) - f32(b1) ** state.count)
    bc2 = float(f32(1.0) - f32(b2) ** state.count)
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(state.nu, bc2)), eps)
    step = torch._foreach_div(torch._foreach_div(state.mu, bc1), denom)
    if weight_decay:  # optax.add_decayed_weights, on every leaf (its default mask)
        step = torch._foreach_add(step, torch._foreach_mul(params, weight_decay))
    torch._foreach_add_(params, torch._foreach_mul(step, -lr))


@dataclasses.dataclass
class AdamState:
    """Adam's moments (one per parameter of the list it steps) and count."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


def adam_init(params: list[torch.Tensor]) -> AdamState:
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def ema_update(state: TrainState, cfg: EmaConfig) -> None:
    """One ema.update() call (state.py:66-87), in place."""
    step = state.ema_step
    state.ema_step = step + 1
    if step % cfg.update_every != 0:
        return
    ema, online = shadowed_tensors(state.ema_model), shadowed_tensors(state.model)
    if step <= cfg.update_after_step:
        torch._foreach_copy_(ema, online)
        return
    decay = ema_decay_value(step, cfg)
    for e, o in zip(ema, online):
        d = decay.to(e.device)
        e.mul_(d).add_(o * (1.0 - d))


@torch.no_grad()
def precast_sampling_params(model: nn.Module) -> nn.Module:
    """`--samp_precast_bf16`: cast the f32 weight tensors (ndim >= 2) of
    `model` to bf16 once, in place, so that each sampling step reads 2-byte
    weights; 1-D parameters (biases, norm gains) stay f32. Returns `model`."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model

"""Timestep samplers with loss-second-moment importance sampling
(ccdm_tpu/training/resample.py).

ADM-G's loss-aware sampler: a per-timestep ring buffer of recent losses,
t drawn with probability proportional to sqrt(E[loss^2]) plus a uniform
floor, uniform until every timestep has a full history. The categorical
draw is the argmax of log p plus Gumbel noise, as jax.random.categorical
takes it, from a torch.Generator or from Gumbel noise given as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ccdm_tpu_torch.training.vicinity import gumbel


@dataclasses.dataclass
class LossAwareState:
    history: torch.Tensor  # [T, K] f32 ring buffer of recent per-t losses
    counts: torch.Tensor  # [T] int32 number of recorded losses per t
    num_timesteps: int
    history_per_term: int
    uniform_prob: float


def create_loss_aware_state(num_timesteps: int, history_per_term: int = 10,
                            uniform_prob: float = 0.001, device="cpu") -> LossAwareState:
    return LossAwareState(
        history=torch.zeros(num_timesteps, history_per_term, device=device),
        counts=torch.zeros(num_timesteps, dtype=torch.int32, device=device),
        num_timesteps=num_timesteps, history_per_term=history_per_term,
        uniform_prob=uniform_prob)


def loss_aware_weights(state: LossAwareState) -> torch.Tensor:
    """Sampling probabilities [T]: sqrt(mean loss^2) normalised, with a
    uniform floor; uniform until every term has a full history."""
    t = state.num_timesteps
    warmed = bool(torch.all(state.counts >= state.history_per_term))
    if not warmed:
        return torch.full((t,), 1.0 / t, device=state.history.device)
    w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    return w * (1.0 - state.uniform_prob) + state.uniform_prob / t


def sample_timesteps(state: LossAwareState, batch: int,
                     gen: Optional[torch.Generator] = None,
                     gumbel_noise: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B] int64, importance weights [B] = 1 / (T p[t]))."""
    p = loss_aware_weights(state)
    if gumbel_noise is None:
        gumbel_noise = gumbel((batch, state.num_timesteps), gen, p.device)
    t = torch.argmax(torch.log(p)[None, :] + gumbel_noise.to(p.device), dim=1)
    return t, 1.0 / (state.num_timesteps * p[t])


def update_with_losses(state: LossAwareState, t: torch.Tensor,
                       losses: torch.Tensor) -> LossAwareState:
    """Push per-sample losses into the ring buffers: element i of the batch,
    in the stable order of t, goes to slot (counts[t] + its rank among the
    batch's equal t) % history_per_term; counts grow by each t's
    multiplicity, capped at 2 * history_per_term. Returns a new state."""
    t = t.to(state.counts.device, torch.long)
    order = torch.sort(t, stable=True).indices
    t_sorted, losses_sorted = t[order], losses.to(state.history)[order]
    same = torch.zeros_like(t_sorted)
    same[1:] = (t_sorted[1:] == t_sorted[:-1]).long()
    # rank within each run of equal t: the position minus the run's start
    pos = torch.arange(len(t_sorted), device=t.device)
    starts = torch.where(same == 0, pos, torch.zeros_like(pos))
    rank = pos - torch.cummax(starts, dim=0).values
    slot = (state.counts[t_sorted].long() + rank) % state.history_per_term
    history = state.history.clone()
    # more than history_per_term equal t in one batch write a slot twice;
    # which write stays is then unspecified, as in JAX's scatter
    history[t_sorted, slot] = losses_sorted
    counts = state.counts.clone().index_add_(0, t_sorted, torch.ones_like(t_sorted,
                                                                          dtype=torch.int32))
    counts = torch.clamp(counts, max=state.history_per_term * 2)
    return dataclasses.replace(state, history=history, counts=counts)

"""Vicinity batch construction on the device (ccdm_tpu/training/vicinity.py).

Drawing target labels (a uniform unique label plus N(0, sigma_delta)) and
choosing real images whose labels fall in the (projected) kappa-vicinity
of each target, as fixed-shape tensor math: a uniform choice among the
valid candidates is the Gumbel-argmax over log(mask), and an empty vicinity
falls back to the nearest label. Every function draws from an explicit
torch.Generator, or takes its draws as tensors so that the tests can hand
in JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ccdm_tpu_torch.ops.vicinal import pairwise_distance, random_projection_vectors


def gumbel(shape, gen: Optional[torch.Generator] = None, device="cpu") -> torch.Tensor:
    """-log(-log(u)), u uniform in [1e-20, 1) (vicinity.py:33-35)."""
    u = torch.rand(shape, generator=gen, device=device).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def masked_uniform_choice(mask: torch.Tensor, gumbel_noise: torch.Tensor) -> torch.Tensor:
    """One True column per row of mask [B, N], uniformly: the argmax of
    log(mask) + Gumbel noise. A row with no True entry gives index 0."""
    logits = torch.where(mask, 0.0, float("-inf"))
    return torch.argmax(logits + gumbel_noise, dim=1)


def sample_target_labels(unique_labels: torch.Tensor, batch_size: int, sigma_delta,
                         gen: Optional[torch.Generator] = None,
                         idx: Optional[torch.Tensor] = None,
                         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Targets [B, D] = unique_labels[idx] + eps * sigma_delta, idx uniform
    over the U unique labels and eps standard normal [B, D]."""
    dev = unique_labels.device
    if idx is None:
        idx = torch.randint(0, unique_labels.shape[0], (batch_size,), generator=gen, device=dev)
    base = unique_labels[idx.to(dev)]
    if eps is None:
        eps = torch.randn(base.shape, generator=gen, device=dev)
    sigma = torch.as_tensor(sigma_delta, dtype=torch.float32, device=dev)
    return base + eps.to(dev) * sigma


def select_vicinity_indices(target_labels: torch.Tensor, train_labels: torch.Tensor, kappa,
                            vicinity_type: str, distance: str = "l2",
                            nonzero_soft_weight_threshold: float = 1e-3,
                            gen: Optional[torch.Generator] = None,
                            gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] indices of real samples for hv (d <= kappa) and sv
    (exp(-d^2/kappa^2) >= tau), uniform among them, nearest label if none."""
    dist = pairwise_distance(target_labels, train_labels, distance)  # [B, N]
    if vicinity_type == "hv":
        mask = dist <= kappa
    elif vicinity_type == "sv":
        support = -torch.log(torch.tensor(nonzero_soft_weight_threshold)) * (kappa * kappa)
        mask = (dist * dist) <= support.to(dist.device)
    else:
        raise ValueError(f"select_vicinity_indices handles hv/sv, got {vicinity_type}")
    if gumbel_noise is None:
        gumbel_noise = gumbel(mask.shape, gen, mask.device)
    chosen = masked_uniform_choice(mask, gumbel_noise.to(mask.device))
    return torch.where(mask.any(dim=1), chosen, torch.argmin(dist, dim=1))


def select_vicinity_indices_sliced(target_labels: torch.Tensor, train_labels: torch.Tensor,
                                   kappa, vector_type: str = "gaussian",
                                   num_projections: int = 1, top_k: int = 10,
                                   gen: Optional[torch.Generator] = None,
                                   vecs: Optional[torch.Tensor] = None,
                                   tie: Optional[torch.Tensor] = None,
                                   gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] indices by multi-projection voting (shv/ssv): votes = the number
    of projections with |proj_train - proj_target| <= kappa |v|, candidates
    ordered by votes with a uniform tie-break `tie` [B, N], the top-k with at
    least one vote picked uniformly; nearest label (l2) if none voted."""
    dev = train_labels.device
    d = train_labels.shape[-1]
    if vecs is None:
        vecs = random_projection_vectors(vector_type, d, num_projections, gen, dev)
    vecs = vecs.to(dev)
    v_norm = torch.linalg.vector_norm(vecs, dim=-1)
    v_unit = vecs / (v_norm[:, None] + 1e-8)
    proj_train = train_labels @ v_unit.T  # [N, M]
    proj_target = target_labels @ v_unit.T  # [B, M]
    diff = (proj_train[None, :, :] - proj_target[:, None, :]).abs()  # [B, N, M]
    votes = (diff <= (kappa * v_norm)[None, None, :]).sum(-1)  # [B, N]
    k_eff = min(top_k, train_labels.shape[0])
    if tie is None:
        tie = torch.rand(votes.shape, generator=gen, device=dev)
    scores = votes.float() + tie.to(dev) * 0.5
    top_scores, top_idx = torch.topk(scores, k_eff, dim=1)
    valid = top_scores >= 1.0
    if gumbel_noise is None:
        gumbel_noise = gumbel(valid.shape, gen, dev)
    pick = masked_uniform_choice(valid, gumbel_noise.to(dev))
    chosen = torch.gather(top_idx, 1, pick[:, None])[:, 0]
    nearest = torch.argmin(pairwise_distance(target_labels, train_labels, "l2"), dim=1)
    return torch.where(valid.any(dim=1), chosen, nearest)

"""Vicinal loss weighting: hard/soft, classic and sliced variants.

Counterpart of ccdm_tpu/ops/vicinal.py, as [B, B] pairwise tensor math.
Labels are [B, D] f32 (scalar labels are D = 1); `null_mask` [B] is True
where the CFG condition was dropped, and those rows get weight 1.
"""

from __future__ import annotations

from typing import Optional

import torch


def _l2_normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=dim, keepdim=True) + eps)


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x.reshape(1, -1) if x.ndim < 2 else x


def random_projection_vectors(vector_type: str, dim: int, n: int,
                              gen: Optional[torch.Generator] = None,
                              device="cpu") -> torch.Tensor:
    """[n, dim] random projection directions: gaussian, rademacher or
    sphere."""
    if vector_type == "gaussian":
        return torch.randn(n, dim, generator=gen, device=device)
    if vector_type == "rademacher":
        return torch.randint(0, 2, (n, dim), generator=gen, device=device).float() * 2.0 - 1.0
    if vector_type == "sphere":
        return _l2_normalize(torch.randn(n, dim, generator=gen, device=device))
    raise ValueError(f"unknown vector type: {vector_type}")


def pairwise_distance(labels_a: torch.Tensor, labels_b: torch.Tensor,
                      distance: str = "l2") -> torch.Tensor:
    """[A, B] distances between [A, D] and [B, D] label sets; for D = 1
    every distance is |a - b|."""
    a, b = _atleast_2d(labels_a), _atleast_2d(labels_b)
    if a.shape[-1] == 1:
        return (a - b.T).abs()
    if distance == "l2":
        diff = a[:, None, :] - b[None, :, :]
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    if distance == "l1":
        return (a[:, None, :] - b[None, :, :]).abs().sum(-1)
    if distance == "cosine":
        return 1.0 - _l2_normalize(a) @ _l2_normalize(b).T
    raise ValueError(f"unknown distance type: {distance}")


def sliced_batch_weights(labels: torch.Tensor, proj_vectors: torch.Tensor, kappa,
                         hard: bool, null_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sliced weights [B]: per projection direction v, pairwise differences
    of the labels projected on v/|v|; hard counts |diff| <= kappa |v|, soft
    sums exp(-diff^2 / kappa^2); mean over projections, divided by B."""
    labels = _atleast_2d(labels)
    b, m = labels.shape[0], proj_vectors.shape[0]
    v_norm = torch.linalg.vector_norm(proj_vectors, dim=-1)
    proj = labels @ _l2_normalize(proj_vectors).T  # [B, M]
    diff = proj.T[:, :, None] - proj.T[:, None, :]  # [M, B, B]
    if hard:
        eff = kappa * v_norm + 1e-8
        per_proj = (diff.abs() <= eff[:, None, None]).float().sum(-1)
    else:
        per_proj = torch.exp(-(1.0 / kappa ** 2) * diff * diff).sum(-1)
    weights = per_proj.sum(0) / m / b
    if null_mask is not None:
        weights = torch.where(null_mask, torch.ones_like(weights), weights)
    return weights


def classic_batch_weights(labels: torch.Tensor, kappa, hard: bool, distance: str = "l2",
                          null_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classic weights [B]: the count of batch members within kappa (hard)
    or sum exp(-d^2 / kappa^2) (soft), divided by B."""
    labels = _atleast_2d(labels)
    b = labels.shape[0]
    dist = pairwise_distance(labels, labels, distance)
    if hard:
        weights = (dist <= kappa).float().sum(-1)
    else:
        weights = torch.exp(-(1.0 / kappa ** 2) * dist * dist).sum(-1)
    weights = weights / b
    if null_mask is not None:
        weights = torch.where(null_mask, torch.ones_like(weights), weights)
    return weights


def _rowwise_distance(a: torch.Tensor, b: torch.Tensor, distance: str) -> torch.Tensor:
    if a.shape[-1] == 1:
        return (a - b).abs()[:, 0]
    if distance == "l2":
        return torch.sqrt(torch.clamp(((a - b) ** 2).sum(-1), min=0.0))
    if distance == "l1":
        return (a - b).abs().sum(-1)
    if distance == "cosine":
        return 1.0 - (_l2_normalize(a) * _l2_normalize(b)).sum(-1)
    raise ValueError(f"unknown distance type: {distance}")


def hard_weights_from_targets(batch_labels: torch.Tensor, target_labels: torch.Tensor,
                              kappa, distance: str = "l2") -> torch.Tensor:
    """Per-sample 1 where d(label_i, target_i) <= kappa, else 0."""
    d = _rowwise_distance(_atleast_2d(batch_labels), _atleast_2d(target_labels), distance)
    return (d <= kappa).float()


def soft_weights_from_targets(batch_labels: torch.Tensor, target_labels: torch.Tensor,
                              kappa, distance: str = "l2") -> torch.Tensor:
    """Per-sample exp(-d^2 / kappa^2)."""
    d = _rowwise_distance(_atleast_2d(batch_labels), _atleast_2d(target_labels), distance)
    return torch.exp(-(1.0 / kappa ** 2) * d * d)

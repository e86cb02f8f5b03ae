"""Vicinal hyperparameter policies (sigma_delta, kappa), on the host, once.

A numpy copy of ccdm_tpu/training/hyperparams.py (the port imports nothing
of the JAX package).

Ports the reference's two policies:
- rule_of_thumb (`CCDM_unified/trainer.py:178-217`, `main.py:145-240`,
  vanilla `main.py:169-191`): sigma = 1.06*std*N^(-1/5); kappa from the max
  gap between consecutive sorted unique labels, with the vanilla multiplier
  convention (flag kappa < 0 means kappa_base = |flag| * max_gap), and the
  soft-vicinity inversion kappa = 1/kappa_base^2.
- percentile (`trainer.py:218-247`): kappa = percentile of pairwise label
  distances (the reference's O(N^2) Python loop is a vectorized numpy
  computation here, subsampled above a size cap), sigma = kappa/3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _as_2d(labels: np.ndarray) -> np.ndarray:
    labels = np.asarray(labels, dtype=np.float64)
    return labels[:, None] if labels.ndim == 1 else labels


def rule_of_thumb_sigma(labels: np.ndarray) -> np.ndarray | float:
    """sigma = 1.06 * std * N^(-1/5) (per-dim for multi-dim labels)."""
    labels = np.asarray(labels, dtype=np.float64)
    std = np.std(labels, axis=0) if labels.ndim > 1 else np.std(labels)
    return 1.06 * std * len(labels) ** (-1.0 / 5.0)


def max_unique_gap(labels: np.ndarray) -> float:
    """Max L2 gap between consecutive lexsorted unique labels."""
    lab2 = _as_2d(labels)
    uniq = np.unique(lab2, axis=0)
    if len(uniq) < 2:
        return 0.0
    order = np.lexsort([uniq[:, i] for i in range(uniq.shape[1] - 1, -1, -1)])
    s = uniq[order]
    return float(np.max(np.linalg.norm(np.diff(s, axis=0), axis=1)))


def pairwise_distances(labels: np.ndarray, distance: str = "l2", max_n: int = 4000,
                       seed: int = 0) -> np.ndarray:
    """Upper-triangle pairwise distances, subsampled to max_n points."""
    lab2 = _as_2d(labels)
    if len(lab2) > max_n:
        rng = np.random.default_rng(seed)
        lab2 = lab2[rng.choice(len(lab2), max_n, replace=False)]
    if distance == "l2":
        d = np.linalg.norm(lab2[:, None] - lab2[None, :], axis=-1)
    elif distance == "l1":
        d = np.abs(lab2[:, None] - lab2[None, :]).sum(-1)
    elif distance == "cosine":
        n = lab2 / (np.linalg.norm(lab2, axis=-1, keepdims=True) + 1e-12)
        d = 1.0 - n @ n.T
    else:
        raise ValueError(f"unknown distance {distance}")
    iu = np.triu_indices(len(lab2), k=1)
    return d[iu]


def compute_vicinal_hyperparams(
    labels: np.ndarray,
    vicinity_type: str,
    hyperparameter: str = "rule_of_thumb",
    kernel_sigma: float | None = None,
    kappa: float | None = None,
    percentile: float = 5.0,
    distance: str = "l2",
) -> Tuple[np.ndarray | float, float]:
    """Resolve (sigma_delta, kappa) from flags + data.

    Flag conventions (vanilla main.py:169-191): a provided value > 0 is used
    as-is; value <= 0 (or None) triggers the policy, with |kappa_flag| acting
    as the max-gap multiplier (|0| -> 1).

    Kappa convention (deliberate normalization of a fork inconsistency): the
    returned kappa is ALWAYS the raw vicinity radius (kappa_base). The
    reference stores 1/base^2 for soft vicinity (`trainer.py:211-213`) and
    then its unified p_losses inverts AGAIN (nu = 1/kappa^2,
    `diffusion.py:651,719`) — a double inversion the vanilla tree does not
    have. Our loss/selection code uniformly uses nu = 1/radius^2, so a single
    radius parameter serves hard and soft alike.
    """
    is_hard = vicinity_type in ("hv", "shv")

    if hyperparameter == "rule_of_thumb":
        sigma = kernel_sigma if (kernel_sigma is not None and kernel_sigma > 0) else rule_of_thumb_sigma(labels)
        if kappa is not None and kappa > 0:
            kap = float(kappa)
        else:
            mult = abs(kappa) if (kappa is not None and kappa != 0) else 1.0
            base = mult * max_unique_gap(labels)
            kap = base if base > 0 else 0.01
    elif hyperparameter == "percentile":
        dists = pairwise_distances(labels, distance)
        kap = float(np.percentile(dists, percentile))
        sigma = kernel_sigma if (kernel_sigma is not None and kernel_sigma > 0) else kap / 3.0
        if kap <= 0:
            kap = 0.01
    else:
        raise ValueError(f"unknown hyperparameter policy {hyperparameter}")

    return sigma, kap

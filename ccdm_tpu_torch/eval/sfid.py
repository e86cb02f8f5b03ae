"""Sliding-window SFID / Label-Score / Diversity protocol (counterpart of
ccdm_tpu/eval/sfid.py; the vanilla eval block,
`CCDM_vanilla/RC-49/RC-49_64x64/CCGM/CCDM/main.py:562-613`): windows of
radius FID_radius slide over the RAW label range; per center, the FID
between the real and fake images whose labels fall in the window, the
Label Score of the fakes, and the Shannon entropy of their predicted
classes; per-center arrays with mean and std, npz-dumpable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
from torch import nn

from ccdm_tpu_torch.eval.metrics import (
    compute_entropy,
    extract_features,
    frechet_distance,
    labelscore_from_preds,
    predict_class_labels,
    predict_labels,
)


@dataclasses.dataclass
class SlidingWindowResult:
    centers: np.ndarray
    fids: np.ndarray
    labelscores: np.ndarray
    entropies: np.ndarray
    num_real: np.ndarray

    @property
    def sfid(self):  # (mean, std)
        return float(np.nanmean(self.fids)), float(np.nanstd(self.fids))

    @property
    def ls(self):
        return float(np.nanmean(self.labelscores)), float(np.nanstd(self.labelscores))

    @property
    def diversity(self):
        return float(np.nanmean(self.entropies)), float(np.nanstd(self.entropies))

    def save_npz(self, path: str) -> None:
        np.savez(path, fids=self.fids, labelscores=self.labelscores,
                 entropies=self.entropies, nrealimgs=self.num_real,
                 centers=self.centers)


def window_centers(real_labels: np.ndarray, fake_labels: np.ndarray, fid_radius: float,
                   num_centers: int) -> np.ndarray:
    """The unique fake labels at radius 0 without a count; else
    unit-stepped centers over [min + R, max - R] of the raw real labels
    (vanilla main.py:529-531); else num_centers evenly over that range."""
    if num_centers <= 0 and fid_radius == 0:
        return np.sort(np.unique(fake_labels))
    if num_centers <= 0:
        return np.arange(real_labels.min() + fid_radius, real_labels.max() - fid_radius + 1)
    start = real_labels.min() + fid_radius
    stop = real_labels.max() - fid_radius
    return np.linspace(start, stop, max(num_centers, 1))


def sliding_window_eval(
    real_images: np.ndarray,  # uint8 NHWC, RAW labels
    real_labels: np.ndarray,
    fake_images: np.ndarray,
    fake_labels: np.ndarray,  # RAW (unnormalized)
    fn_norm_labels: Callable,
    fid_net: nn.Module,
    ls_net: nn.Module,
    div_net: Optional[nn.Module] = None,
    fid_radius: float = 0.0,
    num_centers: int = -1,
    centers: Optional[np.ndarray] = None,
    max_label_after_shift: float = 1.0,
    min_label_before_shift: float = 0.0,
    batch_size: int = 200,
    verbose: bool = True,
    feats_real: Optional[np.ndarray] = None,
    feats_fake: Optional[np.ndarray] = None,
) -> SlidingWindowResult:
    real_labels = np.asarray(real_labels).reshape(-1)
    fake_labels = np.asarray(fake_labels).reshape(-1)

    # one pass of each net over the full sets; every center is then host
    # slicing and Frechet algebra
    if feats_real is None:
        feats_real = extract_features(fid_net, real_images, batch_size)
    if feats_fake is None:
        feats_fake = extract_features(fid_net, fake_images, batch_size)
    ls_preds = predict_labels(ls_net, fake_images, batch_size)
    class_preds = (predict_class_labels(div_net, fake_images, batch_size)
                   if div_net is not None else None)

    if centers is None:
        centers = window_centers(real_labels, fake_labels, fid_radius, num_centers)

    n = len(centers)
    fids = np.full(n, np.nan)
    lss = np.full(n, np.nan)
    ents = np.full(n, np.nan)
    n_real = np.zeros(n)

    for i, center in enumerate(centers):
        lo, hi = center - fid_radius, center + fid_radius
        idx_r = np.where((real_labels >= lo) & (real_labels <= hi))[0]
        idx_f = np.where((fake_labels >= lo) & (fake_labels <= hi))[0]
        n_real[i] = len(idx_r)
        if len(idx_r) < 2 or len(idx_f) < 2:
            continue
        fids[i] = frechet_distance(feats_real[idx_r], feats_fake[idx_f],
                                   eps=1e-6)  # cal_FID's eps
        lss[i], _ = labelscore_from_preds(
            ls_preds[idx_f], fn_norm_labels(fake_labels[idx_f]),
            min_label_before_shift, max_label_after_shift,
        )
        if class_preds is not None:
            ents[i] = compute_entropy(class_preds[idx_f])
        if verbose:
            print(f"\r Center:{center}; Real:{len(idx_r)}; Fake:{len(idx_f)}; "
                  f"FID:{fids[i]:.3f}; LS:{lss[i]:.3f}; ET:{ents[i]:.3f}.")

    return SlidingWindowResult(np.asarray(centers), fids, lss, ents, n_real)

"""Evaluation metrics: FID, Label Score, Diversity entropy, Inception Score,
PRDC and intra-class FID (counterpart of ccdm_tpu/eval/metrics.py).

A net's forward runs batched on the net's device, in eval mode, under
torch.no_grad() and in full f32 (utils/device.full_f32: no TF32); the
Frechet algebra stays in f64 numpy/scipy on the host (sqrtm of a
512 x 512 matrix is small and precision-sensitive). The nets
take NHWC images, as the JAX modules do, and return a tensor or a tuple
whose first item is the prediction and whose second is the features.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from scipy import linalg
from torch import nn

from ccdm_tpu_torch.utils.device import full_f32


def frechet_distance(Xr: np.ndarray, Xg: np.ndarray, eps: float = 1e-10) -> float:
    """FID between feature sets [N, d] (eval_metrics.py:43-70)."""
    mu_r, mu_g = Xr.mean(axis=0), Xg.mean(axis=0)
    diff = mu_r - mu_g
    cov_r = np.cov(Xr.T)
    cov_g = np.cov(Xg.T)
    # sqrtm's result; its disp argument (ccdm_tpu's disp=False, which also
    # returns an error estimate) is gone from newer scipy
    covmean = linalg.sqrtm(cov_r.dot(cov_g)).real
    if not np.isfinite(covmean).all():
        offset = np.eye(cov_r.shape[0]) * eps
        covmean = linalg.sqrtm((cov_r + offset).dot(cov_g + offset)).real
    return float(diff.dot(diff) + np.trace(cov_r + cov_g - 2 * covmean))


def _batched_apply(fn: Callable[[torch.Tensor], torch.Tensor], images: np.ndarray,
                   batch_size: int, device) -> np.ndarray:
    """fn over images in chunks of batch_size on `device` in full f32 (no
    TF32), the last chunk padded by repeating its last image (every call
    has one shape)."""
    n = len(images)
    batch_size = min(batch_size, n)
    outs = []
    done = 0
    with full_f32():
        while done < n:
            chunk = images[done:done + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            out = fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(device)).cpu().numpy()
            outs.append(out[: len(out) - pad or None])
            done += batch_size
    return np.concatenate(outs, axis=0)[:n]


def _apply(net: nn.Module, images: np.ndarray, batch_size: int, norm_img: bool,
           pick: Callable) -> np.ndarray:
    """pick(net(x)) over images, x uint8 mapped to [-1, 1] when norm_img."""
    device = next(net.parameters()).device
    net.eval()

    @torch.no_grad()
    def fn(x):
        if norm_img:
            x = x.float() / 255.0 * 2.0 - 1.0
        return pick(net(x.float()))

    return _batched_apply(fn, images, batch_size, device)


def _features(out):
    return out[1] if isinstance(out, tuple) else out


def _prediction(out):
    return out[0] if isinstance(out, tuple) else out


def extract_features(net: nn.Module, images: np.ndarray, batch_size: int = 200,
                     normalize: bool = True) -> np.ndarray:
    """images [N, H, W, C] uint8 (or [-1, 1] floats with normalize False)
    -> [N, d] features."""
    return _apply(net, images, batch_size, normalize, _features)


def cal_FID(net: nn.Module, images_real: np.ndarray, images_fake: np.ndarray,
            batch_size: int = 200, norm_img: bool = True) -> float:
    """FID from raw image sets through the feature net (eval_metrics.py:78-146)."""
    Xr = extract_features(net, images_real, batch_size, norm_img)
    Xg = extract_features(net, images_fake, batch_size, norm_img)
    return frechet_distance(Xr, Xg, eps=1e-6)


def predict_labels(net: nn.Module, images: np.ndarray, batch_size: int = 200,
                   norm_img: bool = True) -> np.ndarray:
    """Per-image NORMALIZED label predictions of a regression eval net [N]."""
    return _apply(net, images, batch_size, norm_img,
                  lambda out: _prediction(out).reshape(-1)).reshape(-1)


def labelscore_from_preds(preds: np.ndarray, labels_assigned: np.ndarray,
                          min_label_before_shift: float,
                          max_label_after_shift: float) -> Tuple[float, float]:
    denorm = lambda y: y * max_label_after_shift - abs(min_label_before_shift)
    err = np.abs(denorm(np.asarray(preds).reshape(-1))
                 - denorm(np.asarray(labels_assigned).reshape(-1)))
    return float(err.mean()), float(err.std())


def cal_labelscore(net: nn.Module, images: np.ndarray, labels_assigned: np.ndarray,
                   min_label_before_shift: float, max_label_after_shift: float,
                   batch_size: int = 200, norm_img: bool = True) -> Tuple[float, float]:
    """Mean and std of |y_pred - y_assigned| after denormalization
    (eval_metrics.py:157-207); labels_assigned are NORMALIZED."""
    preds = predict_labels(net, images, batch_size, norm_img)
    return labelscore_from_preds(preds, labels_assigned,
                                 min_label_before_shift, max_label_after_shift)


def predict_class_labels(net: nn.Module, images: np.ndarray, batch_size: int = 200,
                         norm_img: bool = True) -> np.ndarray:
    """Argmax class predictions (utils.py:131-160)."""
    return _apply(net, images, batch_size, norm_img,
                  lambda out: torch.argmax(_prediction(out), dim=-1))


def compute_entropy(labels: np.ndarray, base: Optional[float] = None) -> float:
    """Shannon entropy of a label histogram (utils.py:125-129)."""
    _, counts = np.unique(labels, return_counts=True)
    p = counts / counts.sum()
    base = base if base is not None else np.e
    return float(-(p * np.log(p) / np.log(base)).sum())


def _pairwise_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N, d] x [M, d] -> [N, M] Euclidean distances, f32:
    sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))."""
    x2 = torch.sum(x * x, dim=1)[:, None]
    y2 = torch.sum(y * y, dim=1)[None, :]
    return torch.sqrt(torch.clamp(x2 + y2 - 2.0 * (x @ y.T), min=0.0))


def _kth_nn_radius(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Distance to the k-th nearest neighbour (self excluded) of each row:
    the largest of the k + 1 smallest distances, the 0 to itself among
    them (StudioGAN prdc.py:101-126)."""
    d = _pairwise_euclidean(feats, feats)
    return torch.topk(d, k + 1, dim=1, largest=False).values[:, -1]


def compute_prdc(real_features: np.ndarray, fake_features: np.ndarray,
                 nearest_k: int = 5, match_n: bool = False, seed: int = 0) -> dict:
    """Precision / Recall / Density / Coverage (Naeem et al. 2020), the
    numerics of StudioGAN/metrics/prdc.py:128-168 in one pairwise pass.

    match_n subsamples the larger set to the smaller one (seeded): the
    k-NN radii shrink with set density, so unequal set sizes bias recall
    and precision."""
    real_features = np.asarray(real_features, np.float32)
    fake_features = np.asarray(fake_features, np.float32)
    if match_n and len(real_features) != len(fake_features):
        n = min(len(real_features), len(fake_features))
        rs = np.random.RandomState(seed)
        if len(real_features) > n:
            real_features = real_features[rs.choice(len(real_features), n, replace=False)]
        if len(fake_features) > n:
            fake_features = fake_features[rs.choice(len(fake_features), n, replace=False)]
    xr, xg = torch.from_numpy(real_features), torch.from_numpy(fake_features)
    r_radii = _kth_nn_radius(xr, nearest_k)  # [Nr]
    f_radii = _kth_nn_radius(xg, nearest_k)  # [Nf]
    d_rf = _pairwise_euclidean(xr, xg)  # [Nr, Nf]
    in_real_manifold = d_rf < r_radii[:, None]
    precision = in_real_manifold.any(dim=0).float().mean()
    recall = (d_rf < f_radii[None, :]).any(dim=1).float().mean()
    density = in_real_manifold.sum(dim=0).float().mean() / nearest_k
    coverage = (d_rf.min(dim=1).values < r_radii).float().mean()
    return dict(precision=float(precision), recall=float(recall), density=float(density),
                coverage=float(coverage))


def intra_class_fid(net: Optional[nn.Module], images_real: np.ndarray,
                    classes_real: np.ndarray, images_fake: np.ndarray,
                    classes_fake: np.ndarray, batch_size: int = 200, norm_img: bool = True,
                    min_per_class: int = 2, feats_real: Optional[np.ndarray] = None,
                    feats_fake: Optional[np.ndarray] = None):
    """Per-class FID (StudioGAN worker.py:1392-1466 'iFID'): the features
    once, then the Frechet distance per class both sides share. Returns
    (mean, std, {class: fid}); a class with fewer than min_per_class
    samples on either side is skipped. classes_* are discrete ids of one
    binning (train_backbones.bin_labels_to_classes with the real labels as
    ref); feats_* reuse features the caller extracted."""
    Xr = (feats_real if feats_real is not None
          else extract_features(net, images_real, batch_size, norm_img))
    Xg = (feats_fake if feats_fake is not None
          else extract_features(net, images_fake, batch_size, norm_img))
    cr = np.asarray(classes_real).reshape(-1)
    cg = np.asarray(classes_fake).reshape(-1)
    fids = {}
    for c in np.unique(cr):
        mr, mg = cr == c, cg == c
        if mr.sum() < min_per_class or mg.sum() < min_per_class:
            continue
        fids[c] = frechet_distance(Xr[mr], Xg[mg], eps=1e-6)
    vals = np.array(list(fids.values()), dtype=np.float64)
    if len(vals) == 0:
        return float("nan"), float("nan"), fids
    return float(vals.mean()), float(vals.std()), fids


def inception_score(net: nn.Module, images: np.ndarray, num_classes: int,
                    batch_size: int = 32, splits: int = 1,
                    norm_img: bool = True) -> Tuple[float, float]:
    """Entropy-based IS with the eval classifier as backbone
    (eval_metrics.py:215-271)."""
    preds = _apply(net, images, batch_size, norm_img,
                   lambda out: torch.softmax(_prediction(out), dim=-1))
    n = len(preds)
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        py = part.mean(axis=0)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12)[None, :])
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))

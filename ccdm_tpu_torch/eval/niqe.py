"""Native NIQE (Natural Image Quality Evaluator) — no MATLAB required.

The port's own copy of ccdm_tpu/eval/niqe.py (numpy and scipy only, so the
same code runs in both packages); NIQEModel.save writes the same npz
layout, so one fitted model serves both.

The reference computes NIQE by dumping PNGs and running MATLAB externally
(reference `CCDM_vanilla/.../main.py:498-513`, `README.md:189-191` "NIQE is
computed in MATLAB"). This module implements the published algorithm
(Mittal, Soundararajan, Bovik, "Making a 'Completely Blind' Image Quality
Analyzer", IEEE SPL 2013) in host-side numpy/scipy so `--comp_niqe` can score
fakes in-process, closing the one external-tool dependency of the eval
protocol.

Two deliberate deviations from the MATLAB release, both documented here
because they change absolute values (scores remain comparable across runs of
THIS implementation, like our retrained eval backbones — SURVEY §7.3-7):

1. **Dataset-calibrated pristine model.** MATLAB ships a multivariate
   Gaussian fit on 125 pristine photographic images. Our corpora are 64–192
   px microscopy/renders/faces, far outside that model's domain, so we fit
   the pristine MVG on the dataset's own REAL images (the same philosophy as
   the retrained FID/LS backbones). The score is then "distance from the
   real-data NSS statistics" — 0-anchored by a real-vs-real control exactly
   like our PRDC control.
2. **Patch size scales with image size.** MATLAB uses 96x96 patches (inputs
   are >=512^2). For 64^2 inputs we default to 32x32 (>= 2 patches per axis
   at scale 1, 16x16 on the half-res scale-2 image), keeping the
   patch-statistics structure intact.

Everything else follows the paper: MSCN coefficients with a 7x7 sigma=7/6
Gaussian window, GGD fit of the MSCN histogram + AGGD fits of the four
orientation products (18 features/scale), two scales, sharpness-selected
patches for the pristine fit, Mahalanobis-type distance with the pooled
covariance pseudo-inverse.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.special import gamma as _gamma

# ---------------------------------------------------------------- MSCN field

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
# r(g) = Gamma(1/g)Gamma(3/g)/Gamma(2/g)^2, precomputed once for the
# moment-matching inversions below
_R_GAM = (_gamma(1.0 / _GAMMA_RANGE) * _gamma(3.0 / _GAMMA_RANGE)
          / _gamma(2.0 / _GAMMA_RANGE) ** 2)


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    w = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return w / w.sum()


_WIN = _gaussian_window()


def mscn_coefficients(img: np.ndarray, eps: float = 1.0):
    """(MSCN, sigma_map) of a float64 2-D luminance image in [0, 255]."""
    img = np.asarray(img, np.float64)
    mu = ndimage.correlate(img, _WIN, mode="nearest")
    sigma = np.sqrt(np.maximum(
        ndimage.correlate(img * img, _WIN, mode="nearest") - mu * mu, 0.0))
    return (img - mu) / (sigma + eps), sigma


# ------------------------------------------------------- GGD / AGGD fitting

def fit_ggd(x: np.ndarray):
    """Moment-matching GGD fit -> (alpha, sigma_sq). alpha=2 for Gaussian."""
    x = np.asarray(x, np.float64).ravel()
    sigma_sq = float(np.mean(x * x)) + 1e-12
    e_abs = float(np.mean(np.abs(x))) + 1e-12
    rho = sigma_sq / (e_abs * e_abs)
    alpha = _GAMMA_RANGE[int(np.argmin((_R_GAM - rho) ** 2))]
    return float(alpha), sigma_sq


def fit_aggd(x: np.ndarray):
    """Asymmetric-GGD fit -> (alpha, eta, bl_sq, br_sq).

    eta is the AGGD mean term used as the NIQE feature; bl_sq/br_sq are the
    left/right scale parameters squared (variances of each half).
    """
    x = np.asarray(x, np.float64).ravel()
    left = x[x < 0]
    right = x[x > 0]
    bl_sq = float(np.mean(left * left)) if left.size else 1e-12
    br_sq = float(np.mean(right * right)) if right.size else 1e-12
    gamma_hat = np.sqrt(bl_sq) / (np.sqrt(br_sq) + 1e-12)
    e_abs = float(np.mean(np.abs(x))) + 1e-12
    r_hat = e_abs * e_abs / (float(np.mean(x * x)) + 1e-12)
    r_hat_norm = (r_hat * (gamma_hat ** 3 + 1.0) * (gamma_hat + 1.0)
                  / (gamma_hat ** 2 + 1.0) ** 2)
    alpha = _GAMMA_RANGE[int(np.argmin((1.0 / _R_GAM - r_hat_norm) ** 2))]
    g1, g2 = _gamma(1.0 / alpha), _gamma(2.0 / alpha)
    g3 = _gamma(3.0 / alpha)
    eta = (np.sqrt(br_sq) - np.sqrt(bl_sq)) * (g2 / np.sqrt(g1 * g3 + 1e-300))
    return float(alpha), float(eta), bl_sq, br_sq


def _patch_features(mscn: np.ndarray) -> np.ndarray:
    """The 18 NSS features of one MSCN patch (paper Table 1)."""
    feats = list(fit_ggd(mscn))
    shifts = ((0, 1), (1, 0), (1, 1), (1, -1))  # H, V, D1, D2 products
    for dy, dx in shifts:
        prod = mscn * np.roll(np.roll(mscn, dy, axis=0), dx, axis=1)
        feats.extend(fit_aggd(prod))
    return np.asarray(feats, np.float64)


# ----------------------------------------------------------- image features

def _to_luma(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W], [H,W,1] or [H,W,3] -> float64 luminance [0,255]."""
    a = np.asarray(img, np.float64)
    if a.ndim == 3:
        if a.shape[-1] == 1:
            a = a[..., 0]
        else:
            a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return a


def _half_scale(img: np.ndarray) -> np.ndarray:
    """2x2 box downsample (the paper low-passes then decimates)."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    a = img[:h, :w]
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])


def image_patch_features(img: np.ndarray, patch: int = 32,
                         sharpness_fraction: float | None = None):
    """All 36-dim patch features of one image (2 scales x 18).

    Returns [P, 36]. With `sharpness_fraction` (pristine fit), only scale-1
    patches whose mean local sigma exceeds fraction*max are kept — the
    paper's sharpness selection.
    """
    luma = _to_luma(img)
    mscn1, sig1 = mscn_coefficients(luma)
    mscn2, _ = mscn_coefficients(_half_scale(luma))

    ny, nx = luma.shape[0] // patch, luma.shape[1] // patch
    if ny < 1 or nx < 1:
        raise ValueError(f"patch {patch} larger than image {luma.shape}")
    half = patch // 2
    feats, sharp = [], []
    for iy in range(ny):
        for ix in range(nx):
            p1 = mscn1[iy * patch:(iy + 1) * patch, ix * patch:(ix + 1) * patch]
            p2 = mscn2[iy * half:(iy + 1) * half, ix * half:(ix + 1) * half]
            feats.append(np.concatenate([_patch_features(p1),
                                         _patch_features(p2)]))
            sharp.append(sig1[iy * patch:(iy + 1) * patch,
                              ix * patch:(ix + 1) * patch].mean())
    feats = np.stack(feats)
    if sharpness_fraction is not None and len(feats) > 1:
        sharp = np.asarray(sharp)
        keep = sharp > sharpness_fraction * sharp.max()
        if keep.any():
            feats = feats[keep]
    return feats


# --------------------------------------------------------------- the scorer

class NIQEModel:
    """Pristine MVG (mu, cov) in the 36-dim NSS feature space."""

    def __init__(self, mu: np.ndarray, cov: np.ndarray, patch: int):
        self.mu = np.asarray(mu, np.float64)
        self.cov = np.asarray(cov, np.float64)
        self.patch = int(patch)

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, cov=self.cov, patch=self.patch)

    @classmethod
    def load(cls, path: str) -> "NIQEModel":
        d = np.load(path)
        return cls(d["mu"], d["cov"], int(d["patch"]))


def fit_niqe_model(images: np.ndarray, patch: int = 32,
                   sharpness_fraction: float = 0.75,
                   max_images: int = 2000, seed: int = 0) -> NIQEModel:
    """Fit the pristine model on real images (uint8 [N,H,W,C])."""
    images = np.asarray(images)
    if len(images) > max_images:
        idx = np.random.default_rng(seed).choice(len(images), max_images,
                                                 replace=False)
        images = images[idx]
    feats = np.concatenate([
        image_patch_features(im, patch, sharpness_fraction) for im in images])
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return NIQEModel(mu, cov, patch)


def niqe_score(images: np.ndarray, model: NIQEModel) -> np.ndarray:
    """Per-image NIQE scores (lower = closer to the pristine statistics).

    Each image contributes all its patches (no sharpness selection on the
    test side, per the paper); the quality index is
    sqrt((mu_p-mu_d)^T [ (cov_p+cov_d)/2 ]^+ (mu_p-mu_d)).
    """
    out = np.empty(len(images), np.float64)
    for i, im in enumerate(images):
        feats = image_patch_features(im, model.patch)
        mu_d = feats.mean(axis=0)
        cov_d = (np.cov(feats, rowvar=False) if len(feats) > 1
                 else np.zeros_like(model.cov))
        diff = model.mu - mu_d
        pooled = (model.cov + cov_d) / 2.0
        out[i] = float(np.sqrt(max(diff @ np.linalg.pinv(pooled) @ diff, 0.0)))
    return out


def default_patch_for(image_size: int) -> int:
    """96 for >=192 px (MATLAB convention), else half the image side."""
    return 96 if image_size >= 192 else max(image_size // 2, 16)

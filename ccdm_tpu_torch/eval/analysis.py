"""Qualitative analysis passes of the StudioGAN worker (counterpart of
ccdm_tpu/eval/analysis.py; ref `CCDM_vanilla/.../StudioGAN/worker.py`):
k-nearest-neighbour grids (:1068-1163), latent/label interpolation
(:1164-1218), the frequency spectrum (:1219-1295), t-SNE of embeddings
(:1297-1392), GAN-train / GAN-test accuracy (:1529-1641), and SeFa's
closed-form latent axes (utils/sefa.py:12-30).

Embeddings come from a caller's `embed_fn` (the pinned AE encoder of
eval/train_backbones.py) in place of a downloaded ResNet50; the grids and
spectra come back as arrays for the caller to save.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _as_features(images: np.ndarray, embed_fn: Optional[Callable]) -> np.ndarray:
    """[N, H, W, C] uint8 or float -> [N, F] float features (pixels without
    an embed_fn)."""
    if embed_fn is not None:
        return np.asarray(embed_fn(images), np.float32)
    x = np.asarray(images, np.float32)
    return x.reshape(x.shape[0], -1)


def k_nearest_neighbors(fake_images: np.ndarray, real_images: np.ndarray, k: int = 7,
                        embed_fn: Optional[Callable] = None, anchors: int = 8,
                        real_features: Optional[np.ndarray] = None) -> np.ndarray:
    """For each of the first `anchors` fakes, its k nearest reals by feature
    L2: a uint8 grid [anchors, k + 1, H, W, C], column 0 the fake anchor.
    real_features reuses embeddings the caller extracted."""
    fa = np.asarray(fake_images[:anchors])
    ff = torch.from_numpy(_as_features(fa, embed_fn))
    rf = torch.from_numpy(np.asarray(real_features, np.float32) if real_features is not None
                          else _as_features(real_images, embed_fn))
    # [A, N] squared distances, f32
    d = (torch.sum(ff ** 2, 1)[:, None] - 2.0 * ff @ rf.T + torch.sum(rf ** 2, 1)[None, :])
    idx = torch.topk(d, k, dim=1, largest=False).indices.numpy()  # [A, k] nearest first
    rows = [np.concatenate([fa[i:i + 1], np.asarray(real_images)[idx[i]]], 0)
            for i in range(fa.shape[0])]
    return np.stack(rows).astype(np.uint8)


def linear_interpolation(gen_fn: Callable, z0: torch.Tensor, z1: torch.Tensor,
                         y0: torch.Tensor, y1: torch.Tensor, steps: int = 8) -> np.ndarray:
    """gen_fn(z, y) -> images at `steps` weights in [0, 1], z and y blended
    with the same weights (z0 == z1 fixes z, y0 == y1 fixes y, the
    reference's two modes), in one batched call: [steps, H, W, C]."""
    w = torch.linspace(0.0, 1.0, steps, device=z0.device).reshape(-1, *([1] * z0.ndim))
    z = (1 - w) * z0[None] + w * z1[None]
    wy = torch.linspace(0.0, 1.0, steps, device=y0.device).reshape(-1, *([1] * y0.ndim))
    y = (1 - wy) * y0[None] + wy * y1[None]
    out = gen_fn(z.reshape(steps, *z0.shape), y.reshape(steps, *y0.shape))
    return out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


def _median_filter(gray: np.ndarray, size: int) -> np.ndarray:
    """[N, H, W] per-image 2-D median filter (scipy where present)."""
    try:
        from scipy import ndimage
        return np.stack([ndimage.median_filter(g, size=size) for g in gray])
    except ImportError:  # a box mean keeps the high-pass meaningful
        from numpy.lib.stride_tricks import sliding_window_view
        p = size // 2
        padded = np.pad(gray, ((0, 0), (p, p), (p, p)), mode="edge")
        win = sliding_window_view(padded, (size, size), axis=(1, 2))
        return win.mean(axis=(-1, -2))[:, : gray.shape[1], : gray.shape[2]]


def frequency_spectrum(real_u8: np.ndarray, fake_u8: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean log-magnitude FFT spectra [H, W] of median-high-passed
    grayscale images (worker.py:1268-1289): ITU-R 601 luma, minus an H // 8
    median filter, fft2, fftshift, 20 log|.| averaged."""
    def spectrum(u8: np.ndarray) -> np.ndarray:
        x = np.asarray(u8, np.float32)
        if x.ndim == 4 and x.shape[-1] == 3:
            gray = 0.2989 * x[..., 0] + 0.5870 * x[..., 1] + 0.1140 * x[..., 2]
        else:
            gray = x.reshape(x.shape[0], x.shape[1], x.shape[2])
        _, h, _ = gray.shape
        hp = gray - _median_filter(gray, max(h // 8, 1))
        f = np.fft.fftshift(np.fft.fft2(hp), axes=(-2, -1))
        return (20.0 * np.log(np.abs(f) + 1e-12)).mean(axis=0)

    return spectrum(real_u8), spectrum(fake_u8)


def tsne_embeds(real_feats: np.ndarray, fake_feats: np.ndarray, perplexity: float = 40.0,
                n_iter: int = 300, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """2-D t-SNE of real and fake embeddings, fitted once over both so the
    clouds share a space; the first two principal axes where sklearn is
    not installed (the card's machine has none). Returns (real_2d [N, 2],
    fake_2d [M, 2])."""
    n = real_feats.shape[0]
    both = np.concatenate([real_feats, fake_feats], 0).astype(np.float32)
    try:
        from sklearn.manifold import TSNE
        kw = dict(n_components=2, random_state=seed, init="pca",
                  perplexity=min(perplexity, max(both.shape[0] // 4, 2)))
        try:
            tsne = TSNE(max_iter=max(n_iter, 250), **kw)
        except TypeError:  # sklearn < 1.5 spells it n_iter
            tsne = TSNE(n_iter=max(n_iter, 250), **kw)
        pts = tsne.fit_transform(both)
    except ImportError:  # PCA
        both = both - both.mean(0)
        _, _, vt = np.linalg.svd(both, full_matrices=False)
        pts = both @ vt[:2].T
    return pts[:n], pts[n:]


def semantic_factorization(gen_fn: Callable, first_kernel: torch.Tensor, z: torch.Tensor,
                           y: torch.Tensor, num_axes: int = 4, max_variation: float = 5.0,
                           num_cols: int = 8) -> np.ndarray:
    """SeFa: the semantic axes are the top left-singular vectors of the
    generator's first dense kernel [z_dim, out] (the transpose of an
    nn.Linear's weight); row i walks z -> z + max_variation * axis_i in
    num_cols steps, all rows in one gen_fn call. Returns [num_axes,
    num_cols, H, W, C]."""
    u, _, _ = torch.linalg.svd(first_kernel.float(), full_matrices=False)
    axes = u[:, :num_axes]                                    # [z_dim, A]
    w = torch.linspace(0.0, 1.0, num_cols, device=z.device)   # [C]
    zs = z[None, None, :] + w[None, :, None] * max_variation * axes.T[:, None, :]  # [A, C, z]
    a, c, zd = zs.shape
    ys = y.expand((a * c,) + tuple(y.shape))
    out = gen_fn(zs.reshape(a * c, zd), ys)
    imgs = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    return imgs.reshape(a, c, *imgs.shape[1:])


def gan_train_test_accuracy(train_images: np.ndarray, train_labels: np.ndarray,
                            test_images: np.ndarray, test_labels: np.ndarray,
                            num_classes: int, epochs: int = 5, seed: int = 0,
                            device="cpu") -> float:
    """Classification Accuracy Score: a ResNet eval classifier fitted on
    the train set, its accuracy on the test set. GAN-train fits on fakes
    and tests on reals, GAN-test the other way round."""
    from ccdm_tpu_torch.eval.metrics import predict_class_labels
    from ccdm_tpu_torch.eval.train_backbones import train_eval_resnet

    net = train_eval_resnet(np.asarray(train_images), np.asarray(train_labels, np.int64),
                            "class", num_classes, epochs=epochs, seed=seed, device=device)
    pred = predict_class_labels(net, np.asarray(test_images), batch_size=256)
    return float(np.mean(pred == np.asarray(test_labels)))

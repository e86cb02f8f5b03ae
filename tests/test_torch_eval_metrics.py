"""Port parity of the eval metrics, the sliding window, native NIQE and the
analysis passes (ccdm_tpu_torch/eval/{metrics,sfid,niqe,analysis}.py)
against ccdm_tpu/eval/, on data drawn with numpy from a seed.

The nets are tiny linear maps of the flattened image, the same weights in
both packages (a flax-style apply function and an nn.Module). Tolerances,
each with its reason:
- on features both packages are given: the Frechet distance, the entropy,
  the label binning, the sliding-window centers and per-center numbers,
  intra-class FID, the frequency spectra and NIQE (fit and scores)
  exactly or to 1e-9 (the same f64 numpy/scipy algebra); PRDC the same
  counts, its four f32 means to 1e-6 (XLA and torch round a mean in
  another order);
- through the nets (f32 products in another framework): features and FID
  1e-5 relative, Label Score 1e-5, IS 1e-5;
- t-SNE's PCA fallback (sklearn hidden in both) 1e-6 of its largest |value|;
- the interpolation grid and SeFa's walk 1e-5 (SeFa's axes up to the sign
  an SVD may choose).
"""

import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from ccdm_tpu.eval import analysis as janalysis
from ccdm_tpu.eval import metrics as jmetrics
from ccdm_tpu.eval import niqe as jniqe
from ccdm_tpu.eval import sfid as jsfid
from ccdm_tpu.eval.train_backbones import bin_labels_to_classes as jax_bin
from ccdm_tpu_torch.eval import analysis, metrics, niqe, sfid
from ccdm_tpu_torch.eval.train_backbones import bin_labels_to_classes

torch.set_num_threads(2)

S = 8  # image side of the tiny nets


class _Linear(nn.Module):
    """x [B, S, S, C] -> (x W, x F): a prediction and features."""

    def __init__(self, w, f):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w))
        self.f = nn.Parameter(torch.from_numpy(f))

    def forward(self, x, train=False):
        flat = x.reshape(x.shape[0], -1)
        return flat @ self.w, flat @ self.f


def _nets(seed, outputs, dim=8, channels=3):
    """(port module, JAX apply_fn, JAX variables) of the same linear net."""
    rng = np.random.default_rng(seed)
    d = S * S * channels
    w = rng.normal(0, 1 / np.sqrt(d), (d, outputs)).astype(np.float32)
    f = rng.normal(0, 1 / np.sqrt(d), (d, dim)).astype(np.float32)

    def apply(v, x, train=False):
        flat = x.reshape(x.shape[0], -1)
        return flat @ v["w"], flat @ v["f"]

    return _Linear(w, f), apply, {"w": jnp.asarray(w), "f": jnp.asarray(f)}


def _images(n, seed, channels=3, side=S):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, channels), np.uint8)


def _feats(n, seed, d=8):
    return np.random.default_rng(seed).normal(0, 1, (n, d))


# -------------------------------------------------------------- on features


def test_frechet_entropy_and_binning_are_jaxs():
    xr, xg = _feats(40, 1), _feats(32, 2) + 0.3
    assert metrics.frechet_distance(xr, xg) == jmetrics.frechet_distance(xr, xg)
    assert metrics.frechet_distance(xr, xg, 1e-6) == jmetrics.frechet_distance(xr, xg, 1e-6)
    labels = np.random.default_rng(3).integers(0, 6, 50)
    for base in (None, 2.0):
        assert metrics.compute_entropy(labels, base) == jmetrics.compute_entropy(labels, base)
    raw = np.random.default_rng(4).uniform(-80, 80, 60).round(1)
    fake = np.random.default_rng(5).uniform(-90, 90, 30)
    for k in (1, 5, 49, 70):
        np.testing.assert_array_equal(bin_labels_to_classes(raw, k), jax_bin(raw, k))
        np.testing.assert_array_equal(bin_labels_to_classes(fake, k, ref=raw),
                                      jax_bin(fake, k, ref=raw))


@pytest.mark.parametrize("match_n,k", [(False, 3), (True, 5)])
def test_prdc_is_exact_on_given_features(match_n, k):
    real, fake = _feats(50, 6, 16), _feats(36, 7, 16) * 1.1 + 0.05
    got = metrics.compute_prdc(real, fake, nearest_k=k, match_n=match_n, seed=9)
    want = jmetrics.compute_prdc(real, fake, nearest_k=k, match_n=match_n, seed=9)
    assert got.keys() == want.keys()
    for key, value in want.items():  # the same counts; f32 means rounded in another order
        assert abs(got[key] - value) <= 1e-6, key
    assert 0 < got["precision"] <= 1 and 0 < got["recall"] <= 1


def test_intra_class_fid_on_given_features():
    xr, xg = _feats(60, 8), _feats(45, 9)
    cr, cg = np.repeat(np.arange(6), 10), np.random.default_rng(10).integers(0, 7, 45)
    got = metrics.intra_class_fid(None, None, cr, None, cg, feats_real=xr, feats_fake=xg)
    want = jmetrics.intra_class_fid(None, None, None, cr, None, cg, feats_real=xr,
                                    feats_fake=xg)
    assert got[:2] == want[:2] and got[2] == want[2] and len(got[2]) >= 4


@pytest.mark.parametrize("radius,num_centers", [(0.0, -1), (2.0, -1), (2.0, 4)])
def test_sliding_window_matches_jax(radius, num_centers):
    """The three branches of the centers (the unique fake labels; unit
    steps over [min + R, max - R]; num_centers evenly), on given features
    and predictions of the same nets; signed labels."""
    real_labels = np.repeat(np.arange(-6.0, 7.0), 5)
    fake_labels = np.repeat(np.arange(-6.0, 7.0, 2.0), 4)
    real, fake = _images(len(real_labels), 11), _images(len(fake_labels), 12)
    xr, xg = _feats(len(real), 13), _feats(len(fake), 14)
    ls, ls_apply, ls_v = _nets(15, 1)
    div, div_apply, div_v = _nets(16, 5)
    norm = lambda y: (np.asarray(y, float) + 6.0) / 12.0
    kw = dict(fid_radius=radius, num_centers=num_centers, max_label_after_shift=12.0,
              min_label_before_shift=-6.0, verbose=False, feats_real=xr, feats_fake=xg)
    got = sfid.sliding_window_eval(real, real_labels, fake, fake_labels, norm, None, ls, div,
                                   **kw)
    want = jsfid.sliding_window_eval(real, real_labels, fake, fake_labels, norm, None, None,
                                     ls_apply, ls_v, div_apply, div_v, **kw)
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(sfid.window_centers(real_labels, fake_labels, radius,
                                                      num_centers), want.centers)
    np.testing.assert_array_equal(got.num_real, want.num_real)
    np.testing.assert_allclose(got.fids, want.fids, rtol=1e-9)
    np.testing.assert_allclose(got.labelscores, want.labelscores, rtol=1e-5)
    np.testing.assert_array_equal(got.entropies, want.entropies)
    assert np.isfinite(got.fids).sum() >= 3
    assert got.sfid == pytest.approx(want.sfid, rel=1e-9)


def test_sliding_window_npz_has_jaxs_keys(tmp_path):
    res = sfid.SlidingWindowResult(np.arange(3.0), np.ones(3), np.zeros(3), np.ones(3),
                                   np.full(3, 4.0))
    jres = jsfid.SlidingWindowResult(np.arange(3.0), np.ones(3), np.zeros(3), np.ones(3),
                                     np.full(3, 4.0))
    res.save_npz(str(tmp_path / "port"))
    jres.save_npz(str(tmp_path / "jax"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------ through nets


def test_features_fid_labelscore_and_is_match_jax():
    """Through the nets, with a batch size that leaves a padded last chunk."""
    real, fake = _images(23, 17), _images(19, 18)
    net, apply, v = _nets(19, 5, dim=4)
    got = metrics.extract_features(net, real, batch_size=7)
    np.testing.assert_array_equal(got, metrics.extract_features(net, real, batch_size=23))
    want = jmetrics.extract_features(apply, v, real, batch_size=7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(metrics.cal_FID(net, real, fake, batch_size=7),
                               jmetrics.cal_FID(apply, v, real, fake, batch_size=7), rtol=1e-5)
    np.testing.assert_array_equal(metrics.predict_class_labels(net, fake, 6),
                                  jmetrics.predict_class_labels(apply, v, fake, 6))
    for splits in (1, 3):
        np.testing.assert_allclose(metrics.inception_score(net, fake, 5, 6, splits),
                                   jmetrics.inception_score(apply, v, fake, 5, 6, splits),
                                   rtol=1e-5, atol=1e-7)
    reg, reg_apply, reg_v = _nets(20, 1)
    assigned = np.random.default_rng(21).uniform(0, 1, len(fake))
    np.testing.assert_allclose(
        metrics.cal_labelscore(reg, fake, assigned, -80.0, 160.0, batch_size=5),
        jmetrics.cal_labelscore(reg_apply, reg_v, fake, assigned, -80.0, 160.0, batch_size=5),
        rtol=1e-5)


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _Spy(_Linear):
    """_Linear that keeps the TF32 settings each forward ran under."""

    seen: list

    def forward(self, x, train=False):
        self.seen.append(_tf32())
        return super().forward(x, train)


def test_eval_forwards_and_steps_run_without_tf32(monkeypatch):
    """PyTorch lets cuDNN use TF32 by default: the eval nets' forwards and
    training steps turn it off themselves, and give the caller's settings
    back."""
    from ccdm_tpu_torch.eval import train_backbones as tb

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    net, _, _ = _nets(24, 3, dim=4)
    spy = _Spy(net.w.detach().numpy(), net.f.detach().numpy())
    spy.seen = []
    images = _images(5, 25)
    metrics.extract_features(spy, images, batch_size=2)
    metrics.predict_class_labels(spy, images, 2)
    steps = []
    step = tb.ae_step
    monkeypatch.setattr(tb, "ae_step", lambda *a, **k: (steps.append(_tf32()), step(*a, **k))[1])
    tb.train_autoencoder(_images(4, 26, side=16), dim_bottleneck=8, ch=2, epochs=2)
    assert len(spy.seen) == 6 and len(steps) == 2
    assert set(spy.seen) | set(steps) == {(False, False)}
    assert _tf32() == (True, True)


# -------------------------------------------------------------------- NIQE


def test_niqe_fit_scores_and_npz_are_jaxs(tmp_path):
    real, fake = _images(12, 22, side=32), _images(5, 23, side=32)
    got = niqe.fit_niqe_model(real, patch=16, seed=1)
    want = jniqe.fit_niqe_model(real, patch=16, seed=1)
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.cov, want.cov)
    np.testing.assert_array_equal(niqe.niqe_score(fake, got), jniqe.niqe_score(fake, want))
    got.save(str(tmp_path / "port.npz"))
    want.save(str(tmp_path / "jax.npz"))
    crossed = (jniqe.NIQEModel.load(str(tmp_path / "port.npz")),
               niqe.NIQEModel.load(str(tmp_path / "jax.npz")))
    np.testing.assert_array_equal(jniqe.niqe_score(fake, crossed[0]),
                                  niqe.niqe_score(fake, crossed[1]))
    assert [niqe.default_patch_for(s) for s in (16, 64, 128, 192)] == \
        [jniqe.default_patch_for(s) for s in (16, 64, 128, 192)]


# --------------------------------------------------------------- analysis


def test_knn_frequency_and_tsne_fallback_match_jax(monkeypatch):
    real, fake = _images(30, 24, side=16), _images(10, 25, side=16)
    fr, ff = _feats(30, 26, 12), _feats(10, 27, 12)
    embed_port = lambda x: ff[:len(x)] if len(x) <= 10 else fr
    got = analysis.k_nearest_neighbors(fake, real, k=4, anchors=5, embed_fn=embed_port,
                                       real_features=fr)
    want = janalysis.k_nearest_neighbors(fake, real, k=4, anchors=5, embed_fn=embed_port,
                                         real_features=fr)
    assert got.shape == (5, 5, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(analysis.frequency_spectrum(real, fake),
                    janalysis.frequency_spectrum(real, fake)):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    for g, w in zip(analysis.tsne_embeds(fr, ff), janalysis.tsne_embeds(fr, ff)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_interpolation_and_sefa_match_jax():
    rng = np.random.default_rng(28)
    m = rng.normal(0, 1, (6, 12)).astype(np.float32)
    gen_j = lambda z, y: (z @ jnp.asarray(m) + y[:, :1]).reshape(len(z), 2, 2, 3)
    gen_t = lambda z, y: (z @ torch.from_numpy(m) + y[:, :1]).reshape(len(z), 2, 2, 3)
    z0, z1 = rng.normal(0, 1, (2, 6)).astype(np.float32)
    y0, y1 = np.float32([0.2, 0.0]), np.float32([0.8, 1.0])
    got = analysis.linear_interpolation(gen_t, *map(torch.from_numpy, (z0, z1, y0, y1)), 5)
    want = janalysis.linear_interpolation(gen_j, *map(jnp.asarray, (z0, z1, y0, y1)), 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    kernel = rng.normal(0, 1, (6, 10)).astype(np.float32)
    identity = lambda z, y: z.reshape(len(z), 1, 1, -1)
    got = analysis.semantic_factorization(identity, torch.from_numpy(kernel),
                                          torch.from_numpy(z0), torch.from_numpy(y0), 3)
    want = janalysis.semantic_factorization(identity, jnp.asarray(kernel), jnp.asarray(z0),
                                            jnp.asarray(y0), 3)
    assert got.shape == want.shape == (3, 8, 1, 1, 6)
    for a in range(3):  # each row walks z along its axis; the axis' sign is the SVD's
        step_g, step_w = got[a, -1] - got[a, 0], np.asarray(want)[a, -1] - np.asarray(want)[a, 0]
        sign = np.sign((step_g * step_w).sum())
        np.testing.assert_allclose(got[a] - got[a, 0], sign * (want[a] - want[a, 0]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[a, 0], want[a, 0], rtol=0, atol=1e-6)

"""Port parity of the H(y) covariance, offset noise, the Gaussian-Fourier
embedding and the CCDM recipe (resnet ILI + --use_Hy) end to end on the CPU.

The diffusion runs a small JAX Unet (dim 8, mults (1, 2), 16x16) and the
port's on the same converted weights, with JAX's draws handed to the port
(the loss's from split(key, 6): t, keep mask, noise, offset noise; the
sampler's initial noise from split(key)[0], unscaled: the port scales it by
sqrt(H(y)) itself). fn_y2cov is the sinusoidal y2cov embedding in both, with
hy_max_log 1.5 so that the cap engages (h = e + 1 reaches 2). Tolerances:
- hy_from_y2cov and convert_y_to_cov: rtol 1e-6 (one f32 exp), the layout
  exactly (the flat CHW output lands at [b, h, w, c]);
- q_sample with offset noise: 1e-6;
- loss and weighted_loss with use_Hy and offset noise: rtol 1e-5, as
  tests/test_torch_train.py holds them without;
- DDIM with use_Hy: 1e-3 ([0, 1] images, as tests/test_torch_sampling.py);
- the gaussian embeddings with JAX's W: 1e-5 (sin and cos of arguments up
  to a few hundred radians, formed in the same f32 order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.diffusion.gaussian import hy_from_y2cov as jax_hy_from_y2cov
from ccdm_tpu.embedding.analytic import make_fn_y2cov as jax_make_fn_y2cov
from ccdm_tpu.embedding.analytic import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.ops import make_schedule as jax_make_schedule
from ccdm_tpu.ops import q_sample as jax_q_sample
from ccdm_tpu_torch import main as port_main
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion, hy_from_y2cov
from ccdm_tpu_torch.embedding.analytic import make_fn_y2cov, make_fn_y2h
from ccdm_tpu_torch.embedding.resolve import build_label_embedding
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.ops.schedule import make_schedule, q_sample
from ccdm_tpu_torch.serve import SamplerService
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)

CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)
COV_DIM = 3 * 16 * 16
HY = dict(image_size=16, channels=3, use_Hy=True, hy_max_log=1.5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def variables():
    """Random variables in the JAX Unet's tree, drawn without compiling."""
    model = JaxUnet(**CFG)
    shapes = jax.eval_shape(lambda key: model.init(
        key, jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 128)),
        None, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "bias" in name or "mean" in name or "null" in name:
            a = rng.normal(0, 0.2, shape)
        else:
            a = 1 + rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(variables, **cfg):
    """(JAX diffusion, port diffusion) on the same weights, each with its
    package's sinusoidal fn_y2cov."""
    jdiff = JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**cfg),
                                 fn_y2cov=jax_make_fn_y2cov(COV_DIM))
    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    return jdiff, GaussianDiffusion(model, DiffusionConfig(**cfg),
                                    fn_y2cov=make_fn_y2cov(COV_DIM))


# ------------------------------------------------------------------ H(y)


@pytest.mark.parametrize("max_log", [4.0, 1.5, 0.0])
def test_hy_from_y2cov_matches_jax(max_log):
    h = np.random.default_rng(0).normal(0, 3, (4, 100)).astype(np.float32)
    want = np.asarray(jax_hy_from_y2cov(jnp.asarray(h), max_log))
    got = hy_from_y2cov(_t(h), max_log).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if max_log > 0:
        assert got.min() >= np.float32(np.exp(-max_log)) * (1 - 1e-6)


def test_convert_y_to_cov_matches_jax_nhwc():
    """fn_y2cov's flat output is CHW: element c*H*W + h*W + w goes to
    [b, h, w, c], as JAX transposes it."""
    flat = lambda y, xp: xp.reshape(y, (-1, 1)) * 0.5 + xp.arange(COV_DIM) / COV_DIM
    cfg = dict(image_size=16, channels=3, use_Hy=True, hy_max_log=0.0)
    jdiff = JaxGaussianDiffusion(None, JaxDiffusionConfig(**cfg),
                                 fn_y2cov=lambda y: flat(y, jnp).astype(jnp.float32))
    port = GaussianDiffusion(None, DiffusionConfig(**cfg),
                             fn_y2cov=lambda y: flat(y, torch).float())
    y = np.array([[0.2], [0.9]], np.float32)
    want = np.asarray(jdiff.convert_y_to_cov(jnp.asarray(y)))
    got = port.convert_y_to_cov(_t(y)).numpy()
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    c, h, w = 2, 5, 7
    np.testing.assert_allclose(got[1, h, w, c], np.exp(-(0.45 + (c * 256 + h * 16 + w) / 768)),
                               rtol=1e-6)


def test_use_hy_needs_fn_y2cov():
    with pytest.raises(ValueError, match="fn_y2cov"):
        GaussianDiffusion(None, DiffusionConfig(image_size=16, use_Hy=True))


def test_q_sample_with_offset_noise_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    offset = rng.normal(size=(3, 2)).astype(np.float32)
    t = np.array([0, 50, 99])
    want = jax_q_sample(jax_make_schedule(100), jnp.asarray(x0), jnp.asarray(t),
                        jnp.asarray(noise), 0.1, jnp.asarray(offset))
    got = q_sample(make_schedule(100), _t(x0), _t(t), _t(noise), 0.1, _t(offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    plain = q_sample(make_schedule(100), _t(x0), _t(t), _t(noise))
    assert float((got - plain).abs().min()) > 0


@pytest.mark.parametrize("objective,weighted", [("pred_noise", False), ("pred_x0", False),
                                                ("pred_noise", True)])
def test_loss_with_hy_and_offset_noise_matches_jax(variables, objective, weighted):
    """loss adds offset noise (strength 0.1), weighted_loss ignores it; both
    scale the kept rows' noise by sqrt(H(y)) and divide their loss by H(y)."""
    rng = np.random.default_rng(2)
    b = 8
    images01 = rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)
    labels = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    emb = rng.uniform(0, 1, (b, 128)).astype(np.float32)
    weights = rng.uniform(0, 1, b).astype(np.float32)
    cfg = dict(**HY, timesteps=100, objective=objective, vicinity_type="hv",
               cond_drop_prob=0.5, offset_noise_strength=0.1)
    jd, td = _pair(variables, **cfg)
    key = jax.random.PRNGKey(6)
    args = (variables, key, jnp.asarray(images01), jnp.asarray(labels), jnp.asarray(emb))
    if weighted:
        want, _ = jax.jit(lambda *a: jd.weighted_loss(*a, train=True))(*args, jnp.asarray(weights))
        k_t, k_mask, k_noise = jax.random.split(key, 3)
    else:
        want, _ = jax.jit(lambda *a: jd.loss(*a, vicinal_weights=jnp.ones(b), kappa=0.2,
                                             train=True))(*args)
        k_t, k_mask, k_noise, _, k_offset, _ = jax.random.split(key, 6)
    draws = {"t": _t(jax.random.randint(k_t, (b,), 0, 100)),
             "keep_mask": _t(jax.random.uniform(k_mask, (b,)) < 0.5),
             "noise": _t(jax.random.normal(k_noise, images01.shape))}
    assert 0 < int(draws["keep_mask"].sum()) < b
    if weighted:
        got = td.weighted_loss(_t(images01), _t(labels), _t(emb), _t(weights), draws=draws)
    else:
        draws["offset"] = _t(jax.random.normal(k_offset, (b, 3)))
        got = td.loss(_t(images01), _t(labels), _t(emb), vicinal_weights=torch.ones(b),
                      kappa=0.2, draws=draws)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_ddim_sample_with_hy_matches_jax(variables):
    """5 DDIM steps, CFG 1.5, pred_x0: the initial noise times sqrt(H(y))."""
    cfg = dict(**HY, timesteps=100, sampling_timesteps=5, objective="pred_x0")
    jdiff, port = _pair(variables, **cfg)
    labels = np.array([[0.1], [0.8]], np.float32)
    labels_emb = np.random.default_rng(3).uniform(size=(2, 128)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(lambda v, k, e, y: jdiff.ddim_sample(
        v, k, e, labels=y, cond_scale=1.5))(variables, key, labels_emb, labels))
    noise = _t(jax.random.normal(jax.random.split(key)[0], (2, 16, 16, 3)))
    got = port.ddim_sample(_t(labels_emb), cond_scale=1.5, noise=noise, labels=_t(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    unscaled = port.ddim_sample(_t(labels_emb), cond_scale=1.5, noise=noise)
    assert float((unscaled - got).abs().max()) > 1e-2


# ------------------------------------------------------ gaussian embedding


def test_gaussian_embeddings_take_jax_w(tmp_path):
    """With JAX's W written where the milestone converter writes it, the
    port's gaussian y2h and y2cov equal JAX's; without one, a run draws W
    from a seeded generator and writes it, and a load-only consumer reads
    that same W."""
    import argparse
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch",
        Path(__file__).resolve().parents[1] / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = argparse.Namespace(dim_embed=128, y2h_embed_type="gaussian",
                              y2cov_embed_type="gaussian", use_Hy=True, image_size=16,
                              num_channels=3, device="cpu")
    written = script.convert_embed_models(str(tmp_path / "none"), str(tmp_path / "embed_models"),
                                          args)
    assert len(written) == 2
    fn_y2h, fn_y2cov = build_label_embedding(args, str(tmp_path), bundle=None,
                                             require_cached=True)
    y = np.linspace(0.0, 1.0, 5).astype(np.float32)
    np.testing.assert_allclose(fn_y2h(_t(y)).numpy(),
                               np.asarray(jax_make_fn_y2h(128, "gaussian")(jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fn_y2cov(_t(y)).numpy(),
                               np.asarray(jax_make_fn_y2cov(COV_DIM, "gaussian")(jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)

    fresh = tmp_path / "fresh"
    bundle = argparse.Namespace(label_dim=1, channels=3, image_size=16)
    drawn, _ = build_label_embedding(args, str(fresh), bundle=bundle)
    assert sorted(p.name for p in (fresh / "embed_models").iterdir()) == [
        "gaussian_W-y2cov_d768_seed2024.pt", "gaussian_W-y2h_d128_seed2023.pt"]
    served, _ = build_label_embedding(args, str(fresh), bundle=None, require_cached=True)
    torch.testing.assert_close(served(_t(y)), drawn(_t(y)), rtol=0, atol=0)
    assert make_fn_y2h(128, "gaussian", W=torch.ones(1, 64))(_t(y)).shape == (5, 128)


# ------------------------------------------------------ the recipe, end to end


MODEL = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
         "--train_timesteps", "20", "--pred_objective", "pred_x0", "--device", "cpu",
         "--use_Hy", "--y2h_embed_type", "resnet", "--y2cov_embed_type", "resnet",
         "--hy_max_log", "4.0", "--epoch_cnn_embed", "1", "--epoch_net_y2h", "2",
         "--epoch_cnn_embed_y2cov", "1", "--epoch_net_y2cov", "2", "--batch_size_embed", "32"]


def test_ccdm_recipe_trains_samples_and_serves_on_the_cpu(tmp_path):
    """main.py with resnet ILI and --use_Hy trains both ILI stages for y2h
    and y2cov into the setting folder's embed_models/, 3 steps, the sampling
    after training; SamplerService loads that cache and serves; a service
    without the cache raises FileNotFoundError."""
    root = str(tmp_path / "run")
    argv = ["--root_path", root, *MODEL, "--data_name", "synthetic", "--synthetic_n", "64",
            "--train_batch_size", "8", "--vicinity_type", "hv", "--niters", "3",
            "--save_every", "3", "--log_every", "1", "--eval_mode", "4",
            "--FID_num_centers", "2", "--nfake_per_label", "2", "--sample_timesteps", "2"]
    trainer = port_main.main(argv)
    results = port_main.results_folder(parse_opts(argv))
    embed = sorted(p.name for p in (tmp_path / "run" / "output" / "synthetic_16" / "Setup1"
                                    / "embed_models").iterdir())
    assert embed == ["datafp-y2cov_d768_e1_m2_seed111.txt", "datafp-y2h_d128_e1_m2_seed111.txt",
                     "model-y2cov_d768_e1_m2_seed111", "model-y2h_d128_e1_m2_seed111"]
    assert trainer.state.step == 3 and trainer.diffusion.config.use_Hy
    pngs = list((tmp_path / "run").rglob("fake_data_*/sample_*.png"))
    assert len(pngs) == 2 and os.path.isdir(os.path.join(results, "model-3"))

    serve_argv = ["--root_path", root, *MODEL, "--serve_milestone", "3",
                  "--sample_timesteps", "2"]
    service = SamplerService(parse_opts(serve_argv), max_batch=2, warm=False, device="cpu")
    probe = torch.tensor([[0.2], [0.7]])
    torch.testing.assert_close(service.diffusion.fn_y2cov(probe),
                               trainer.diffusion.fn_y2cov(probe), rtol=0, atol=0)
    images = service.generate(np.array([0.2, 0.7], np.float32))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)

    with pytest.raises(FileNotFoundError, match="y2h"):
        SamplerService(parse_opts(["--root_path", str(tmp_path / "empty"), *MODEL]),
                       warm=False, device="cpu")
    assert not (tmp_path / "empty").exists()

"""Port parity of the sampling slice: CFG++, the ancestral sampler, DDIM with
eta > 0, q_posterior, the eval label grid and the PNG grid writer.

The samplers run a small JAX Unet (dim 8, mults (1, 2), 16x16) and the port's
on the same converted weights, with JAX's own draws handed to the port: the
initial noise from split(key)[0], step i's noise from
split(split(key)[1], S)[i]. The [0, 1] images agree to 1e-3 in f32 (guided
UNet passes of f32 arithmetic in another order, as tests/test_torch_serve.py
bounds DDIM). model_predictions under CFG++ is held to 1e-3 as that file
holds it without (pred_noise divides by sqrt(1/ac - 1)); q_posterior to 1e-6
(three f32 products); get_eval_labels exactly; the PNG pixel for pixel.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu_torch.data.datasets import DatasetBundle
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.main import get_eval_labels
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops.schedule import make_schedule, q_posterior
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax
from ccdm_tpu_torch.utils.viz import save_image_grid

torch.set_num_threads(2)

CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)


def _jax_variables(seed=0):
    """Random variables in the JAX Unet's tree, drawn without compiling."""
    model = JaxUnet(**CFG)
    shapes = jax.eval_shape(lambda key: model.init(
        key, jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 128)),
        None, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

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
    """(JAX diffusion, port diffusion) on the same weights."""
    jdiff = JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**cfg))
    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    return jdiff, GaussianDiffusion(model, DiffusionConfig(**cfg))


def _jax_draws(key, shape, steps):
    """The draws of JAX's samplers: (initial noise, [S, *shape] step noise)."""
    k_init, k_scan = jax.random.split(key)
    keys = jax.random.split(k_scan, steps)
    return (np.array(jax.random.normal(k_init, shape)),
            np.stack([np.array(jax.random.normal(k, shape)) for k in keys]))


@pytest.fixture(scope="module")
def variables():
    return _jax_variables(3)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_cfg_plus_plus_matches_jax_and_changes_the_noise(variables, objective):
    cfg = dict(image_size=16, channels=3, timesteps=100, objective=objective)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([10, 90])
    emb = rng.uniform(size=(2, 128)).astype(np.float32)
    jdiff, _ = _pair(variables, **cfg, use_cfg_plus_plus=True)
    want = jax.jit(lambda v, *a: jdiff.model_predictions(v, *a, cond_scale=1.5,
                                                         clip_x_start=True))(
        variables, x, t, emb)
    _, port = _pair(variables, **cfg, use_cfg_plus_plus=True)
    _, plain = _pair(variables, **cfg)
    args = tuple(map(torch.from_numpy, (x, t, emb)))
    with torch.no_grad():
        got = port.model_predictions(*args, cond_scale=1.5, clip_x_start=True)
        without = plain.model_predictions(*args, cond_scale=1.5, clip_x_start=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[1], without[1], rtol=0, atol=0)  # x_start stays guided
    assert float((got[0] - without[0]).abs().max()) > 1e-2  # the noise is the null branch's


def test_ddpm_p_sample_loop_matches_jax_with_its_draws(variables):
    """10 ancestral steps (t = 9..0 of a T-20 schedule, the JAX package's
    unrespaced semantics), CFG 1.5, pred_x0."""
    cfg = dict(image_size=16, channels=3, timesteps=20, objective="pred_x0")
    labels_emb = np.random.default_rng(5).uniform(size=(3, 128)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jdiff, port = _pair(variables, **cfg)
    want = np.asarray(jax.jit(lambda v, k, e: jdiff.p_sample_loop(
        v, k, e, cond_scale=1.5, sampling_timesteps=10))(variables, key, labels_emb))
    noise, steps = _jax_draws(key, (3, 16, 16, 3), 10)
    got = port.p_sample_loop(torch.from_numpy(labels_emb), cond_scale=1.5, sampling_timesteps=10,
                             noise=torch.from_numpy(noise), step_noise=torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    same = port.sample(torch.from_numpy(labels_emb), cond_scale=1.5, sampling_timesteps=10,
                       noise=torch.from_numpy(noise), step_noise=torch.from_numpy(steps))
    torch.testing.assert_close(same, got, rtol=0, atol=0)


@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise"])
def test_ddim_with_eta_matches_jax_with_its_draws(variables, objective):
    cfg = dict(image_size=16, channels=3, timesteps=100, sampling_timesteps=5,
               objective=objective)
    labels_emb = np.random.default_rng(6).uniform(size=(2, 128)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jdiff, port = _pair(variables, **cfg)
    want = np.asarray(jax.jit(lambda v, k, e: jdiff.ddim_sample(
        v, k, e, cond_scale=1.5, ddim_eta=0.3))(variables, key, labels_emb))
    noise, steps = _jax_draws(key, (2, 16, 16, 3), 5)
    got = port.ddim_sample(torch.from_numpy(labels_emb), cond_scale=1.5, ddim_eta=0.3,
                           noise=torch.from_numpy(noise), step_noise=torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="step_noise"):
        port.ddim_sample(torch.from_numpy(labels_emb), ddim_eta=0.3,
                         step_noise=torch.from_numpy(steps[:4]))


def test_q_posterior_matches_jax():
    from ccdm_tpu.ops.schedule import make_schedule as jax_make_schedule
    from ccdm_tpu.ops.schedule import q_posterior as jax_q_posterior

    rng = np.random.default_rng(7)
    x0, xt = (rng.normal(size=(4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 500, 999])
    want = jax_q_posterior(jax_make_schedule(1000, "cosine"), jnp.asarray(x0), jnp.asarray(xt),
                           jnp.asarray(t))
    got = q_posterior(make_schedule(1000, "cosine"), *map(torch.from_numpy, (x0, xt, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,centers", [(1, -1), (2, -1), (3, -1), (4, 5), (4, -1)])
@pytest.mark.parametrize("unseen", [True, False])
def test_get_eval_labels_exact(mode, centers, unseen):
    from ccdm_tpu.main import get_eval_labels as jax_get_eval_labels

    train = np.array([3.0, 1.0, 3.0, 7.0, 5.0])
    raw = np.array([1.0, 2.0, 3.0, 5.0, 7.0, 9.0]) if unseen else np.array([7.0, 1.0, 3.0, 5.0])
    bundle = DatasetBundle("x", np.zeros((5, 4, 4, 1), np.uint8), train, train / 10,
                           lambda y: y, lambda y: y, eval_labels_raw=raw)
    args = types.SimpleNamespace(eval_mode=mode, FID_num_centers=centers)
    got, want = get_eval_labels(bundle, args), jax_get_eval_labels(bundle, args)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("n,c", [(8, 3), (6, 1), (36, 3)])
def test_png_grid_matches_pil_and_the_jax_writer(tmp_path, n, c):
    from PIL import Image

    from ccdm_tpu.utils.viz import save_image_grid as jax_save_image_grid

    images = np.random.default_rng(n).uniform(-0.1, 1.1, (n, 9, 7, c)).astype(np.float32)
    save_image_grid(images, str(tmp_path / "port.png"), nrow=6)
    jax_save_image_grid(images, str(tmp_path / "jax.png"), nrow=6)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == want.shape == ((n + 5) // 6 * 10 + 1, 6 * 8 + 1, 3)[: 3 if c == 3 else 2]
    np.testing.assert_array_equal(got, want)

"""Port parity of the whole serving slice, and the port's HTTP service.

The JAX sampler (`GaussianDiffusion.ddim_sample`, CFG with cond_scale 1.5
and rescaled_phi 0.7, pred_x0, cosine T 100, 5 DDIM steps) and the port's
run on the same converted weights and the same initial noise, drawn as the
JAX sampler draws it and handed to the port. The [0, 1] images must agree
to 1e-3 in f32: five guided UNet passes of f32 arithmetic in another order.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.opts import parse_opts
from ccdm_tpu_torch.serve import SamplerService, serve
from ccdm_tpu_torch.training.trainer import sample_given_labels
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)

CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)
SMALL_ARGV = ["--image_size", "16", "--model_channels", "8", "--channel_mult", "1_2",
              "--train_timesteps", "20", "--sample_timesteps", "2",
              "--pred_objective", "pred_x0", "--device", "cpu"]


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


def test_ddim_sampler_matches_jax():
    variables = _jax_variables()
    cfg = dict(image_size=16, channels=3, timesteps=100, sampling_timesteps=5,
               objective="pred_x0", beta_schedule="cosine")
    labels = np.array([0.1, 0.5, 0.9], np.float32)
    key = jax.random.PRNGKey(7)

    jdiff = JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**cfg))
    jemb = jax_make_fn_y2h(128)(jnp.asarray(labels))
    want = np.asarray(jax.jit(lambda v, k, e: jdiff.ddim_sample(v, k, e, cond_scale=1.5))(
        variables, key, jemb))
    k_init, _ = jax.random.split(key)  # as ddim_sample draws its initial image
    noise = np.array(jax.random.normal(k_init, (3, 16, 16, 3)))

    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    diffusion = GaussianDiffusion(model, DiffusionConfig(**cfg))
    got = diffusion.ddim_sample(make_fn_y2h(128)(torch.from_numpy(labels)), cond_scale=1.5,
                                noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_v"])
def test_guided_predictions_match_jax(objective):
    """model_predictions (2B CFG forward + apply_cfg + the objective's
    conversions) for the objectives the DDIM test above does not take."""
    variables = _jax_variables(1)
    cfg = dict(image_size=16, channels=3, timesteps=100, objective=objective)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([10, 90])
    emb = rng.uniform(size=(2, 128)).astype(np.float32)
    jdiff = JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**cfg))
    want = jax.jit(lambda v, *a: jdiff.model_predictions(v, *a, cond_scale=1.5,
                                                         clip_x_start=True))(
        variables, x, t, emb)
    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    with torch.no_grad():
        got = GaussianDiffusion(model, DiffusionConfig(**cfg)).model_predictions(
            *map(torch.from_numpy, (x, t, emb)), cond_scale=1.5, clip_x_start=True)
    for g, w in zip(got, want):  # pred_noise divides by sqrt(1/ac - 1): 1e-3
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)


def _small_diffusion():
    model = Unet(**CFG, seed=1)
    return GaussianDiffusion(model, DiffusionConfig(image_size=16, timesteps=20,
                                                    objective="pred_x0"))


def test_sample_given_labels_pads_and_seeds():
    diffusion, fn = _small_diffusion(), make_fn_y2h(128)
    labels = np.array([0.1, 0.3, 0.5, 0.7, 0.9], np.float32)
    run = lambda key, **kw: sample_given_labels(diffusion, labels, fn, batch_size=2,
                                                cond_scale=1.5, sample_timesteps=2,
                                                key_base=key, **kw)[0]
    a, b, c = run(1), run(1), run(2)
    assert a.dtype == np.uint8 and a.shape == (5, 16, 16, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    floats = run(1, denorm=False)
    assert floats.dtype == np.float32 and floats.min() >= 0 and floats.max() <= 1
    with pytest.raises(ValueError, match="normalized"):
        sample_given_labels(diffusion, np.array([1.5]), fn, batch_size=2)


def test_ddim_with_eta_draws_from_the_generator():
    diffusion = _small_diffusion()
    emb = make_fn_y2h(128)(torch.tensor([0.3, 0.6]))
    run = lambda seed, eta: diffusion.ddim_sample(
        emb, cond_scale=1.5, sampling_timesteps=3, ddim_eta=eta,
        generator=torch.Generator().manual_seed(seed))
    a, b, c, d = run(0, 1.0), run(0, 1.0), run(1, 1.0), run(0, 0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert bool(torch.isfinite(a).all())


def _request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_service_round_trip_and_shutdown():
    args = parse_opts(SMALL_ARGV)
    model = Unet(**CFG, seed=5)
    service = SamplerService(args, max_batch=2, max_labels=4, device="cpu",
                             state_dict=model.state_dict())
    served = service.diffusion.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in model.state_dict().items())
    httpd = serve(service, 0, host="127.0.0.1", block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _request(url + "/healthz") == (200, {"status": "ok", "warm": True,
                                                    "milestone": None})
        code, reply = _request(url + "/generate", {"labels": [0.2, 0.4, 0.6], "seed": 3})
        assert code == 200 and reply["labels"] == pytest.approx([0.2, 0.4, 0.6])
        images = np.load(io.BytesIO(base64.b64decode(reply["images_b64"])))["images"]
        assert images.dtype == np.uint8 and images.shape == (3, 16, 16, 3)
        np.testing.assert_array_equal(images, service.generate(np.array([0.2, 0.4, 0.6]),
                                                               seed=3))
        assert _request(url + "/generate", {"labels": [0.5, 1.5]})[0] == 400
        assert _request(url + "/generate", {"labels": [0.5] * 5})[0] == 400
        assert _request(url + "/generate", {"seed": 1})[0] == 400
        assert _request(url + "/nowhere")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()

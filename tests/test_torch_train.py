"""Port parity of the training slice.

Tolerances, each with its reason:
- ema_decay_value: exact (the same f32 operations);
- ema_update over 150 steps: 1e-7 (the same f32 blend, rounded alike);
- train-mode BatchNorm outputs and running statistics against flax: 1e-6;
- `loss` and `weighted_loss` with JAX's draws handed in (hv, sv, shv with
  sliced weights, none): rtol 1e-5, a small UNet's f32 forward in another
  framework;
- one whole train step against the JAX Trainer's jitted step at f32 (UNet
  dim 8, mults (1, 2), 64x64, so that the top level, N 4096, takes the
  two-pass attention path; synthetic data, batch 16, 2 accumulation steps):
  loss rtol 1e-5, each gradient leaf within 1e-3 of its largest |g| (the
  port's two-pass attention backward against jax.vjp of the plain block),
  the BatchNorm statistics it moved to 1e-5.
  Two leaves are held to 1e-3 of the model's largest |g| instead: the
  biases of cond_dense_1 and cond_dense_2 feed a train-mode BatchNorm, which
  subtracts them out, so their gradient is zero in exact arithmetic and
  both frameworks return rounding noise there;
- clip + Adam + EMA applied to identical gradients from a state carried
  across mid-training (past ema_update_after_step): 1e-6.
The JAX draws are re-derived from the key with JAX's own split order:
train_step split(key, acc) -> loss_fn split(k) -> _make_batch
split(k_batch, 3) and loss split(k_loss, 6).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from ccdm_tpu.data.datasets import make_synthetic
from ccdm_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from ccdm_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from ccdm_tpu.embedding import make_fn_y2h as jax_make_fn_y2h
from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.training import Trainer as JaxTrainer
from ccdm_tpu.training import TrainerConfig as JaxTrainerConfig
from ccdm_tpu.training import state as jstate
from ccdm_tpu.training.vicinity import _gumbel
from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from ccdm_tpu_torch.embedding.analytic import make_fn_y2h
from ccdm_tpu_torch.models.layers import flax_batch_norm
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.training import state as tstate
from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig
from ccdm_tpu_torch.utils.convert import (
    train_state_from_jax,
    unet_state_dict_from_jax,
)

torch.set_num_threads(2)

CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _jax_variables(image_size, seed=0):
    """Random variables in the JAX Unet's tree (shapes from eval_shape):
    kernels scaled by 1/sqrt(fan-in), biases, gains and BatchNorm
    statistics away from their initial values."""
    shapes = jax.eval_shape(lambda key: JaxUnet(**CFG).init(
        key, jnp.zeros((2, image_size, image_size, 3)), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 128)), None, train=False), jax.random.PRNGKey(0))
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


def _port_model(variables, image_size):
    model = Unet(**CFG)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    return model.to(memory_format=torch.channels_last)


# ------------------------------------------------------------------- EMA


def test_ema_decay_value_exact():
    cfg_j = jstate.EmaConfig(beta=0.995, update_after_step=100, update_every=10)
    cfg_t = tstate.EmaConfig(beta=0.995, update_after_step=100, update_every=10)
    want = np.asarray(jax.vmap(lambda s: jstate.ema_decay_value(s, cfg_j))(jnp.arange(301)))
    got = np.array([float(tstate.ema_decay_value(s, cfg_t)) for s in range(301)], np.float32)
    np.testing.assert_array_equal(got, want)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 4))
        self.bn = torch.nn.BatchNorm1d(4)


def test_ema_update_150_steps():
    rng = np.random.default_rng(0)
    cfg_j = jstate.EmaConfig(beta=0.995, update_after_step=100, update_every=10)
    cfg_t = tstate.EmaConfig(beta=0.995, update_after_step=100, update_every=10)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params={"w": jnp.asarray(w0)},
                           batch_stats={"mean": jnp.zeros(4), "var": jnp.ones(4)},
                           opt_state=(), ema_step=jnp.zeros((), jnp.int32),
                           ema_params={"w": jnp.asarray(w0)},
                           ema_batch_stats={"mean": jnp.zeros(4), "var": jnp.ones(4)})
    model = _Tiny()
    model.w.data.copy_(torch.from_numpy(w0))
    ts = tstate.create_train_state(model)
    for _ in range(150):
        w = rng.normal(size=(3, 4)).astype(np.float32)
        m, v = rng.normal(size=4).astype(np.float32), rng.uniform(0.5, 2, 4).astype(np.float32)
        js = js.replace(params={"w": jnp.asarray(w)},
                        batch_stats={"mean": jnp.asarray(m), "var": jnp.asarray(v)})
        js = jstate.ema_update(js, cfg_j)
        model.w.data.copy_(torch.from_numpy(w))
        model.bn.running_mean.copy_(torch.from_numpy(m))
        model.bn.running_var.copy_(torch.from_numpy(v))
        tstate.ema_update(ts, cfg_t)
    assert ts.ema_step == int(js.ema_step) == 150
    for got, want in ((ts.ema_model.w, js.ema_params["w"]),
                      (ts.ema_model.bn.running_mean, js.ema_batch_stats["mean"]),
                      (ts.ema_model.bn.running_var, js.ema_batch_stats["var"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-7, atol=1e-7)


# ------------------------------------------------------------- BatchNorm


def test_train_mode_batch_norm_matches_flax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(16, 8)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    mean0, var0 = rng.normal(size=8).astype(np.float32), rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = torch.nn.BatchNorm1d(8, eps=1e-5)
    with torch.no_grad():
        tbn.weight.copy_(_t(scale)), tbn.bias.copy_(_t(bias))
        tbn.running_mean.copy_(_t(mean0)), tbn.running_var.copy_(_t(var0))
    got = flax_batch_norm(tbn, _t(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ loss


def _loss_draws(k_loss, b, shape, cond_drop_prob, timesteps, d=1, m=1):
    """The draws of GaussianDiffusion.loss(key=k_loss) (gaussian.py:163)."""
    k_t, k_mask, k_noise, _, _, k_proj = jax.random.split(k_loss, 6)
    draws = {"t": _t(jax.random.randint(k_t, (b,), 0, timesteps)),
             "keep_mask": _t(jax.random.uniform(k_mask, (b,)) < (1.0 - cond_drop_prob)),
             "noise": _t(jax.random.normal(k_noise, shape))}
    if d > 1:
        draws["proj"] = _t(jax.random.normal(k_proj, (m, d)))
    return draws


@pytest.mark.parametrize("vtype,d,weighted", [("hv", 1, False), ("sv", 1, False),
                                              ("shv", 3, False), ("none", 1, False),
                                              ("hv", 1, True)])
def test_loss_with_jax_draws(vtype, d, weighted):
    variables = _jax_variables(16, seed=2)
    rng = np.random.default_rng(3)
    b = 8
    images01 = rng.uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)
    labels = rng.uniform(0, 1, (b, d)).astype(np.float32)
    emb = rng.uniform(0, 1, (b, 128)).astype(np.float32)
    weights = rng.uniform(0, 1, b).astype(np.float32)
    kw = dict(image_size=16, channels=3, timesteps=100, objective="pred_x0",
              vicinity_type=vtype, num_projections=4, cond_drop_prob=0.3)
    jd = JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**kw))
    key = jax.random.PRNGKey(5)
    if weighted:
        want, upd = jax.jit(lambda *a: jd.weighted_loss(*a, train=True))(
            variables, key, jnp.asarray(images01), jnp.asarray(labels), jnp.asarray(emb),
            jnp.asarray(weights))
        k_t, k_mask, k_noise = jax.random.split(key, 3)
        draws = {"t": _t(jax.random.randint(k_t, (b,), 0, 100)),
                 "keep_mask": _t(jax.random.uniform(k_mask, (b,)) < 0.7),
                 "noise": _t(jax.random.normal(k_noise, images01.shape))}
    else:
        want, upd = jax.jit(lambda *a: jd.loss(*a, vicinal_weights=jnp.ones(b), kappa=0.2,
                                               train=True))(
            variables, key, jnp.asarray(images01), jnp.asarray(labels), jnp.asarray(emb))
        draws = _loss_draws(key, b, images01.shape, 0.3, 100, d, 4)
    model = _port_model(variables, 16)
    td = GaussianDiffusion(model, DiffusionConfig(**kw))
    if weighted:
        got = td.weighted_loss(_t(images01), _t(labels), _t(emb), _t(weights), draws=draws)
    else:
        got = td.loss(_t(images01), _t(labels), _t(emb), vicinal_weights=torch.ones(b),
                      kappa=0.2, draws=draws)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(model.cond_bn_2.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["cond_bn_2"]["var"]),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- whole train step


BN_FED_BIASES = ("cond_dense_1.bias", "cond_dense_2.bias")


def _recording_tx():
    """An optax transformation whose new state is the gradient it got."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def train_setup():
    bundle = make_synthetic(n=64, image_size=64, channels=3, seed=0)
    variables = _jax_variables(64, seed=4)
    kw = dict(image_size=64, channels=3, timesteps=1000, objective="pred_x0",
              vicinity_type="hv", cond_drop_prob=0.5)
    tkw = dict(data_name="synthetic", train_batch_size=16, gradient_accumulate_every=2,
               vicinity_type="hv")
    jtrainer = JaxTrainer(JaxGaussianDiffusion(JaxUnet(**CFG).apply, JaxDiffusionConfig(**kw)),
                          variables, bundle.images, bundle.labels_norm,
                          JaxTrainerConfig(results_folder="/tmp/_unused_ccdm_results", **tkw))
    model = _port_model(variables, 64)
    ttrainer = Trainer(GaussianDiffusion(model, DiffusionConfig(**kw)), bundle.images,
                       bundle.labels_norm, TrainerConfig(**tkw))
    return bundle, variables, jtrainer, ttrainer


def _step_draws(key, jtrainer, n_images, acc=2, b=16):
    """The draws of every micro-batch of JaxTrainer's step(state, key)."""
    draws = []
    for k in jax.random.split(key, acc):
        k_batch, k_loss = jax.random.split(k)
        k_target, k_select, _ = jax.random.split(k_batch, 3)
        k_pick, k_noise = jax.random.split(k_target)
        d = {"target_idx": _t(jax.random.randint(k_pick, (b,), 0,
                                                 jtrainer.unique_labels.shape[0])),
             "target_eps": _t(jax.random.normal(k_noise, (b, 1))),
             "gumbel": _t(_gumbel(k_select, (b, n_images)))}
        d.update(_loss_draws(k_loss, b, (b, 64, 64, 3), 0.5, 1000))
        draws.append(d)
    return draws


def test_train_step_matches_jax_trainer(train_setup):
    bundle, variables, jtrainer, ttrainer = train_setup
    jtrainer.tx = _recording_tx()
    jtrainer.state = jtrainer.state.replace(opt_state=jtrainer.tx.init(jtrainer.state.params))
    step = jtrainer._build_train_step(jax_make_fn_y2h(128))
    key = jax.random.PRNGKey(9)
    new_state, jloss = step(jtrainer.state, key)
    jgrads = jax.device_get(new_state.opt_state)

    loss, grads = ttrainer.compute_grads(make_fn_y2h(128),
                                         draws=_step_draws(key, jtrainer, len(bundle.images)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    model = ttrainer.state.model
    want = unet_state_dict_from_jax({"params": jgrads,
                                     "batch_stats": jax.device_get(new_state.batch_stats)}, model)
    largest = max(float(want[name].abs().max()) for name, _ in model.named_parameters())
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        scale = largest if name in BN_FED_BIASES else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale, err_msg=name)
    # the BatchNorm statistics moved once per micro-batch; 1e-5: cond_bn_2's
    # input comes through cond_bn_1, whose variance mean(x^2) - mean(x)^2
    # cancels, so the frameworks' f32 reduction orders differ by ~4e-6 there
    for name, buf in model.named_buffers():
        if buf.is_floating_point():
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_clip_adam_ema_on_identical_grads(grad_scale):
    variables = _jax_variables(16, seed=6)
    rng = np.random.default_rng(7)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4, b1=0.9, b2=0.99))
    js = jstate.create_train_state(variables, tx)
    noise = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    adam = js.opt_state[1][0]
    adam = adam._replace(count=jnp.asarray(120, jnp.int32), mu=noise(adam.mu),
                         nu=jax.tree_util.tree_map(jnp.abs, noise(adam.nu)))
    js = js.replace(step=jnp.asarray(120, jnp.int32), ema_step=jnp.asarray(120, jnp.int32),
                    opt_state=(js.opt_state[0], (adam, js.opt_state[1][1])),
                    ema_params=noise(js.ema_params))
    grads = jax.tree_util.tree_map(lambda x: x * grad_scale, noise(js.params))

    model = Unet(**CFG)
    ttrainer = Trainer(GaussianDiffusion(model, DiffusionConfig(image_size=16)),
                       bundle_images(), np.linspace(0.1, 0.9, 8),
                       TrainerConfig(ema_update_after_step=100, ema_update_every=10,
                                     ema_decay=0.995))
    ttrainer.state = train_state_from_jax(jax.device_get(js), model)
    names = [n for n, _ in model.named_parameters()]
    tgrads = unet_state_dict_from_jax({"params": grads, "batch_stats": js.batch_stats}, model)
    ttrainer.apply_gradients([tgrads[n] for n in names])

    @jax.jit
    def jax_apply(js, grads):  # the tail of the JAX train step (trainer.py:318-329)
        updates, opt_state = tx.update(grads, js.opt_state, js.params)
        js = js.replace(step=js.step + 1, params=optax.apply_updates(js.params, updates),
                        opt_state=opt_state)
        return jstate.ema_update(js, jstate.EmaConfig(beta=0.995, update_after_step=100,
                                                      update_every=10))

    js = jax_apply(js, grads)
    want = train_state_from_jax(jax.device_get(js), Unet(**CFG))
    got = ttrainer.state
    assert (got.step, got.ema_step, got.count) == (want.step, want.ema_step, want.count) == (
        121, 121, 121)
    pairs = [("params", list(got.model.parameters()), list(want.model.parameters())),
             ("mu", got.mu, want.mu), ("nu", got.nu, want.nu),
             ("ema", tstate.shadowed_tensors(got.ema_model),
              tstate.shadowed_tensors(want.ema_model))]
    for what, gs, ws in pairs:
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=what)


def bundle_images():
    rng = np.random.default_rng(8)
    return rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)

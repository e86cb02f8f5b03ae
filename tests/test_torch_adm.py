"""Port parity: the ADM GroupNorm UNet (--architecture adm).

A tiny JAX ADMUnet (model_channels 16, channel_mult (1, 2), one resnet
block a level (two on the way up), 8 groups,
attention at ds 1 and 2, so the down, mid and up paths all attend; 16x16)
gets random variables from jax.eval_shape and numpy draws; the port's
ADMUnet takes them through utils/convert.py and both run on the same
inputs. One module-scoped jit computes every JAX result, with XLA's
excess precision off. Bounds: f32 to 1e-4; --train_amp to the bf16 bound
of tests/test_torch_unet.py (3e-2 of the output's range) against JAX's
f32 output, and to 1e-5 of the range against JAX's --train_amp output
where init_conv's bf16 output is exact (_exact_init); train-mode BatchNorm to 1e-6; gradients each leaf
within 1e-3 of its largest |g| (the bias feeding the train-mode BatchNorm,
whose exact gradient is 0, within 1e-3 of the model's largest |g|); the
frozen null embedding's gradient exactly 0.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.models.unet_adm import ADMUnet as JaxADM
from ccdm_tpu.models.unet_adm import adm_timestep_embedding as jax_adm_embedding
from ccdm_tpu.training.state import precast_sampling_params as jax_precast
from ccdm_tpu_torch.models.layers import flax_batch_norm
from ccdm_tpu_torch.models.unet_adm import ADMUnet, adm_timestep_embedding
from ccdm_tpu_torch.training.state import (
    EmaConfig,
    adam_update,
    clip_by_global_norm,
    create_train_state,
    ema_update,
    precast_sampling_params,
)
from ccdm_tpu_torch.utils.convert import jax_variables_from_state_dict, state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

CFG = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, num_groups=8,
           attention_resolutions=(1, 2), in_channels=3)
SIZE = 16
BN_FED = ("classes_dense.bias",)
AMP_EXACT = 1e-5  # --train_amp against JAX's, with init_conv exact: of the range


def _draw_variables(shapes, seed=0):
    """Kernels scaled by 1/sqrt(fan-in); biases, gains, BatchNorm
    statistics and the null embedding away from their initial values."""
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


def _inputs(b=4):
    """x, t, label embeddings in [-1, 1] (the sinusoid's range), keep_mask."""
    rng = np.random.default_rng(1)
    return (rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32),
            np.array([0, 10, 500, 999][:b]), rng.uniform(-1, 1, (b, 128)).astype(np.float32),
            np.array([True, False, True, False][:b]))


def _exact_init(variables):
    """The variables with init_conv's kernel and bias on a grid of 1/8,
    and an x in {-1, 0, 1}: every sum of init_conv is a multiple of 1/8
    below 256/8 (27 taps x |w| <= 1/2, plus the bias), so its bf16 output is
    exact, the same bits in both frameworks whatever their order of
    summation. Past it both models run in f32 on the same values, so the
    --train_amp outputs can be held far tighter than the bf16 bound."""
    rng = np.random.default_rng(7)
    conv = variables["params"]["init_conv"]
    exact = {"kernel": (rng.integers(-4, 5, conv["kernel"].shape) / 8).astype(np.float32),
             "bias": (rng.integers(-8, 9, conv["bias"].shape) / 8).astype(np.float32)}
    x = rng.integers(-1, 2, (4, SIZE, SIZE, 3)).astype(np.float32)
    return {**variables, "params": {**variables["params"], "init_conv": exact}}, x


R = np.random.default_rng(5).normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)


def _loss(out):
    """A loss of the output in either framework."""
    r = torch.from_numpy(R) if isinstance(out, torch.Tensor) else R
    return (out * r).mean() + (out ** 2).mean()


@pytest.fixture(scope="module")
def jax_run():
    """Every JAX result of this file, from one jit."""
    model, amp = JaxADM(**CFG), JaxADM(**CFG, dtype=jnp.bfloat16)
    x, t, e, keep = _inputs()
    shapes = jax.eval_shape(lambda key: model.init(key, jnp.zeros((2, SIZE, SIZE, 3)),
                                                   jnp.zeros((2,), jnp.int32),
                                                   jnp.zeros((2, 128)), None),
                            jax.random.PRNGKey(0))
    variables, ema = _draw_variables(shapes), _draw_variables(shapes, seed=1)

    def run(v, ema):
        pre = jax_precast(v)
        fwd = lambda m, vv, k, xx=x: m.apply(vv, xx, t, e, k, train=False)
        exact, x_exact = _exact_init(v)

        def train(params):
            (out, state) = model.apply({**v, "params": params}, x, t, e, keep, train=True,
                                       mutable=["batch_stats", "intermediates"],
                                       capture_intermediates=lambda m, _: m.name in (
                                           "classes_dense", "classes_bn"))
            return _loss(out), (out, state)

        grads, (out, state) = jax.grad(train, has_aux=True)(v["params"])
        return {"f32": fwd(model, v, keep), "f32_none": fwd(model, v, None),
                "amp": fwd(amp, v, keep), "precast": fwd(model, pre, keep),
                "precast_amp": fwd(amp, pre, keep), "train_out": out,
                "amp_exact": fwd(amp, exact, keep, x_exact),
                "precast_amp_exact": fwd(amp, jax_precast(exact), keep, x_exact),
                "train_stats": state["batch_stats"],
                "bn_in": state["intermediates"]["classes_dense"]["__call__"][0],
                "bn_out": state["intermediates"]["classes_bn"]["__call__"][0],
                "grads": grads, "ema": fwd(model, ema, keep), "ema_variables": ema}

    # XLA's excess precision off: every bf16 op rounded where the model
    # rounds it (by default a fusion may skip a bf16 rounding, up to 1e-3
    # of the --train_amp output's range here)
    return variables, jax.device_get(jax.jit(run).lower(variables, ema).compile(
        {"xla_allow_excess_precision": False})(variables, ema))


def _port(variables, dtype=torch.float32):
    port = ADMUnet(**CFG, dtype=dtype)
    port.load_state_dict(state_dict_from_jax(variables, port))
    return port


def _forward(port, keep=True, train=False, x=None):
    x0, t, e, k = map(torch.from_numpy, _inputs())
    return port(x0 if x is None else torch.from_numpy(x), t, e, k if keep else None, train=train)


@pytest.mark.parametrize("dim", [16, 15])
def test_timestep_embedding_matches(dim):
    """cos || sin, divisor half, a zero column at odd dim: exact at t 0
    and in the pad column; elsewhere within 1e-6 plus t f32 ulps of a
    frequency (XLA's exp, cos and sin and torch's each round some
    arguments one ulp apart, 6e-8 here: bit equality is out of reach)."""
    t = np.array([0, 1, 7, 250, 999])
    want = np.asarray(jax_adm_embedding(jnp.asarray(t), dim))
    got = adm_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (5, dim)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[:, 2 * (dim // 2):], want[:, 2 * (dim // 2):])
    bound = 1e-6 + t[:, None].astype(np.float64) * 1.2e-7
    assert np.all(np.abs(got - want) <= bound)


def test_converter_round_trip(jax_run):
    variables, _ = jax_run
    port = _port(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    sd = port.state_dict()
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == n_leaves
    back = jax_variables_from_state_dict(sd, port)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)
    # the attention blocks exist where ds is in attention_resolutions
    assert {n for n, _ in port.named_children() if n.endswith("_attn")} == {
        "down_0_0_attn", "down_1_0_attn", "mid_attn",
        *(f"up_{lv}_{i}_attn" for lv in (0, 1) for i in range(2))}


@pytest.mark.parametrize("keep", [True, False])
def test_forward_f32_matches(jax_run, keep):
    variables, want = jax_run
    with torch.no_grad():
        got = _forward(_port(variables), keep).numpy()
    assert got.shape == (4, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want["f32" if keep else "f32_none"], rtol=1e-4, atol=1e-4)


def test_forward_amp_within_the_bf16_bound(jax_run):
    variables, want = jax_run
    with torch.no_grad():
        got = _forward(_port(variables, torch.bfloat16)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want["f32"]).max()
    assert np.abs(got - want["amp"]).max() <= 3e-2 * scale
    assert np.abs(got - want["f32"]).max() <= 3e-2 * scale


@pytest.mark.parametrize("precast", [False, True])
def test_forward_amp_matches_jax_amp(jax_run, precast):
    """With init_conv's bf16 output exact (_exact_init), the --train_amp
    forward against JAX's within AMP_EXACT of the output's range: the
    bf16 t and c embeddings meet f32 weights in f32, as flax promotes.
    Layers that computed in their input's dtype would run the FiLM
    projections in bf16 and miss it (CHANGES.md gives both readings)."""
    variables, want = jax_run
    exact, x = _exact_init(variables)
    port = _port(exact, torch.bfloat16)
    with torch.no_grad():
        got = _forward(precast_sampling_params(port) if precast else port, x=x).numpy()
    key = "precast_amp_exact" if precast else "amp_exact"
    assert np.abs(got - want[key]).max() <= AMP_EXACT * np.abs(want[key]).max()


def test_precast_weights_match_jax(jax_run):
    """bf16 weights are used in f32 by every layer but the bf16 init_conv
    of --train_amp, as flax promotes them."""
    variables, want = jax_run
    port, amp = _port(variables), _port(variables, torch.bfloat16)
    with torch.no_grad():
        got = _forward(precast_sampling_params(port)).numpy()
        got_amp = _forward(precast_sampling_params(amp)).numpy()
    assert port.init_conv.weight.dtype == torch.bfloat16
    assert port.null_classes_emb.dtype == torch.float32
    np.testing.assert_allclose(got, want["precast"], rtol=1e-4, atol=1e-4)
    assert np.abs(got_amp - want["precast_amp"]).max() <= 3e-2 * np.abs(want["f32"]).max()


def test_train_mode_batch_norm_matches(jax_run):
    variables, want = jax_run
    port = _port(variables)
    _, _, e, _ = _inputs()
    with torch.no_grad():
        # the layer on JAX's input to it: B 4 statistics amplify the dense
        # layer's own rounding differences in the normalised output
        fresh = _port(variables)
        bn_out = flax_batch_norm(fresh.classes_bn, torch.tensor(want["bn_in"]), train=True)
        np.testing.assert_allclose(fresh.classes_dense(torch.from_numpy(e)).numpy(),
                                   want["bn_in"], rtol=1e-5, atol=1e-5)
        out = _forward(port, train=True)
    np.testing.assert_allclose(bn_out.numpy(), want["bn_out"], rtol=1e-6, atol=1e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port.classes_bn, f"running_{name}").numpy(),
            want["train_stats"]["classes_bn"][name], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), want["train_out"], rtol=1e-4, atol=1e-4)


def test_gradients_match_jax_grad(jax_run):
    variables, want = jax_run
    port = _port(variables)
    _loss_t(port).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in port.named_parameters()}
    assert port.null_classes_emb.grad is None  # detached: no gradient reaches it
    got = jax_variables_from_state_dict(grads, port)["params"]
    top = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(want["grads"]))
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(want["grads"])[0]:
        name = ".".join(k.key for k in path)
        bound = top if name in BN_FED else np.abs(g).max()
        np.testing.assert_allclose(flat_got[path], g, rtol=0, atol=1e-3 * bound, err_msg=name)
    np.testing.assert_array_equal(want["grads"]["null_classes_emb"], 0.0)


def _loss_t(port):
    return _loss(_forward(port, train=True))


def test_null_embedding_frozen_through_adam_and_ema(jax_run):
    variables, _ = jax_run
    port = _port(variables)
    before = port.null_classes_emb.detach().clone()
    state = create_train_state(port)
    _loss_t(port).backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in port.parameters()]
    adam_update(state, clip_by_global_norm(grads, 1.0), lr=1e-2)
    ema_update(state, EmaConfig())
    torch.testing.assert_close(port.null_classes_emb.detach(), before, rtol=0, atol=0)
    torch.testing.assert_close(state.ema_model.null_classes_emb, before, rtol=0, atol=0)
    assert not torch.equal(port.init_conv.weight, _port(variables).init_conv.weight)


def test_fresh_weights_are_seeded():
    a, b, c = ADMUnet(**CFG, seed=3), ADMUnet(**CFG, seed=3), ADMUnet(**CFG, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["init_conv.weight"], sc["init_conv.weight"])
    assert bool((sa["null_classes_emb"] <= 0).all()) and sa["null_classes_emb"].shape == (64,)
    assert torch.equal(sa["down_0_0.norm1.weight"], torch.ones(16))


def test_jax_train_state_carried_by_the_script(jax_run, tmp_path):
    """A JAX train state saved as ccdm_tpu's Trainer saves it, carried by
    scripts/jax_milestone_to_torch.py --architecture adm: the EMA
    forward within 1e-4 of JAX's, Adam's moments, count and the steps."""
    import optax

    from ccdm_tpu.training.state import create_train_state as jax_train_state
    from ccdm_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
    from ccdm_tpu_torch.main import build_model, results_folder
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.serve import ema_model_from_milestone
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    variables, want = jax_run
    ema = want["ema_variables"]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4, b1=0.9, b2=0.99))
    state = jax_train_state(variables, tx)
    clip, (adam, rest) = state.opt_state
    scaled = lambda f: jax.tree_util.tree_map(lambda p: np.abs(p) * f, variables["params"])
    adam = adam._replace(count=np.asarray(7, np.int32), mu=scaled(0.1), nu=scaled(0.01))
    jax_results = tmp_path / "jax" / "results"
    jax_save_checkpoint(str(jax_results), 7, {
        "step": np.asarray(7), "params": variables["params"],
        "batch_stats": variables["batch_stats"], "opt_state": (clip, (adam, rest)),
        "ema_step": np.asarray(7), "ema_params": ema["params"],
        "ema_batch_stats": ema["batch_stats"]})
    spec = importlib.util.spec_from_file_location(
        "jax_milestone_to_torch", ROOT / "scripts" / "jax_milestone_to_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = ["--root_path", str(tmp_path / "port"), "--num_channels", "3", "--device", "cpu",
            *["--architecture", "adm", "--model_channels", "16", "--channel_mult", "1_2",
            "--num_res_blocks", "1", "--num_groups", "8", "--attention_resolutions", "1_2",
            "--image_size", str(SIZE)]]
    script.convert(str(jax_results), 7, argv)

    args = parse_opts(argv)
    tree = load_checkpoint(results_folder(args), 7)
    assert tree["step"] == tree["ema_step"] == tree["opt_state"]["count"] == 7
    model = ema_model_from_milestone(build_model(args, SIZE, 3), results_folder(args), 7)
    names = [n for n, _ in model.named_parameters()]
    i = names.index("null_classes_emb")
    np.testing.assert_array_equal(tree["opt_state"]["mu"][i].numpy(),
                                  np.abs(variables["params"]["null_classes_emb"]) * 0.1)
    with torch.no_grad():
        got = _forward(model.eval()).numpy()
    np.testing.assert_allclose(got, want["ema"], rtol=1e-4, atol=1e-4)

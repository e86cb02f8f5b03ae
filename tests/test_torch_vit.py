"""Port parity: the DiT-style ViT denoiser (--architecture vit).

A tiny JAX ViT (dim 16, dim_mults (1, 2): width 32, 4 heads of 8, 2
blocks; 8x8) gets random variables from jax.eval_shape and numpy draws;
the port's ViT takes them through utils/convert.py and both run on the
same inputs. One module-scoped jit computes every JAX result, with XLA's
excess precision off. Bounds: f32 to 1e-4; --train_amp to the bf16 bound
of tests/test_torch_unet.py (3e-2 of the output's range) against JAX's
f32 output, and to 1e-5 of the range against JAX's --train_amp output
where init_conv's bf16 output is exact (_exact_init); train-mode BatchNorm to 1e-6; gradients each leaf
within 1e-3 of its largest |g| (the biases feeding the train-mode
BatchNorms, whose exact gradient is 0, within 1e-3 of the model's largest
|g|); the token attention through F.scaled_dot_product_attention against
the einsum form and JAX's to 1e-5 (SDPA sums in another order).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.models.vit import ViT as JaxViT
from ccdm_tpu.training.state import precast_sampling_params as jax_precast
from ccdm_tpu_torch.models.layers import flax_batch_norm
from ccdm_tpu_torch.models.vit import ViT, token_attention, token_attention_einsum
from ccdm_tpu_torch.training.state import precast_sampling_params
from ccdm_tpu_torch.utils.convert import jax_variables_from_state_dict, state_dict_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

CFG = dict(dim=16, dim_mults=(1, 2), num_blocks=2, in_channels=3)
SIZE = 8
BN_FED = ("cond_dense_1.bias", "cond_dense_2.bias")
AMP_EXACT = 1e-5  # --train_amp against JAX's, with init_conv exact: of the range
BNS = (("cond_dense_1", "cond_bn_1"), ("cond_dense_2", "cond_bn_2"))


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
        elif "bias" in name or "mean" in name or "null" in name or "'b'" in name:
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
    below 256/8 (147 taps x |w| <= 1/8, plus the bias), so its bf16 output is
    exact, the same bits in both frameworks whatever their order of
    summation. Past it both models run in f32 on the same values, so the
    --train_amp outputs can be held far tighter than the bf16 bound."""
    rng = np.random.default_rng(7)
    conv = variables["params"]["init_conv"]
    exact = {"kernel": (rng.integers(-1, 2, conv["kernel"].shape) / 8).astype(np.float32),
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
    model, amp = JaxViT(**CFG), JaxViT(**CFG, dtype=jnp.bfloat16)
    x, t, e, keep = _inputs()
    shapes = jax.eval_shape(lambda key: model.init(key, jnp.zeros((2, SIZE, SIZE, 3)),
                                                   jnp.zeros((2,), jnp.int32),
                                                   jnp.zeros((2, 128)), None),
                            jax.random.PRNGKey(0))
    variables = _draw_variables(shapes)
    captured = {name for pair in BNS for name in pair}

    def run(v):
        pre = jax_precast(v)
        fwd = lambda m, vv, k, xx=x: m.apply(vv, xx, t, e, k, train=False)
        exact, x_exact = _exact_init(v)

        def train(params):
            (out, state) = model.apply({**v, "params": params}, x, t, e, keep, train=True,
                                       mutable=["batch_stats", "intermediates"],
                                       capture_intermediates=lambda m, _: m.name in captured)
            return _loss(out), (out, state)

        grads, (out, state) = jax.grad(train, has_aux=True)(v["params"])
        return {"f32": fwd(model, v, keep), "f32_none": fwd(model, v, None),
                "amp": fwd(amp, v, keep), "precast": fwd(model, pre, keep),
                "precast_amp": fwd(amp, pre, keep), "train_out": out,
                "amp_exact": fwd(amp, exact, keep, x_exact),
                "precast_amp_exact": fwd(amp, jax_precast(exact), keep, x_exact),
                "train_stats": state["batch_stats"],
                "bn": {name: state["intermediates"][name]["__call__"][0] for name in captured},
                "grads": grads}

    # XLA's excess precision off: every bf16 op rounded where the model
    # rounds it (by default a fusion may skip a bf16 rounding, up to 1e-3
    # of the --train_amp output's range here)
    return variables, jax.device_get(jax.jit(run).lower(variables).compile(
        {"xla_allow_excess_precision": False})(variables))


def _port(variables, dtype=torch.float32):
    port = ViT(**CFG, dtype=dtype)
    port.load_state_dict(state_dict_from_jax(variables, port))
    return port


def _forward(port, keep=True, train=False, x=None):
    x0, t, e, k = map(torch.from_numpy, _inputs())
    return port(x0 if x is None else torch.from_numpy(x), t, e, k if keep else None, train=train)


def test_converter_round_trip(jax_run):
    variables, _ = jax_run
    port = _port(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    sd = port.state_dict()
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == n_leaves
    back = jax_variables_from_state_dict(sd, port)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)
    assert port.init_conv.weight.shape == (32, 3, 7, 7)  # straight to the width


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
    assert port.block_0.mlp_fc1.weight.dtype == torch.bfloat16
    assert port.block_0.norm1.g.dtype == port.null_cond_emb.dtype == torch.float32
    np.testing.assert_allclose(got, want["precast"], rtol=1e-4, atol=1e-4)
    assert np.abs(got_amp - want["precast_amp"]).max() <= 3e-2 * np.abs(want["f32"]).max()


def test_train_mode_batch_norm_matches(jax_run):
    """Each BatchNorm on JAX's input to it (B 4 statistics amplify the
    dense layers' own rounding differences), then the whole train-mode
    forward and its running statistics."""
    variables, want = jax_run
    port = _port(variables)
    with torch.no_grad():
        fresh = _port(variables)
        for dense, bn in BNS:
            got = flax_batch_norm(getattr(fresh, bn), torch.tensor(want["bn"][dense]),
                                  train=True)
            np.testing.assert_allclose(got.numpy(), want["bn"][bn], rtol=1e-6, atol=1e-6)
        out = _forward(port, train=True)
    for _, bn in BNS:
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(getattr(port, bn), f"running_{name}").numpy(),
                                       want["train_stats"][bn][name], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), want["train_out"], rtol=1e-4, atol=1e-4)


def test_gradients_match_jax_grad(jax_run):
    variables, want = jax_run
    port = _port(variables)
    _loss(_forward(port, train=True)).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    got = jax_variables_from_state_dict(grads, port)["params"]
    top = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(want["grads"]))
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(want["grads"])[0]:
        name = ".".join(k.key for k in path)
        bound = top if name in BN_FED else np.abs(g).max()
        np.testing.assert_allclose(flat_got[path], g, rtol=0, atol=1e-3 * bound, err_msg=name)
    assert np.abs(want["grads"]["null_cond_emb"]).max() > 0  # trainable, unlike ADM's


def test_sdpa_attention_matches_the_einsum_form():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 64, 8, generator=g) for _ in range(3))
    torch.testing.assert_close(token_attention(q, k, v), token_attention_einsum(q, k, v),
                               rtol=1e-5, atol=1e-5)
    # JAX's own form on the same inputs (ccdm_tpu/models/vit.py:57-59)
    qj, kj, vj = (jnp.asarray(a.transpose(1, 2).numpy()) for a in (q, k, v))
    sim = jnp.einsum("bihd,bjhd->bhij", qj * 8 ** -0.5, kj)
    want = jnp.einsum("bhij,bjhd->bihd", jax.nn.softmax(sim, axis=-1), vj)
    np.testing.assert_allclose(token_attention(q, k, v).transpose(1, 2).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fresh_weights_are_seeded():
    a, b, c = ViT(**CFG, seed=3), ViT(**CFG, seed=3), ViT(**CFG, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["init_conv.weight"], sc["init_conv.weight"])
    assert bool((sa["null_cond_emb"] <= 0).all()) and sa["null_cond_emb"].shape == (16,)
    assert torch.equal(sa["block_0.norm1.g"], torch.ones(32))
    assert torch.equal(sa["block_0.norm1.b"], torch.zeros(32))


def test_jax_train_state_carried_by_the_script(jax_run, tmp_path):
    """A JAX train state saved as ccdm_tpu's Trainer saves it, carried by
    scripts/jax_milestone_to_torch.py --architecture vit (8 blocks, as
    JAX's CLI builds it): the EMA
    forward within 1e-4 of JAX's, Adam's moments, count and the steps."""
    import optax

    from ccdm_tpu.training.state import create_train_state as jax_train_state
    from ccdm_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
    from ccdm_tpu_torch.main import build_model, results_folder
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.serve import ema_model_from_milestone
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    # JAX's CLI builds the ViT with its default 8 blocks
    model = JaxViT(**{**CFG, "num_blocks": 8})
    shapes = jax.eval_shape(lambda key: model.init(key, jnp.zeros((2, SIZE, SIZE, 3)),
                                                   jnp.zeros((2,), jnp.int32),
                                                   jnp.zeros((2, 128)), None),
                            jax.random.PRNGKey(0))
    variables, ema = _draw_variables(shapes, seed=2), _draw_variables(shapes, seed=3)
    x, t, e, keep = _inputs()
    want = np.asarray(jax.jit(lambda v: model.apply(v, x, t, e, keep, train=False))(ema))
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
            *["--architecture", "vit", "--model_channels", "16", "--channel_mult", "1_2",
            "--image_size", str(SIZE)]]
    script.convert(str(jax_results), 7, argv)

    args = parse_opts(argv)
    tree = load_checkpoint(results_folder(args), 7)
    assert tree["step"] == tree["ema_step"] == tree["opt_state"]["count"] == 7
    model = ema_model_from_milestone(build_model(args, SIZE, 3), results_folder(args), 7)
    names = [n for n, _ in model.named_parameters()]
    i = names.index("null_cond_emb")
    np.testing.assert_array_equal(tree["opt_state"]["mu"][i].numpy(),
                                  np.abs(variables["params"]["null_cond_emb"]) * 0.1)
    with torch.no_grad():
        got = _forward(model.eval()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

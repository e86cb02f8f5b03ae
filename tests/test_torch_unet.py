"""Port parity: weight conversion, the resnet block and the UNet forward.

A small JAX Unet (dim 8, mults (1, 2), 16x16, 4 heads x 32) is converted
with utils/convert.py and both run on the same inputs. f32 to 1e-4: the same
convs and products in another framework, over a dozen layers. bf16: both
frameworks round to bf16 at their own points, and each lands about 1.5% of
the output's range from the f32 result; the port must agree with the JAX
bf16 forward, and with the f32 forward, to 3e-2 of that range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccdm_tpu.models import Unet as JaxUnet
from ccdm_tpu.ops.resnet_block import resnet_block_reference as jax_resnet_block
from ccdm_tpu_torch.models.unet import Unet
from ccdm_tpu_torch.ops.resnet_block import resnet_block_reference
from ccdm_tpu_torch.training.state import precast_sampling_params
from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)

CFG = dict(dim=8, dim_mults=(1, 2), in_channels=3)


def _jax_variables(seed=0):
    """Random variables in the JAX Unet's tree (shapes from eval_shape, so
    nothing is compiled): kernels scaled by 1/sqrt(fan-in), and biases,
    gains and BatchNorm statistics away from their initial values."""
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
        else:  # norm gains and BatchNorm scales
            a = 1 + rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_forward(variables, x, t, e, keep, dtype=jnp.float32):
    model = JaxUnet(**CFG, dtype=dtype)
    return np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, x, t, e, keep))


def _inputs(b=4):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(b, 16, 16, 3)).astype(np.float32),
            np.array([0, 10, 500, 999][:b]), rng.uniform(size=(b, 128)).astype(np.float32),
            np.array([True, False, True, False][:b]))


@pytest.fixture(scope="module")
def variables():
    return _jax_variables()


def test_converter_consumes_every_leaf(variables):
    port = Unet(**CFG)
    sd = unet_state_dict_from_jax(variables, port)
    port.load_state_dict(sd)  # strict: every tensor of the port is set
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == n_leaves


def test_converter_raises_on_a_leaf_it_cannot_place(variables):
    extra = {"params": {**variables["params"], "stray": {"kernel": np.zeros((2, 2))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        unet_state_dict_from_jax(extra, Unet(**CFG))
    params = dict(variables["params"])
    del params["final_conv"]
    with pytest.raises(KeyError, match="final_conv"):
        unet_state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]},
                                 Unet(**CFG))


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_resnet_block_matches(cin, cout):
    rng = np.random.default_rng(2)
    b, hh, ww = 2, 6, 5
    x = rng.normal(size=(b, hh * ww, cin)).astype(np.float32)
    scale, shift = (rng.normal(0, 0.3, (b, cout)).astype(np.float32) for _ in range(2))
    w1 = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (3, 3, cout, cout)).astype(np.float32)
    b1, b2, g1, g2 = (rng.normal(0, 0.3, cout).astype(np.float32) + k for k in (0, 0, 1, 1))
    wres = rng.normal(0, 0.3, (cin, cout)).astype(np.float32) if cin != cout else None
    bres = rng.normal(0, 0.3, cout).astype(np.float32) if cin != cout else None
    want = np.asarray(jax_resnet_block(jnp.asarray(x), scale, shift, w1, b1, g1, w2, b2, g2,
                                       wres, bres, hh, ww)).reshape(b, hh, ww, cout)
    t = torch.from_numpy
    oihw = lambda w: t(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = resnet_block_reference(
        t(x).reshape(b, hh, ww, cin).permute(0, 3, 1, 2), t(scale), t(shift),
        oihw(w1), t(b1), t(g1), oihw(w2), t(b2), t(g2),
        None if wres is None else t(np.ascontiguousarray(wres.T[:, :, None, None])),
        None if bres is None else t(bres))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_forward_f32_matches(variables):
    x, t, e, keep = _inputs()
    want = _jax_forward(variables, x, t, e, keep)
    port = Unet(**CFG)
    port.load_state_dict(unet_state_dict_from_jax(variables, port))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, e, keep))).numpy()
    assert got.shape == want.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_keep_mask_none_matches(variables):
    x, t, e, _ = _inputs(2)
    want = _jax_forward(variables, x, t, e, None)
    port = Unet(**CFG)
    port.load_state_dict(unet_state_dict_from_jax(variables, port))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, e)), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches(variables):
    x, t, e, keep = _inputs()
    want32 = _jax_forward(variables, x, t, e, keep)
    want16 = _jax_forward(variables, x, t, e, keep, jnp.bfloat16)
    port = Unet(**CFG, dtype=torch.bfloat16)
    port.load_state_dict(unet_state_dict_from_jax(variables, port))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, e, keep))).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want32).max()
    assert np.abs(got - want16).max() <= 3e-2 * scale
    assert np.abs(got - want32).max() <= 3e-2 * scale


def test_precast_sampling_params_keeps_vectors_f32(variables):
    x, t, e, keep = _inputs()
    port = Unet(**CFG, dtype=torch.bfloat16)
    port.load_state_dict(unet_state_dict_from_jax(variables, port))
    with torch.no_grad():
        before = port(*map(torch.from_numpy, (x, t, e, keep)))
        precast_sampling_params(port)
        after = port(*map(torch.from_numpy, (x, t, e, keep)))
    for p in port.parameters():
        assert p.dtype == (torch.bfloat16 if p.ndim >= 2 else torch.float32)
    # the bf16 layers cast their weights to bf16 at use anyway; only the f32
    # conditioning layers and the final conv see bf16-rounded weights now
    assert torch.isfinite(after).all()
    assert (after - before).abs().max() <= 3e-2 * before.abs().max()


def test_fresh_port_weights_are_seeded():
    a, b, c = Unet(**CFG, seed=3), Unet(**CFG, seed=3), Unet(**CFG, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["init_conv.weight"], sc["init_conv.weight"])
    assert bool((sa["null_cond_emb"] <= 0).all())
    w = sa["down_0_block1.conv1_weight"]
    assert abs(float(w.std()) - (1 / (8 * 9)) ** 0.5) < 0.05

"""Port parity: StyleGAN's style ops (ccdm_tpu_torch/ops/style_ops.py).

`bias_act(impl="ref")` is held against JAX's `bias_act(impl="ref")` for all
9 activations, with and without bias, clamp and explicit gains: f32 rtol
1e-5 / atol 1e-6 (the same operations; the transcendental functions of two
libraries), bf16 rtol = atol = 1.6e-2 (two units in the last place: both
round op by op, but the functions round differently inside). The plain
version of kernel #12 is held against JAX's `_bias_act_pallas` in interpret
mode at the same bounds: in bf16 the kernel rounds once where JAX rounds
after each operation. `upfirdn2d` (the four (up, down, pad) cases and the
separable filter of tests/test_style_ops.py:58-74) and `filtered_lrelu` are
held to JAX to 1e-5. The CUDA kernel runs only on the card: the tests marked
`cuda` hold it against its plain version there and skip elsewhere, and the
file runs there as `python -m pytest --noconftest tests/test_torch_style_ops.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops import style_ops as so

torch.set_num_threads(2)

ACTS = list(so.activation_funcs)
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}
# (bias, gain, clamp): the defaults, then bias with an explicit gain and a clamp
CASES = [(False, None, None), (True, None, None), (True, 0.5, 1.5)]


@pytest.fixture
def jso(monkeypatch):
    """The JAX module, with Pallas calls in interpret mode."""
    import jax.experimental.pallas as pl

    from ccdm_tpu.ops import style_ops as jax_so

    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    return jax_so


def _inputs(seed, shape, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, shape).astype(np.float32)
    b = rng.normal(0, 1, shape[-1]).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    return (jnp.asarray(x).astype(jdt), jnp.asarray(b).astype(jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(b).to(tdt))


def _close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_ref_matches_jax(jso, act, dtype):
    jx, jb, x, b = _inputs(ACTS.index(act), (3, 5, 7, 24), dtype)
    for with_bias, gain, clamp in CASES:
        want = jso.bias_act(jx, jb if with_bias else None, act=act, gain=gain, clamp=clamp,
                            impl="ref")
        got = so.bias_act(x, b if with_bias else None, act=act, gain=gain, clamp=clamp,
                          impl="ref")
        _close(got, want, dtype)


def test_bias_act_ref_on_another_dim_matches_jax(jso):
    """dim 1 (NCHW-style bias), and an f32 bias on bf16 x promoting to f32
    as jnp does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 4)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = jso.bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act="lrelu", impl="ref")
    got = so.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=1, act="lrelu", impl="ref")
    _close(got, want, "float32")
    want = jso.bias_act(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(b), dim=1,
                        act="swish", impl="ref")
    got = so.bias_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(b), dim=1, act="swish",
                      impl="ref")
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_kernel_matches_pallas_kernel(jso, act, dtype):
    """The CPU route of kernel #12 against the TPU kernel in interpret mode,
    rows not a multiple of its tile (37 rows of 256)."""
    jx, jb, x, b = _inputs(10 + ACTS.index(act), (37, 256), dtype)
    for with_bias, gain, clamp in CASES:
        _, alpha, gain, clamp = so._resolve(act, None, gain, clamp)
        want = jso._bias_act_pallas(jx, jb if with_bias else None, act, alpha, gain, clamp)
        got = so.bias_act_fused(x, b if with_bias else None, act, alpha, gain, clamp)
        _close(got, want, dtype)


def test_impl_routes():
    x = torch.zeros(4, 128)
    assert so.bias_act(x, act="relu").shape == (4, 128)  # auto: the reference on the CPU
    with pytest.raises(ValueError, match="CUDA tensor"):
        so.bias_act(x, act="relu", impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        so.bias_act(x, impl="pallas")
    with pytest.raises(ValueError, match="cuda or cpu"):
        so.bias_act_fused(torch.zeros(2, 8, device="meta"), None, "relu", 0.0, 1.0, -1.0)
    src = (_build.CSRC_DIR / "style_ops.cu").read_text()
    assert "ccdm_bias_act(" in src and "ccdm_cuda_error_string(" in src
    assert "torch" not in src  # a plain C interface: nvcc alone builds it
    assert list(so._ACT_INDEX) == ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu",
                                   "softplus", "swish"]  # the kernel's switch order


@pytest.mark.parametrize("up,down,pad", [(1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 2)])
def test_upfirdn2d_matches_jax(jso, up, down, pad):
    import jax.numpy as jnp

    rng = np.random.default_rng(up * 10 + down)
    x = rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    f = rng.normal(0, 1, (3, 3)).astype(np.float32)
    want = np.asarray(jso.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down,
                                    padding=pad))
    got = so.upfirdn2d(torch.from_numpy(x), torch.from_numpy(f), up=up, down=down, padding=pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_upfirdn2d_separable_and_cropping_match_jax(jso):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    f1 = rng.normal(0, 1, (3,)).astype(np.float32)
    for kw in (dict(padding=1), dict(up=2, padding=(2, 1, 0, -1), gain=4.0),
               dict(down=2, flip_filter=True)):
        want = np.asarray(jso.upfirdn2d(jnp.asarray(x), jnp.asarray(f1), **kw))
        got = so.upfirdn2d(torch.from_numpy(x), torch.from_numpy(f1), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    sep = so.upfirdn2d(torch.from_numpy(x), torch.from_numpy(f1), padding=1)
    full = so.upfirdn2d(torch.from_numpy(x), torch.from_numpy(np.outer(f1, f1)), padding=1)
    np.testing.assert_allclose(sep.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clamp", [None, 0.7])
def test_filtered_lrelu_matches_jax(jso, clamp):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    b = rng.normal(0, 1, 4).astype(np.float32)
    f = np.array([1.0, 3.0, 3.0, 1.0], np.float32) / 8.0
    want = np.asarray(jso.filtered_lrelu(jnp.asarray(x), fu=jnp.asarray(f), fd=jnp.asarray(f),
                                         b=jnp.asarray(b), up=2, down=2, padding=2, clamp=clamp))
    got = so.filtered_lrelu(torch.from_numpy(x), fu=torch.from_numpy(f), fd=torch.from_numpy(f),
                            b=torch.from_numpy(b), up=2, down=2, padding=2, clamp=clamp)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- the card only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64 * 8 * 8, 512), (1003, 128), (5, 7, 12)])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    g = torch.Generator().manual_seed(shape[0])
    dt = getattr(torch, dtype)
    x = (2 * torch.randn(*shape, generator=g)).to(dt).cuda()
    b = torch.randn(shape[-1], generator=g).cuda()
    for act in ACTS:
        for with_bias, gain, clamp in CASES:
            _, alpha, gain, clamp = so._resolve(act, None, gain, clamp)
            bias = b if with_bias else None
            before = so.bias_act_fused.launches
            got = so.bias_act(x, bias, act=act, alpha=alpha, gain=gain, clamp=clamp,
                              impl="cuda")
            torch.cuda.synchronize()
            assert so.bias_act_fused.launches == before + 1
            want = so.bias_act_fused_reference(x, bias, act, alpha, gain, clamp)
            # both in f32, rounded once: in bf16 a rounding may flip one unit
            torch.testing.assert_close(got.float(), want.float(), **(
                TOL["float32"] if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)))

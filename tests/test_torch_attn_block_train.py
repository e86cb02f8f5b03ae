"""Port parity: the attention block's training path (kernels #2-#5).

The plain versions of the two-pass forward (`ctx_large_reference`,
`out_large_reference`) and of the fused backward (`bwd_a_reference`,
`bwd_b_reference`) are held against the JAX kernels `_forward_pallas_large`
and `_backward_pallas_large` run in interpret mode, as tests/test_attn_block.py
runs them: the forward to rtol 2e-3 / atol 2e-4 in f32 and 3e-2 in bf16, the
backward to the bounds of tests/test_attn_block.py:301-308 (f32 rtol = atol =
2e-3; bf16 rtol 1e-1, atol 0.02 max(|g|, 1)). The residual a is compared on
its diagonal D x D blocks, the only ones the port keeps. The autograd
Function that routes training through them is held against jax.vjp of the
plain composition to 2e-3 in f32.

The tests marked `cuda` hold each CUDA kernel against its plain version on
the card (skipped here). This file imports JAX only inside the tests that
compare with it, so that on the card, which has no JAX, it runs as
`python -m pytest --noconftest tests/test_torch_attn_block_train.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops import attn_block

torch.set_num_threads(2)

HEADS, D = 4, 32
F = HEADS * D


def _inputs(rng, b, n, c, x_std=1.0):
    x = rng.normal(0, x_std, (b, n, c)).astype(np.float32)
    w = (rng.normal(0, 1, (c,)).astype(np.float32) * 0.5 + 1.0,
         rng.normal(0, 0.1, (c, 3 * F)).astype(np.float32),
         rng.normal(0, 0.1, (F, c)).astype(np.float32),
         rng.normal(0, 0.1, (c,)).astype(np.float32),
         rng.normal(0, 1, (c,)).astype(np.float32) * 0.5 + 1.0)
    dy = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    return x, w, dy


@pytest.fixture
def jab(monkeypatch):
    """The JAX module, with Pallas calls in interpret mode."""
    import jax.experimental.pallas as pl

    from ccdm_tpu.ops import attn_block as jax_attn_block

    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    return jax_attn_block


def _diag_blocks(a_ff: np.ndarray) -> np.ndarray:
    """[B, F, F] -> its per-head diagonal blocks [B, H, D, D]."""
    b = a_ff.shape[0]
    a = a_ff.reshape(b, HEADS, D, HEADS, D)
    return np.stack([a[:, h, :, h, :] for h in range(HEADS)], axis=1)


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2048, 4096])
def test_plain_two_pass_forward_matches_pallas(jab, n, dtype):
    import jax.numpy as jnp

    x, w, _ = _inputs(np.random.default_rng(0), 2, n, 64, 2.0 if dtype == "float32" else 1.0)
    jx = jnp.asarray(x).astype(dtype)
    y, a, s, kmax = (np.asarray(t, np.float32) for t in jab._forward_pallas_large(
        jx, *map(jnp.asarray, w), HEADS, D, return_residuals=True))
    dt = getattr(torch, dtype)
    tx, (g_pre, wqkv, wout, bout, g_out) = _torch([x], dt)[0], _torch(w)
    got_a, got_s, got_kmax = attn_block.ctx_large_reference(tx, g_pre, wqkv, HEADS)
    ctx = attn_block.finalize_ctx(got_a, got_s, dt)
    got_y = attn_block.out_large_reference(tx, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got_y.float().numpy(), y, **tol)
    np.testing.assert_allclose(got_kmax.numpy(), kmax[:, 0], **tol)
    # a and s are sums over N of terms <= 1: bound relative to their size
    for got, want in ((got_s.numpy(), s[:, 0]), (got_a.numpy(), _diag_blocks(a))):
        np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(want).max())


@pytest.mark.parametrize("dtype,n", [("float32", 2048), ("float32", 4096), ("bfloat16", 2048)])
def test_plain_fused_backward_matches_pallas(jab, n, dtype):
    import jax.numpy as jnp

    x, w, dy = _inputs(np.random.default_rng(1), 2, n, 64)
    jx, jdy = jnp.asarray(x).astype(dtype), jnp.asarray(dy).astype(dtype)
    jw = list(map(jnp.asarray, w))
    _, a, s, kmax = jab._forward_pallas_large(jx, *jw, HEADS, D, return_residuals=True)
    want = jab._backward_pallas_large(jx, *jw, jdy, a, s, kmax, HEADS, D)

    dt = getattr(torch, dtype)
    tx, tdy = _torch([x, dy], dt)
    g_pre, wqkv, wout, bout, g_out = _torch(w)
    ta, ts, tkmax = _torch([_diag_blocks(np.asarray(a)), np.asarray(s)[:, 0],
                            np.asarray(kmax)[:, 0]])
    ctx = attn_block.finalize_ctx(ta, ts, dt)
    do, d_ctx, d_wout, d_bout, d_gout = attn_block.bwd_a_reference(
        tx, tdy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    d_a, d_s = attn_block.finalize_ctx_backward(d_ctx, ta, ts)
    dx, d_wqkv, d_gpre = attn_block.bwd_b_reference(tx, tdy, do, g_pre, wqkv, ctx, wout,
                                                    tkmax, d_a, d_s, HEADS)
    assert dx.dtype == dt and d_wqkv.dtype == torch.float32
    for name, got, ref in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                              (dx, d_gpre, d_wqkv, d_wout, d_bout, d_gout), want):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-1,
                                       atol=0.02 * max(float(np.abs(ref).max()), 1.0),
                                       err_msg=name)


def test_autograd_function_matches_jax_vjp():
    import jax
    import jax.numpy as jnp

    from ccdm_tpu.ops import attn_block as jax_attn_block

    x, w, dy = _inputs(np.random.default_rng(2), 2, 2048, 64)
    _, vjp = jax.vjp(lambda *a: jax_attn_block.attn_block_reference(*a, heads=HEADS, dim_head=D),
                     jnp.asarray(x), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dy))
    inputs = [t.requires_grad_() for t in _torch([x, *w])]
    y = attn_block.fused_attn_block(*inputs, HEADS, D)
    assert type(y.grad_fn).__name__ == "_TwoPassBlockBackward"
    y.backward(torch.from_numpy(dy))
    for name, t, ref in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"),
                            inputs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("n,route", [(1024, "_SinglePassBlockBackward"),
                                     (4096, "_TwoPassBlockBackward")])
def test_dispatch_by_n(n, route):
    x, w, _ = _inputs(np.random.default_rng(3), 1, n, 32)
    args = _torch([x, *w])
    counts = [fn.launches for fn in (attn_block.fused_attn_block, attn_block.attn_ctx_large,
                                     attn_block.attn_out_large)]
    with torch.no_grad():  # no gradient: the single-pass plain version
        assert attn_block.fused_attn_block(*args, HEADS, D).grad_fn is None
    args[2].requires_grad_()
    y = attn_block.fused_attn_block(*args, HEADS, D)
    assert type(y.grad_fn).__name__ == route
    torch.testing.assert_close(y, attn_block.attn_block_reference(*args, HEADS, D),
                               rtol=1e-5, atol=1e-5)
    y.sum().backward()
    assert args[2].grad is not None and bool(torch.isfinite(args[2].grad).all())
    # on the CPU every route runs plain versions: no kernel was launched
    assert counts == [fn.launches for fn in (attn_block.fused_attn_block,
                                             attn_block.attn_ctx_large,
                                             attn_block.attn_out_large)]
    assert attn_block.takes_two_pass(n, F) == (route == "_TwoPassBlockBackward")


def test_kernel_source_exports_the_four_entry_points():
    from ccdm_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "attn_block_large.cu").read_text()
    for name in ("ccdm_attn_ctx_large", "ccdm_attn_out_large", "ccdm_attn_bwd_a",
                 "ccdm_attn_bwd_b", "ccdm_cuda_error_string"):
        assert f'extern "C" ' in text and f"{name}(" in text
    assert "torch/extension.h" not in text and "atomicAdd" not in text
    lib = _build.library_path("attn_block_large")
    assert lib.name == "libattn_block_large.so" and lib.parent != _build.library_path(
        "attn_block").parent


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    return torch.device("cuda")


def _check_forward(got, want, x, dtype):
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    else:  # relative to max(|y|, |y - x|), as chip_smoke.py states it
        scale = torch.maximum(want.abs(), (want - x.float()).abs())
        assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())


def _check_grad(got, want, dtype, name):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3, msg=name)
    else:
        torch.testing.assert_close(got, want, rtol=1e-1,
                                   atol=0.02 * max(float(want.abs().max()), 1.0), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(4, 4096, 64), (2, 2048, 128), (2, 100, 64)])
def test_cuda_kernels_match_plain_versions(cuda, b, n, c, dtype):
    dt = getattr(torch, dtype)
    x, w, dy = _inputs(np.random.default_rng(4), b, n, c)
    tx, tdy = (t.to(cuda) for t in _torch([x, dy], dt))
    g_pre, wqkv, wout, bout, g_out = (t.to(cuda) for t in _torch(w))
    before = [fn.launches for fn in (attn_block.attn_ctx_large, attn_block.attn_out_large,
                                     attn_block.attn_bwd_a, attn_block.attn_bwd_b)]

    a, s, kmax = attn_block.attn_ctx_large(tx, g_pre, wqkv, HEADS)
    ra, rs, rkmax = attn_block.ctx_large_reference(tx, g_pre, wqkv, HEADS)
    torch.testing.assert_close(kmax, rkmax, rtol=1e-5, atol=1e-5)
    _check_grad(s, rs, dtype, "s")
    _check_grad(a, ra, dtype, "a")

    ctx = attn_block.finalize_ctx(ra, rs, dt)
    y = attn_block.attn_out_large(tx, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    _check_forward(y, attn_block.out_large_reference(tx, g_pre, wqkv, ctx, wout, bout, g_out,
                                                     HEADS), tx, dtype)

    got = attn_block.attn_bwd_a(tx, tdy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    want = attn_block.bwd_a_reference(tx, tdy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    for name, gv, wv in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"), got, want):
        _check_grad(gv, wv, dtype, name)

    d_a, d_s = attn_block.finalize_ctx_backward(want[1], ra, rs)
    got = attn_block.attn_bwd_b(tx, tdy, want[0], g_pre, wqkv, ctx, wout, rkmax, d_a, d_s,
                                HEADS)
    ref = attn_block.bwd_b_reference(tx, tdy, want[0], g_pre, wqkv, ctx, wout, rkmax, d_a,
                                     d_s, HEADS)
    for name, gv, wv in zip(("dx", "d_wqkv", "d_gpre"), got, ref):
        _check_grad(gv, wv, dtype, name)
    torch.cuda.synchronize()
    after = [fn.launches for fn in (attn_block.attn_ctx_large, attn_block.attn_out_large,
                                    attn_block.attn_bwd_a, attn_block.attn_bwd_b)]
    assert after == [v + 1 for v in before]


@pytest.mark.cuda
def test_cuda_autograd_function_matches_reference_autograd(cuda):
    x, w, dy = _inputs(np.random.default_rng(5), 2, 4096, 64)
    fused = [t.to(cuda).requires_grad_() for t in _torch([x, *w])]
    plain = [t.to(cuda).requires_grad_() for t in _torch([x, *w])]
    y = attn_block.fused_attn_block(*fused, HEADS, D)
    assert type(y.grad_fn).__name__ == "_TwoPassBlockBackward"
    y.backward(torch.from_numpy(dy).to(cuda))
    attn_block.attn_block_reference(*plain, HEADS, D).backward(torch.from_numpy(dy).to(cuda))
    for name, t, r in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"), fused,
                          plain):
        _check_grad(t.grad, r.grad, "float32", name)

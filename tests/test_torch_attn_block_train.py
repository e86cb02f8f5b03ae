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

Both plain versions are also held at UK64's C 72 (dim 72), N 2048.
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


# (N, C): the 64x64 UNet's C 64, and UK64's C 72 (dim 72) at N 2048
TWO_PASS_CASES = [pytest.param(2048, 64, id="2048"), pytest.param(4096, 64, id="4096"),
                  pytest.param(2048, 72, id="2048-c72")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", TWO_PASS_CASES)
def test_plain_two_pass_forward_matches_pallas(jab, n, c, dtype):
    import jax.numpy as jnp

    x, w, _ = _inputs(np.random.default_rng(0), 2, n, c, 2.0 if dtype == "float32" else 1.0)
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


@pytest.mark.parametrize("dtype,n,c", [
    pytest.param(dtype, n, c, id=f"{dtype}-{n}" + ("-c72" if c == 72 else ""))
    for dtype, n, c in (("float32", 2048, 64), ("float32", 4096, 64), ("bfloat16", 2048, 64),
                        ("float32", 2048, 72), ("bfloat16", 2048, 72))])
def test_plain_fused_backward_matches_pallas(jab, n, c, dtype):
    import jax.numpy as jnp

    x, w, dy = _inputs(np.random.default_rng(1), 2, n, c)
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


@pytest.mark.parametrize("n,grad", [(2048, True), (2048, False), (1024, True)])
def test_dim_head_64_matches_jax(n, grad):
    """dim_head 64 (2 heads, F 128), C 64, f32, routed as at dim_head 32: at
    N 2048 the two-pass route (#2-#5's plain versions here, their CUDA-core
    routes on the card), at N 1024 the single-pass one. The value and all six
    gradients within 1e-5 of ccdm_tpu's fused_attn_block under jax.vjp;
    without a gradient, the value."""
    import jax
    import jax.numpy as jnp

    from ccdm_tpu.ops import attn_block as jax_attn_block

    heads, dim_head = 2, 64
    x, w, dy = _inputs(np.random.default_rng(7), 2, n, 64)
    y_jax, vjp = jax.vjp(lambda *a: jax_attn_block.fused_attn_block(*a, heads, dim_head),
                         jnp.asarray(x), *map(jnp.asarray, w))
    close = lambda got, want, name: torch.testing.assert_close(
        got, torch.from_numpy(np.array(want)), rtol=1e-5,
        atol=1e-5 * float(np.abs(np.asarray(want)).max()), msg=name)
    inputs = _torch([x, *w])
    if not grad:
        with torch.no_grad():
            close(attn_block.fused_attn_block(*inputs, heads, dim_head), y_jax, "y")
        return
    inputs = [t.requires_grad_() for t in inputs]
    y = attn_block.fused_attn_block(*inputs, heads, dim_head)
    assert type(y.grad_fn).__name__ == ("_TwoPassBlockBackward" if n % 2048 == 0 else
                                        "_SinglePassBlockBackward")
    close(y.detach(), y_jax, "y")
    y.backward(torch.from_numpy(dy))
    for name, t, ref in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"), inputs,
                            vjp(jnp.asarray(dy))):
        close(t.grad, ref, name)


def _unpadded_prenorm(x2d, g_pre):
    """xn with the row's squares halved at C // 2, no padding: warp_norm16's
    formula where C % 32 == 0, and not at C 72."""
    xf = x2d.float()
    sq, half = xf * xf, x2d.shape[-1] // 2
    lo, hi = torch.zeros_like(sq[..., 0]), torch.zeros_like(sq[..., 0])
    for j in range(half):
        lo, hi = lo + sq[..., j], hi + sq[..., half + j]
    inv = (1 / torch.sqrt(((lo + hi) / x2d.shape[-1] + 1e-12).double())).float()
    return xf * inv[..., None] * g_pre.float()


@pytest.mark.parametrize("c", [64, 128, 72])
def test_tensor_route_prenorm_is_the_kernels_formula(c):
    """tensor_route_prenorm as warp_norm16 forms xn at cp = pad32(C): at C
    72 bit-equal to a hand-written version (the squares zero-padded to 96,
    each half of 48 summed in order, the halves added, over the true C 72);
    at C 64 and 128 (no padding) bit-equal to the formula before padding."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(0, 1, (3, 50, c)).astype(np.float32)).bfloat16()
    g_pre = torch.from_numpy(rng.normal(1, 0.5, c).astype(np.float32))
    got = attn_block.tensor_route_prenorm(x, g_pre)
    if c % 32:
        xf = x.float()
        sq = torch.cat([xf * xf, torch.zeros(3, 50, 96 - c)], -1)
        lo, hi = torch.zeros(3, 50), torch.zeros(3, 50)
        for j in range(48):
            lo, hi = lo + sq[..., j], hi + sq[..., 48 + j]
        inv = (1 / torch.sqrt(((lo + hi) / c + 1e-12).double())).float()
        want = xf * inv[..., None] * g_pre
        assert not torch.equal(got, _unpadded_prenorm(x, g_pre))  # the halves moved
    else:
        want = _unpadded_prenorm(x, g_pre)
    assert torch.equal(got, want)


def _tensor_route_reference_matches_plain(c):
    x, w, _ = _inputs(np.random.default_rng(8), 2, 4096, c)
    tx = _torch([x], torch.bfloat16)[0]
    g_pre, wqkv = _torch([w[0], w[1]])
    got = attn_block.ctx_large_tensor_reference(tx, g_pre, wqkv, HEADS)
    want = attn_block.ctx_large_reference(tx, g_pre, wqkv, HEADS)
    for g, r in zip(got[:2], want[:2]):
        assert bool(((g - r).abs() <= 3e-2 * (r.abs() + r.abs().max())).all())
    diff, atol = (got[2] - want[2]).abs(), 1e-5 * float(want[2].abs().max())
    bad = diff > atol + 1e-5 * want[2].abs()
    xn = attn_block._prenorm(tx, g_pre)[2].bfloat16().float().abs()
    step = torch.where(xn > 0, torch.exp2(torch.floor(torch.log2(xn)) - 7), 0 * xn).amax(1)
    flip = (step[:, :, None] * wqkv[:, F:2 * F].abs()[None]).amax(1)
    assert not bool((bad & (diff > atol + flip)).any())
    assert int(bad.sum()) <= max(1, bad.numel() // 1000)


def test_tensor_route_reference_matches_plain():
    """The plain #2 at the rounding points of its bf16 tensor-core route
    (ctx_large_tensor_reference: xn as warp_norm16 forms it) against the
    plain #2 (ctx_large_reference) at phase 6's bounds: a and s within 3e-2
    of their largest value; kmax within 1e-5 of its largest |kmax| but in
    columns where the two round an element of xn to different bf16
    neighbours, each then within that step times its weight, at most 1 in
    1000 (chip_smoke.kmax_check). C 128."""
    _tensor_route_reference_matches_plain(128)


def test_tensor_route_reference_matches_plain_at_uk64():
    """The same at UK64's C 72, where the route pads xn's row to 96."""
    _tensor_route_reference_matches_plain(72)


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
    # bf16: kmax against the plain version at the kernel's rounding points
    own = (rkmax if dtype == "float32" else
           attn_block.ctx_large_tensor_reference(tx, g_pre, wqkv, HEADS)[2])
    torch.testing.assert_close(kmax, own, rtol=1e-5, atol=1e-5)
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(8, 4096, 64), (8, 4096, 128), (8, 2048, 64), (8, 4096, 72)])
def test_cuda_bwd_tensor_route_matches_plain(cuda, b, n, c):
    """#4 and #5 in bf16 at B 8 (the smallest batch of the checks), C 128
    (the 128x128 UNet's 64^2 up level) and C 72 (UK64's top level, padded to
    96 in shared memory): the tensor-core route, at the bf16 bound; #5
    nearer its plain version than one with d_a rounded to bf16."""
    x, w, dy = _inputs(np.random.default_rng(6), b, n, c)
    tx, tdy = (t.to(cuda) for t in _torch([x, dy], torch.bfloat16))
    g_pre, wqkv, wout, bout, g_out = (t.to(cuda) for t in _torch(w))
    for kernel in (4, 5):
        assert attn_block.large_plan(kernel, b, n, c, HEADS, torch.bfloat16).route == "tensor"
    ra, rs, rkmax = attn_block.ctx_large_reference(tx, g_pre, wqkv, HEADS)
    ctx = attn_block.finalize_ctx(ra, rs, torch.bfloat16)
    args_a = (tx, tdy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    want = attn_block.bwd_a_reference(*args_a)
    for name, gv, wv in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                            attn_block.attn_bwd_a(*args_a), want):
        _check_grad(gv, wv, "bfloat16", name)
    d_a, d_s = attn_block.finalize_ctx_backward(want[1], ra, rs)
    args_b = [tx, tdy, want[0], g_pre, wqkv, ctx, wout, rkmax, d_a, d_s, HEADS]
    got = attn_block.attn_bwd_b(*args_b)
    own = attn_block.bwd_b_reference(*args_b)
    args_b[8] = d_a.bfloat16().float()
    other = attn_block.bwd_b_reference(*args_b)
    for name, gv, wv, ov in zip(("dx", "d_wqkv", "d_gpre"), got, own, other):
        _check_grad(gv, wv, "bfloat16", name)
        near = float((gv.float() - wv.float()).abs().mean())
        assert near <= 0.25 * float((gv.float() - ov.float()).abs().mean()), name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(8, 4096, 64), (8, 4096, 128), (8, 2048, 64), (8, 4096, 72)])
def test_cuda_two_pass_tensor_route_matches_plain(cuda, b, n, c):
    """#2 and #3 in bf16 at B 8 on their tensor-core route (C 72, UK64's
    top level, padded to 96 in shared memory), at phase 6's
    bounds: kmax within 1e-5 of the plain version at the route's rounding
    points, a and s within 3e-2 of their largest value, y within 3e-2
    relative to max(|y|, |y - x|); and bit-equal with x (and y) one element
    past an aligned base, where the kernels take element loads and stores."""
    x, w, _ = _inputs(np.random.default_rng(9), b, n, c)
    tx = _torch([x], torch.bfloat16)[0].to(cuda)
    g_pre, wqkv, wout, bout, g_out = (t.to(cuda) for t in _torch(w))
    for kernel in (2, 3):
        assert attn_block.large_plan(kernel, b, n, c, HEADS, torch.bfloat16).route == "tensor"
    a, s, kmax = attn_block.attn_ctx_large(tx, g_pre, wqkv, HEADS)
    ra, rs, _ = attn_block.ctx_large_reference(tx, g_pre, wqkv, HEADS)
    own = attn_block.ctx_large_tensor_reference(tx, g_pre, wqkv, HEADS)[2]
    torch.testing.assert_close(kmax, own, rtol=1e-5, atol=1e-5 * float(own.abs().max()))
    for got, want in ((a, ra), (s, rs)):
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2 * float(want.abs().max()))
    ctx = attn_block.finalize_ctx(ra, rs, torch.bfloat16)
    args = (g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    y = attn_block.attn_out_large(tx, *args)
    _check_forward(y, attn_block.out_large_reference(tx, *args), tx, "bfloat16")

    xs = torch.empty(tx.numel() + 1, dtype=tx.dtype, device=cuda)[1:].view(b, n, c)
    xs.copy_(tx)
    assert xs.data_ptr() % 16
    for got, want in zip(attn_block.attn_ctx_large(xs, g_pre, wqkv, HEADS), (a, s, kmax)):
        assert torch.equal(got, want)
    assert torch.equal(attn_block.attn_out_large(xs, *args), y)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dim_head_64_runs_the_kernels(cuda, dtype):
    """dim_head 64 (2 heads) on the card at N 2048, C 64: every kernel's
    plan takes the CUDA cores; without a gradient one launch of #1, the
    value at the forward bound of the plain block; with one, #2 + #3 forward
    and #4 + #5 backward (one launch each), the value and the six gradients
    at the backward bounds of autograd through the plain block."""
    dt = getattr(torch, dtype)
    heads, dim_head, b, n, c = 2, 64, 2, 2048, 64
    x, w, dy = _inputs(np.random.default_rng(10), b, n, c)
    tx = _torch([x], dt)[0].to(cuda)
    ws = [t.to(cuda) for t in _torch(w)]
    assert attn_block.plan(b, n, c, heads, dt, dim_head).route == "cores"
    for kernel in (2, 3, 4, 5):
        assert attn_block.large_plan(kernel, b, n, c, heads, dt, dim_head).route == "cores"
    counters = (attn_block.fused_attn_block, attn_block.attn_ctx_large,
                attn_block.attn_out_large, attn_block.attn_bwd_a, attn_block.attn_bwd_b)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        y0 = attn_block.fused_attn_block(tx, *ws, heads, dim_head)
    assert [fn.launches - n0 for fn, n0 in zip(counters, before)] == [1, 0, 0, 0, 0]
    want = attn_block.attn_block_reference(*(t.float() for t in (tx, *ws)), heads, dim_head)
    _check_forward(y0, want, tx, dtype)
    leaves = [t.clone().requires_grad_() for t in (tx, *ws)]
    y = attn_block.fused_attn_block(*leaves, heads, dim_head)
    assert type(y.grad_fn).__name__ == "_TwoPassBlockBackward"
    y.backward(torch.from_numpy(dy).to(cuda).to(dt))
    torch.cuda.synchronize()
    assert [fn.launches - n0 for fn, n0 in zip(counters, before)] == [1, 1, 1, 1, 1]
    _check_forward(y.detach(), want, tx, dtype)
    plain = [t.detach().float().requires_grad_() for t in (tx, *ws)]
    attn_block.attn_block_reference(*plain, heads, dim_head).backward(
        torch.from_numpy(dy).to(cuda))
    for name, t, r in zip(("dx", "d_gpre", "d_wqkv", "d_wout", "d_bout", "d_gout"), leaves, plain):
        _check_grad(t.grad, r.grad, dtype, name)

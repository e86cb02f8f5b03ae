"""Port parity: standalone linear attention (ccdm_tpu_torch/ops/linear_attention.py)
and the LinearAttention module.

The plain versions of kernels #6, #7 + #8 and #9 are held against the JAX
kernels `_forward_pallas_fulllane`, `_forward_pallas_twopass` and
`_forward_pallas` run in interpret mode, as tests/test_linear_attention.py
runs them, at that file's bounds: f32 rtol 2e-3 / atol 1e-4 (the same
operands summed in another order), bf16 rtol 3e-2 and atol 3e-2 of the
largest |want| (an operand rounding may flip where the orders differ; the
outputs lie near 1e-2, so a fixed atol of 3e-2 would hold nothing). The dispatcher's route is held
to JAX's exactly, per shape and switch. The gradient of `linear_attention`
and the modules in f32 are held to JAX to 1e-5 (the same composition in
another framework). The CUDA kernels run only on the card: the tests marked
`cuda` hold them against the plain versions there, in bf16 also nearer
their own rounding points than the other kernels' (`_assert_rounding`), and
skip elsewhere. JAX
is imported only inside the tests that compare with it, so that on the
card, which has no JAX, the file runs as
`python -m pytest --noconftest tests/test_torch_linear_attention.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.models.layers import (FusedLinearAttentionBlock, LinearAttention,
                                          PreNormResidual)
from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops import linear_attention as la
from ccdm_tpu_torch.utils.convert import (prenorm_linear_attention_from_fused,
                                          state_dict_from_jax)

torch.set_num_threads(2)

F32 = dict(rtol=2e-3, atol=1e-4)


def _tol(want, dtype) -> dict:
    """F32, or in bf16 rtol 3e-2 and atol 3e-2 of max |want| (a numpy
    array or a tensor on any device)."""
    if dtype == "float32":
        return F32
    peak = want.float().abs().max() if isinstance(want, torch.Tensor) else np.abs(want).max()
    return dict(rtol=3e-2, atol=3e-2 * float(peak))


def _assert_rounding(got, own, other):
    """got (bf16) keeps its plain version's rounding points: its mean abs
    difference to `own` is at most a quarter of that to `other`, the same
    function rounded at other points."""
    near = float((got.float() - own.float()).abs().mean())
    far = float((got.float() - other.float()).abs().mean())
    assert near <= 0.25 * far, (near, far)


@pytest.fixture
def jla(monkeypatch):
    """The JAX module, with Pallas calls in interpret mode."""
    import jax.experimental.pallas as pl

    from ccdm_tpu.ops import linear_attention as jax_la

    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    return jax_la


def _qkv(seed, shape, std=2.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, std, shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the same values in `dtype`."""
    import jax.numpy as jnp

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype("float32"))


@pytest.mark.parametrize("h,d", [(4, 32), (2, 64), (8, 16), (1, 128)])
def test_plain_fulllane_matches_pallas_kernel(jla, h, d):
    (jq, jk, jv), (q, k, v) = _both(_qkv(h * d, (2, 64, h, d)), "float32")
    want = np.asarray(jla._forward_pallas_fulllane(jq, jk, jv))
    np.testing.assert_allclose(la.linear_attention_fulllane(q, k, v).numpy(), want, **F32)


def test_plain_fulllane_bf16_matches_pallas_kernel(jla):
    """bf16: the plain version follows #6's rounding points (k', v, ctx, q')."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(5, (2, 128, 4, 32)), "bfloat16")
    want = _np(jla._forward_pallas_fulllane(jq, jk, jv))
    got = la.linear_attention_fulllane(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **_tol(want, "bfloat16"))


@pytest.mark.parametrize("h,d", [(4, 32), (2, 64), (8, 16), (1, 128)])
def test_plain_per_head_matches_pallas_kernel(jla, h, d):
    (jq, jk, jv), (q, k, v) = _both(_qkv(10 + h, (2, 64, h, d)), "float32")
    want = np.asarray(jla._forward_pallas(jq, jk, jv))
    np.testing.assert_allclose(la.linear_attention_per_head(q, k, v).numpy(), want, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chunk", [(4096, 2048), (6144, 2048), (4096, 1024)])
def test_plain_twopass_matches_pallas_kernels(jla, n, chunk, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(n + chunk, (1, n, 4, 32)), dtype)
    want = _np(jla._forward_pallas_twopass(jq, jk, jv, chunk=chunk))
    got = la.linear_attention_twopass(q, k, v, chunk=chunk)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), want, **_tol(want, dtype))


@pytest.mark.parametrize("use_kernels,use_twopass", [(True, False), (True, True),
                                                     (False, True)])
@pytest.mark.parametrize("shape", [(1, 4096, 4, 32), (1, 8192, 4, 32), (1, 6144, 4, 32),
                                   (1, 16384, 4, 32), (1, 64, 4, 24), (1, 2048, 8, 32),
                                   (1, 4096, 8, 32), (1, 1024, 2, 64)])
def test_dispatcher_routes_as_jax(jla, monkeypatch, shape, use_kernels, use_twopass):
    """The route per shape and switch, with a CUDA tensor in place of the
    TPU backend, is JAX's exactly."""
    import jax
    import jax.numpy as jnp

    taken = []
    for name, tag in (("_forward_pallas_fulllane", "fulllane"),
                      ("_forward_pallas_twopass", "twopass"),
                      ("linear_attention_reference", "reference")):
        monkeypatch.setattr(jla, name, lambda q, k, v, _tag=tag: (taken.append(_tag), q)[1])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jla, "_USE_PALLAS", use_kernels)
    monkeypatch.setattr(jla, "_USE_TWOPASS", use_twopass)
    monkeypatch.setattr(la, "USE_KERNELS", use_kernels)
    monkeypatch.setattr(la, "USE_TWOPASS", use_twopass)
    q = jnp.zeros(shape, jnp.float32)
    jla.linear_attention(q, q, q)
    assert [la.route(shape, on_card=True)] == taken
    assert la.route(shape, on_card=False) == "reference"


def test_guard_routes_large_n_to_reference():
    """As tests/test_linear_attention.py:101: N H D past the cell guard runs
    the reference on the CPU without error."""
    assert la.MAX_CELL_ELEMS == 4096 * 128
    q = torch.zeros(1, 8192, 4, 32)
    assert la.route(q.shape, on_card=True) == "reference"  # twopass is off by default
    assert la.linear_attention(q, q, q).shape == (1, 8192, 4, 32)


def test_gradients_match_jax(jla):
    import jax
    import jax.numpy as jnp

    arrays = _qkv(3, (2, 64, 4, 8), std=1.0)
    g = np.random.default_rng(4).normal(size=(2, 64, 4, 8)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jla.linear_attention(a, b, c) * g),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (la.linear_attention(*ts) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _flax_variables(module, x):
    import jax

    variables = module.init(jax.random.PRNGKey(0), x)
    # move every leaf off its init value, so a mis-mapped gain or bias shows
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_unflatten(
        tree, [np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(np.float32)
               for v in leaves])


@pytest.mark.parametrize("prenorm", [False, True])
def test_modules_match_flax(prenorm):
    import jax.numpy as jnp

    from ccdm_tpu.models import layers as jl

    x = np.random.default_rng(8).normal(size=(2, 8, 8, 64)).astype(np.float32)
    jmod = jl.LinearAttention(64)
    port = LinearAttention(64)
    if prenorm:
        jmod, port = jl.PreNormResidual(64, jmod), PreNormResidual(64, port)
    variables = _flax_variables(jmod, jnp.asarray(x))
    port.load_state_dict(state_dict_from_jax(variables, port))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_prenorm_module_matches_fused_block():
    """PreNormResidual(LinearAttention) on weights mapped by JAX's
    fused_to_legacy computes the port's FusedLinearAttentionBlock; the port's
    own mapping gives the same weights."""
    from ccdm_tpu.utils.ckpt import fused_to_legacy

    rng = np.random.default_rng(9)
    c = 64
    block = FusedLinearAttentionBlock(c)
    fused = {"norm_g": 1 + 0.3 * rng.normal(size=c), "qkv_kernel": 0.1 * rng.normal(size=(c, 384)),
             "out_kernel": 0.1 * rng.normal(size=(128, c)), "out_bias": 0.1 * rng.normal(size=c),
             "out_norm_g": 1 + 0.3 * rng.normal(size=c)}
    fused = {k: v.astype(np.float32) for k, v in fused.items()}
    block.load_state_dict({k: torch.from_numpy(v) for k, v in fused.items()})
    legacy = fused_to_legacy({"attn": fused})["attn"]
    legacy["fn"] = legacy.pop("attn_inner")  # the inner module's place in the port
    module = PreNormResidual(c, LinearAttention(c))
    module.load_state_dict(state_dict_from_jax({"params": legacy}, module))
    mapped = prenorm_linear_attention_from_fused(block.state_dict())
    for key, value in module.state_dict().items():
        torch.testing.assert_close(mapped[key], value, rtol=0, atol=0)
    x = torch.from_numpy(rng.normal(size=(2, c, 8, 8)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(module(x), block(x), rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_other_devices_and_the_source_is_plain_c():
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        la.linear_attention_fulllane(q, q, q)
    src = (_build.CSRC_DIR / "linear_attention.cu").read_text()
    for name in ("ccdm_la_fulllane", "ccdm_la_per_head", "ccdm_la_ctx_twopass",
                 "ccdm_la_out_twopass", "ccdm_cuda_error_string"):
        assert f"{name}(" in src, name
    assert "torch" not in src  # a plain C interface: nvcc alone builds it
    assert _build.library_path("linear_attention").name == "liblinear_attention.so"


# ----------------------------------------------------- the card only


def _cuda_qkv(seed, shape, dtype):
    return [torch.from_numpy(a).cuda().to(getattr(torch, dtype))
            for a in _qkv(seed, shape, std=2.0 if dtype == "float32" else 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d", [(3, 1000, 4, 32), (2, 256, 2, 64), (2, 300, 8, 16),
                                     (1, 64, 1, 128), (2, 96, 16, 24)])
def test_cuda_fulllane_and_per_head_match_plain(b, n, h, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _cuda_qkv(b + n, (b, n, h, d), dtype)
    before = la.linear_attention_fulllane.launches, la.linear_attention_per_head.launches
    got6 = la.linear_attention_fulllane(q, k, v)
    got9 = la.linear_attention_per_head(q, k, v)
    torch.cuda.synchronize()
    assert (la.linear_attention_fulllane.launches,
            la.linear_attention_per_head.launches) == (before[0] + 1, before[1] + 1)
    want6, want9 = la.fulllane_reference(q, k, v), la.linear_attention_reference(q, k, v)
    torch.testing.assert_close(got6.float(), want6.float(), **_tol(want6, dtype))
    torch.testing.assert_close(got9.float(), want9.float(), **_tol(want9, dtype))
    if dtype == "bfloat16":  # #6 rounds k', v, ctx and q'; #9 only its output
        _assert_rounding(got6, want6, want9)
        _assert_rounding(got9, want9, want6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chunk", [(4096, 2048), (6144, 2048), (5000, 1024)])
def test_cuda_twopass_matches_plain(n, chunk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    q, k, v = _cuda_qkv(n, (2, n, 4, 32), dtype)
    m = k.amax(1).float().reshape(2, 128)
    a, s = la.linear_attention_ctx_twopass(k, v, m, chunk)
    ra, rs = la.ctx_twopass_reference(k, v, m)
    torch.testing.assert_close(a, ra, rtol=2e-3, atol=1e-4 * float(ra.abs().max()))
    torch.testing.assert_close(s, rs, rtol=2e-3, atol=1e-4 * float(rs.abs().max()))
    ctx = la.finalize_ctx(ra, rs, q.dtype)
    out, want = la.linear_attention_out_twopass(q, ctx), la.out_twopass_reference(q, ctx)
    torch.testing.assert_close(out.float(), want.float(), **_tol(want, dtype))
    if dtype == "bfloat16":  # #7 rounds exp(k - m), s sums it unrounded; #8 rounds q'
        e = torch.exp(k.float() - m.view(2, 1, 4, 32))
        _assert_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()))
        _assert_rounding(s, rs, e.bfloat16().float().sum(1).reshape(2, 128))
        _assert_rounding(out, want, torch.einsum("bnhd,bhde->bnhe", la._q_prime(
            q, torch.float32), ctx.float()).to(q.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d,dtype,route", [
    (3, 1000, 4, 32, "bfloat16", "tensor"), (2, 256, 2, 64, "bfloat16", "tensor"),
    (2, 300, 8, 16, "bfloat16", "tensor"), (1, 64, 1, 128, "bfloat16", "tensor"),
    (2, 96, 16, 8, "bfloat16", "cores"), (2, 96, 16, 24, "bfloat16", "cores"),
    (3, 1000, 4, 32, "float32", "cores")])
def test_cuda_la_plan_route_and_one_launch_a_call(b, n, h, d, dtype, route):
    """la_plan's route of #6 and #8 on the card (the tensor cores for bf16 at
    D % 16 == 0), one launch of each counter a call, and on the tensor route
    #6 and #8 against their plain versions (la_check's bounds, nearer their
    own rounding points than the f32 function's), #6 the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    plan = la.la_plan(b, n, h, d, dt)
    assert plan.route == route and plan.ctx_splits >= 1 and plan.out_splits >= 1
    q, k, v = _cuda_qkv(3 * n + d, (b, n, h, d), dtype)
    ctx = la.finalize_ctx(*la.ctx_twopass_reference(k, v, k.float().amax(1).reshape(b, h * d)),
                          dt)
    before = la.linear_attention_fulllane.launches, la.linear_attention_out_twopass.launches
    got6, again = la.linear_attention_fulllane(q, k, v), la.linear_attention_fulllane(q, k, v)
    got8 = la.linear_attention_out_twopass(q, ctx)
    torch.cuda.synchronize()
    assert (la.linear_attention_fulllane.launches,
            la.linear_attention_out_twopass.launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got6, again)
    want6, want8 = la.fulllane_reference(q, k, v), la.out_twopass_reference(q, ctx)
    torch.testing.assert_close(got6.float(), want6.float(), **_tol(want6, dtype))
    torch.testing.assert_close(got8.float(), want8.float(), **_tol(want8, dtype))
    if dtype == "bfloat16":
        _assert_rounding(got6, want6, la.linear_attention_reference(q, k, v))
        _assert_rounding(got8, want8, torch.einsum("bnhd,bhde->bnhe", la._q_prime(
            q, torch.float32), ctx.float()).to(q.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d,dtype,route7,route9", [
    (3, 1000, 4, 32, "bfloat16", "tensor", "rows"), (2, 256, 2, 64, "bfloat16", "tensor", "rows"),
    (2, 300, 8, 16, "bfloat16", "tensor", "rows"), (1, 64, 1, 128, "bfloat16", "tensor", "rows"),
    (2, 500, 2, 48, "bfloat16", "tensor", "rows"), (2, 96, 16, 24, "bfloat16", "cores", "cores"),
    (3, 1000, 4, 32, "float32", "cores", "cores")])
def test_cuda_twopass_and_per_head_routes(b, n, h, d, dtype, route7, route9):
    """twopass_plan's route of #7 and per_head_plan's of #9 on the card (the
    tensor cores and whole rows in f32 for bf16 at D % 16 == 0), one launch
    of each counter a call, each against its plain version (in bf16 nearer
    its own rounding points than the other ones) and the same bits twice;
    #7's m is colmax + 0.5, which it uses as given."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    assert la.twopass_plan(b, n, h, d, 2048, dt).route == route7
    assert la.per_head_plan(b, n, h, d, dt).route == route9
    q, k, v = _cuda_qkv(5 * n + d, (b, n, h, d), dtype)
    m = k.float().amax(1).reshape(b, h * d) + 0.5
    before = la.linear_attention_ctx_twopass.launches, la.linear_attention_per_head.launches
    (a, s), (a2, s2) = (la.linear_attention_ctx_twopass(k, v, m) for _ in range(2))
    got9, again9 = la.linear_attention_per_head(q, k, v), la.linear_attention_per_head(q, k, v)
    torch.cuda.synchronize()
    assert (la.linear_attention_ctx_twopass.launches,
            la.linear_attention_per_head.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(a, a2) and torch.equal(s, s2) and torch.equal(got9, again9)
    ra, rs = la.ctx_twopass_reference(k, v, m)
    torch.testing.assert_close(a, ra, rtol=2e-3, atol=1e-4 * float(ra.abs().max()))
    torch.testing.assert_close(s, rs, rtol=2e-3, atol=1e-4 * float(rs.abs().max()))
    want9 = la.linear_attention_reference(q, k, v)
    torch.testing.assert_close(got9.float(), want9.float(), **_tol(want9, dtype))
    if dtype == "bfloat16":
        e = torch.exp(k.float() - m.view(b, 1, h, d))
        _assert_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()))
        _assert_rounding(s, rs, e.bfloat16().float().sum(1).reshape(b, h * d))
        _assert_rounding(got9, want9, la.fulllane_reference(q, k, v))

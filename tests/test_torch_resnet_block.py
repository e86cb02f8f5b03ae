"""Port parity: the fused resnet block (ccdm_tpu_torch/ops/resnet_block.py).

The plain versions of kernels #10 and #11, composed as the port composes
them, are held against the JAX kernels `_forward_pallas` run in interpret
mode as tests/test_resnet_block.py runs them, at that file's bounds: f32
rtol 2e-3 / atol 2e-4, bf16 4e-2 (the same operands summed in another
order; in bf16 an output rounding may flip one unit in the last place).
The autograd Function's gradients are held against jax.vjp of JAX's
`fused_resnet_block` to 1e-5 in f32 (both recompute the same reference
composition), and the UNet with the switch on against the JAX UNet to 1e-4
in f32 (the bound of tests/test_torch_unet.py). The CUDA kernels run only
on the card: the tests marked `cuda` hold them against the plain versions
there and skip elsewhere. JAX is imported only inside the tests that
compare with it, so that on the card, which has no JAX, the file runs as
`python -m pytest --noconftest tests/test_torch_resnet_block.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops import resnet_block as rb

torch.set_num_threads(2)


def _case(rng, b, hh, ww, cin, cout, x_std=1.0):
    """numpy inputs in the JAX layouts: x [B, HW, Cin], HWIO kernels,
    wres [Cin, Cout]."""
    f = lambda *shape, s=1.0: (rng.normal(0, s, shape)).astype(np.float32)
    return dict(x=f(b, hh * ww, cin, s=x_std), scale=f(b, cout, s=0.3), shift=f(b, cout, s=0.3),
                w1=f(3, 3, cin, cout, s=0.2), b1=f(cout, s=0.1), g1=1 + f(cout, s=0.5),
                w2=f(3, 3, cout, cout, s=0.2), b2=f(cout, s=0.1), g2=1 + f(cout, s=0.5),
                wres=f(cin, cout, s=0.2), bres=f(cout, s=0.1))


def _port_block(c, hh, ww, has_res, dtype=torch.float32, requires_grad=False):
    """The case as the port's block takes it: x NCHW (channels_last), OIHW
    kernels, wres [Cout, Cin, 1, 1] or None."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    b, _, cin = c["x"].shape
    x = t(c["x"]).to(dtype).view(b, hh, ww, cin).permute(0, 3, 1, 2)
    args = [x, t(c["scale"]), t(c["shift"]), t(c["w1"].transpose(3, 2, 0, 1)), t(c["b1"]),
            t(c["g1"]), t(c["w2"].transpose(3, 2, 0, 1)), t(c["b2"]), t(c["g2"]),
            t(c["wres"].T[:, :, None, None]) if has_res else None,
            t(c["bres"]) if has_res else None]
    if requires_grad:
        args = [a if a is None else a.detach().requires_grad_() for a in args]
    return args


def _to_x2d(y):
    b, cout, hh, ww = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, hh * ww, cout)


@pytest.fixture
def jrb(monkeypatch):
    """The JAX module, with Pallas calls in interpret mode."""
    import jax.experimental.pallas as pl

    from ccdm_tpu.ops import resnet_block as jax_rb

    orig_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    return jax_rb


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(rb, "USE_FUSED", True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,hh,ww", [(16, 16, 8, 8), (8, 16, 8, 16)])
def test_plain_halves_match_pallas_kernels(jrb, fused, cin, cout, hh, ww, dtype):
    import jax.numpy as jnp

    c = _case(np.random.default_rng(cin * 100 + ww), 2, hh, ww, cin, cout)
    has_res = cin != cout
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jrb._forward_pallas(
        jnp.asarray(c["x"]).astype(jdt), *(jnp.asarray(c[k]) for k in
                                           ("scale", "shift", "w1", "b1", "g1", "w2", "b2",
                                            "g2")),
        jnp.asarray(c["wres"]) if has_res else None, jnp.asarray(c["bres"]) if has_res else None,
        hh, ww).astype(jnp.float32))
    with torch.no_grad():
        got = _to_x2d(rb.fused_resnet_block(*_port_block(c, hh, ww, has_res,
                                                         getattr(torch, dtype))))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == "float32" else dict(rtol=4e-2, atol=4e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_corner_impulses_match_pallas_kernels(jrb, fused):
    """An impulse at each corner of an 8x8 map: the SAME-padded response,
    with no wraparound (tests/test_resnet_block.py:97-122)."""
    import jax.numpy as jnp

    hh = ww = cin = cout = 8
    c = _case(np.random.default_rng(0), 1, hh, ww, cin, cout)
    c["scale"] = c["shift"] = np.zeros((1, cout), np.float32)
    for pos in (0, ww - 1, (hh - 1) * ww, hh * ww - 1):
        c["x"] = np.zeros((1, hh * ww, cin), np.float32)
        c["x"][0, pos, :] = 3.0
        want = np.asarray(jrb._forward_pallas(
            *(jnp.asarray(c[k]) for k in ("x", "scale", "shift", "w1", "b1", "g1", "w2", "b2",
                                          "g2")), None, None, hh, ww))
        with torch.no_grad():
            got = _to_x2d(rb.fused_resnet_block(*_port_block(c, hh, ww, False)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_autograd_function_matches_jax_vjp(jrb, fused, cin, cout):
    import jax
    import jax.numpy as jnp

    hh, ww = 8, 8
    rng = np.random.default_rng(5)
    c = _case(rng, 2, hh, ww, cin, cout)
    has_res = cin != cout
    dy = rng.normal(size=(2, hh * ww, cout)).astype(np.float32)
    names = ("x", "scale", "shift", "w1", "b1", "g1", "w2", "b2", "g2", "wres", "bres")
    _, vjp = jax.vjp(lambda *a: jrb.fused_resnet_block(*a, hh, ww, has_res),
                     *(jnp.asarray(c[k]) for k in names))
    want = vjp(jnp.asarray(dy))

    args = _port_block(c, hh, ww, has_res, requires_grad=True)
    y = rb.fused_resnet_block(*args)
    assert type(y.grad_fn).__name__ == "_FusedBlockBackward"
    y.backward(torch.from_numpy(dy).view(2, hh, ww, cout).permute(0, 3, 1, 2))
    got = [_to_x2d(args[0].grad), args[1].grad, args[2].grad,
           args[3].grad.permute(2, 3, 1, 0), *(a.grad for a in args[4:6]),
           args[6].grad.permute(2, 3, 1, 0), *(a.grad for a in args[7:9])]
    if has_res:
        got += [args[9].grad[:, :, 0, 0].T, args[10].grad]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_unet_with_the_switch_on_matches_jax_unet(fused):
    """A dim-8 UNet (mults (1, 2), 16x16: seven resnet blocks, both
    residuals) with kernels #10 + #11 in their plain versions, against the
    JAX Unet on the same converted weights, f32 to 1e-4."""
    import jax
    import jax.numpy as jnp

    from ccdm_tpu.models import Unet as JaxUnet
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.utils.convert import unet_state_dict_from_jax

    cfg = dict(dim=8, dim_mults=(1, 2), in_channels=3)
    jmodel = JaxUnet(**cfg)
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 128)),
        None, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) >= 2:
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "bias" in name or "mean" in name or "null" in name:
            return rng.normal(0, 0.2, shape).astype(np.float32)
        return (1 + rng.normal(0, 0.2, shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    x = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 40, 999])
    emb = rng.uniform(size=(3, 128)).astype(np.float32)
    keep = np.array([True, False, True])
    want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, x, t, emb, keep))

    model = Unet(**cfg)
    model.load_state_dict(unet_state_dict_from_jax(variables, model))
    launches = rb.resnet_half_a.launches, rb.resnet_half_b.launches
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, emb, keep))).numpy()
    assert (rb.resnet_half_a.launches, rb.resnet_half_b.launches) == launches  # CPU: plain
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_switch_routes_off_to_reference_and_on_to_the_halves(monkeypatch):
    c = _case(np.random.default_rng(2), 2, 4, 4, 8, 16)
    args = _port_block(c, 4, 4, True)
    calls = []
    for name in ("resnet_block_reference", "half_a_reference", "half_b_reference"):
        real = getattr(rb, name)
        monkeypatch.setattr(rb, name, lambda *a, _real=real, _name=name: (
            calls.append(_name), _real(*a))[1])
    with torch.no_grad():
        off = rb.fused_resnet_block(*args)
        assert calls == ["resnet_block_reference"]
        monkeypatch.setattr(rb, "USE_FUSED", True)
        on = rb.fused_resnet_block(*args)
    assert calls[1:] == ["half_a_reference", "half_b_reference"]
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rb.resnet_half_a(torch.zeros(1, 16, 8, device="meta"), *args[1:3],
                         rb.conv_taps(args[3]), *args[4:6], 4, 4)


def test_kernel_source_exports_both_entry_points():
    src = (_build.CSRC_DIR / "resnet_block.cu").read_text()
    for name in ("ccdm_resnet_half_a", "ccdm_resnet_half_b", "ccdm_cuda_error_string"):
        assert f'extern "C" ' in src and f"{name}(" in src, name
    assert "torch" not in src  # a plain C interface: nvcc alone builds it
    path = _build.library_path("resnet_block")
    assert path.name == "libresnet_block.so" and _build.BUILD_ROOT in path.parents


def _cuda_case(b, hh, ww, cin, cout, dtype):
    c = _case(np.random.default_rng(b + hh + cin), b, hh, ww, cin, cout)
    dt = getattr(torch, dtype)
    t = lambda k, to=dt: torch.from_numpy(c[k]).cuda().to(to)
    w1 = t("w1").reshape(9 * cin, cout)
    w2 = t("w2").reshape(9 * cout, cout)
    has_res = cin != cout
    return (t("x"), t("scale", torch.float32), t("shift", torch.float32), w1,
            t("b1", torch.float32), t("g1", torch.float32), w2, t("b2", torch.float32),
            t("g2", torch.float32), t("wres") if has_res else None,
            t("bres", torch.float32) if has_res else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww,cin,cout", [(8, 64, 64, 128, 64), (16, 8, 8, 384, 256),
                                              (16, 4, 4, 512, 512), (3, 5, 7, 20, 40)])
def test_cuda_kernels_match_plain_versions(b, hh, ww, cin, cout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False  # the plain convs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    x, scale, shift, w1, b1, g1, w2, b2, g2, wres, bres = _cuda_case(b, hh, ww, cin, cout, dtype)
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == "float32" else dict(rtol=4e-2, atol=4e-2)
    before = rb.resnet_half_a.launches, rb.resnet_half_b.launches
    h1 = rb.resnet_half_a(x, scale, shift, w1, b1, g1, hh, ww)
    y = rb.resnet_half_b(h1, x, w2, b2, g2, wres, bres, hh, ww)
    torch.cuda.synchronize()
    assert (rb.resnet_half_a.launches, rb.resnet_half_b.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    torch.testing.assert_close(h1.float(), rb.half_a_reference(
        x, scale, shift, w1, b1, g1, hh, ww).float(), **tol)
    torch.testing.assert_close(y.float(), rb.half_b_reference(
        h1, x, w2, b2, g2, wres, bres, hh, ww).float(), **tol)


@pytest.mark.cuda
def test_cuda_switch_on_block_matches_reference_with_gradients(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    c = _case(np.random.default_rng(11), 4, 16, 16, 64, 128)
    args = [a if a is None else a.cuda().detach().requires_grad_()
            for a in _port_block(c, 16, 16, True)]
    ref_args = [a.detach().clone().requires_grad_() for a in args]
    monkeypatch.setattr(rb, "USE_FUSED", True)
    before = rb.resnet_half_a.launches
    y = rb.fused_resnet_block(*args)
    assert rb.resnet_half_a.launches == before + 1
    want = rb.resnet_block_reference(*ref_args)
    torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-4)
    dy = torch.randn_like(want)
    y.backward(dy)
    want.backward(dy)
    for a, r in zip(args, ref_args):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-4, atol=1e-4)

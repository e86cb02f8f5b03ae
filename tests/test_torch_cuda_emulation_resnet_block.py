"""Kernels #10 and #11 (csrc/resnet_block.cu, the fused resnet block's two
halves) compiled for the CPU behind the emulation of tests/torch_emulation.py
and held against their plain versions at the bounds of
tests/test_resnet_block.py (f32 rtol 2e-3 / atol 2e-4, bf16 4e-2): the f32
route, the fused and split tensor-core routes, and the C plan at the UNet's
resnet shapes.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from tests.torch_emulation import call, compile_emulated

torch.set_num_threads(2)


RESNET_ROUTES = ("f32", "fused", "split")


@pytest.fixture(scope="module")
def emulated_resnet(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import resnet_block as rb

    return rb.declare(compile_emulated(tmp_path_factory.mktemp("cuda_emu_resnet"), "resnet_block"))


def _resnet_plan(lib, half_b, b, hh, ww, cin, cout, has_res, bf16):
    """(route, workspace) of the library's plan for one call."""
    out = (ctypes.c_int * 4)()
    nbytes = lib.ccdm_resnet_plan(half_b, b, hh, ww, cin, cout, has_res, bf16, out)
    return RESNET_ROUTES[out[0]], torch.empty(nbytes // 4), nbytes


def _resnet_halves(lib, b, hh, ww, cin, cout, dtype, x_offset=0):
    """Both halves in the emulation against their plain versions, at the
    bounds of tests/test_resnet_block.py (f32 rtol 2e-3 / atol 2e-4, bf16
    4e-2); x at `x_offset` elements past an aligned base. Returns the routes
    the two calls took."""
    from ccdm_tpu_torch.ops import resnet_block as rb

    rng = np.random.default_rng(b * 1000 + cin)
    dt = getattr(torch, dtype)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = torch.empty(b * hh * ww * cin + x_offset, dtype=dt)[x_offset:].view(b, hh * ww, cin)
    x.copy_(f32(rng.normal(size=(b, hh * ww, cin))))
    scale, shift = f32(0.3 * rng.normal(size=(b, cout))), f32(0.3 * rng.normal(size=(b, cout)))
    w1 = f32(rng.normal(0, 0.2, (9 * cin, cout))).to(dt)
    w2 = f32(rng.normal(0, 0.2, (9 * cout, cout))).to(dt)
    b1, b2 = f32(0.1 * rng.normal(size=cout)), f32(0.1 * rng.normal(size=cout))
    g1, g2 = f32(1 + 0.5 * rng.normal(size=cout)), f32(1 + 0.5 * rng.normal(size=cout))
    has_res = cin != cout
    wres = f32(rng.normal(0, 0.2, (cin, cout))).to(dt) if has_res else None
    bres = f32(0.1 * rng.normal(size=cout)) if has_res else None
    bf16 = int(dtype == "bfloat16")
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == "float32" else dict(rtol=4e-2, atol=4e-2)

    route_a, ws, nbytes = _resnet_plan(lib, 0, b, hh, ww, cin, cout, 0, bf16)
    h1 = torch.empty(b, hh * ww, cout, dtype=dt)
    call(lib, "ccdm_resnet_half_a", x, scale, shift, w1, b1, g1, h1, ws,
          b, hh, ww, cin, cout, bf16, nbytes)
    want_h1 = rb.half_a_reference(x, scale, shift, w1, b1, g1, hh, ww)
    assert bool(torch.isfinite(h1.float()).all())
    torch.testing.assert_close(h1.float(), want_h1.float(), **tol)

    route_b, ws, nbytes = _resnet_plan(lib, 1, b, hh, ww, cin, cout, int(has_res), bf16)
    y = torch.empty(b, hh * ww, cout, dtype=dt)
    call(lib, "ccdm_resnet_half_b", want_h1, x, w2, b2, g2, wres, bres, y, ws,
          b, hh, ww, cin, cout, int(has_res), bf16, nbytes)
    want = rb.half_b_reference(want_h1, x, w2, b2, g2, wres, bres, hh, ww)
    assert bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), want.float(), **tol)
    return route_a, route_b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww,cin,cout", [
    (2, 9, 9, 24, 64),   # projection residual; f32: 162 pixels over two 128-pixel tiles
    (2, 6, 6, 128, 128),  # identity residual; f32: 72 pixels over two 64-pixel tiles
    (3, 4, 5, 20, 40),   # Cout 40: f32 one thread of the block idle; bf16 element loads
])
def test_emulated_resnet_halves_match_plain(emulated_resnet, b, hh, ww, cin, cout, dtype):
    """Kernels #10 and #11 against their plain versions: tiles that cross
    an image and the map border, part K slices, both residuals. In bf16 these
    small grids take the split route. Bounds of tests/test_resnet_block.py:
    f32 rtol 2e-3 / atol 2e-4, bf16 4e-2."""
    routes = _resnet_halves(emulated_resnet, b, hh, ww, cin, cout, dtype)
    assert routes == (("f32",) * 2 if dtype == "float32" else ("split",) * 2)


@pytest.mark.parametrize("b,hh,ww,cin,cout,wave,x_offset,route", [
    (2, 8, 8, 32, 64, 1, 0, "fused"),     # 128 x 64 tiles, projection, 16-byte copies
    (1, 8, 8, 128, 128, 1, 0, "fused"),   # 64 x 128 tiles, identity residual
    (1, 6, 7, 20, 40, 1, 0, "fused"),     # Cin 20: element loads, a part tile
    (2, 8, 8, 32, 64, 1, 1, "fused"),     # x not 16-byte aligned: element loads
    (2, 4, 4, 64, 256, 132, 0, "split"),  # Cout above the 128-channel tile, projection slab
    (1, 4, 4, 256, 256, 132, 0, "split"),  # identity residual, 8 K splits
])
def test_emulated_resnet_bf16_routes_match_plain(emulated_resnet, b, hh, ww, cin, cout, wave,
                                                 x_offset, route):
    """The tensor-core route of #10 and #11 in the emulation (mma.sync,
    ldmatrix and cp.async with the ISA's fragment layouts): the fused route,
    reached at a few blocks by lowering the plan's wave, and the split route,
    both at the card's bf16 bound of 4e-2."""
    emulated_resnet.ccdm_resnet_set_wave(wave)
    try:
        routes = _resnet_halves(emulated_resnet, b, hh, ww, cin, cout, "bfloat16", x_offset)
    finally:
        emulated_resnet.ccdm_resnet_set_wave(132)
    assert routes == (route, route)


# (H = W, Cin, Cout) of the RC-49 64x64 UNet's 23 resnet blocks (chip_smoke.RESNET_SHAPES)
UNET_RESNET_SHAPES = [(64, 64, 64), (64, 128, 64), (32, 64, 64), (32, 192, 128),
                      (16, 128, 128), (16, 256, 128), (8, 128, 128), (8, 384, 256),
                      (4, 256, 256), (4, 512, 512), (4, 768, 512)]


@pytest.mark.parametrize("batch", [64, 128, 72, 8])
def test_emulated_resnet_plan_at_the_unet_shapes(emulated_resnet, batch):
    """The C plan at the batches the main paths give #10 and #11 (served,
    trained, the EMA grid, the eval sampling): fused exactly where Cout <=
    128 gives a wave of 132 blocks (128-pixel tiles at Cout 64, 64 at 128),
    else split into 64 x 128 tiles with 1-8 K splits of at least 4 of the 64-
    channel K slices, the workspace [splits (+1 projection slab), M, Cout]
    f32 (16.8 MB at most, at 4x4 and B 128); f32 always on the CUDA cores."""
    for hh, cin, cout in UNET_RESNET_SHAPES:
        m, has_res = batch * hh * hh, cin != cout
        for half_b in (0, 1):
            out = (ctypes.c_int * 4)()
            nbytes = emulated_resnet.ccdm_resnet_plan(half_b, batch, hh, hh, cin, cout,
                                                      int(has_res and half_b), 1, out)
            route, bm, bn, splits = RESNET_ROUTES[out[0]], out[1], out[2], out[3]
            tile = 128 if cout <= 64 else 64
            if cout <= 128 and -(-m // tile) >= 132:
                assert (route, bm, bn, nbytes) == ("fused", tile, 8192 // tile, 0)
            else:
                k_slices = 9 * -(-(cout if half_b else cin) // 64)
                assert (route, bm, bn) == ("split", 64, 128)
                assert 1 <= splits <= min(8, max(1, k_slices // 4))
                assert nbytes == (splits + int(has_res and half_b)) * m * cout * 4
                assert nbytes <= 16.8e6
            if batch == 64:
                assert route == ("fused" if hh >= 16 else "split"), (hh, cin, cout)
            f32 = (ctypes.c_int * 4)()
            assert emulated_resnet.ccdm_resnet_plan(half_b, batch, hh, hh, cin, cout, 0, 0,
                                                    f32) == 0 and f32[0] == 0

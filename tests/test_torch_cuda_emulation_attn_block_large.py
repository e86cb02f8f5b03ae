"""Kernels #2-#5 (csrc/attn_block_large.cu, the two-pass training path)
compiled for the CPU behind the emulation of tests/torch_emulation.py and
held against their plain versions: the CUDA-core routes in f32 and at other
head counts, the tensor-core routes in bf16 (C padded to whole 32-column
blocks at C % 8 == 0; several tiles a split through a library built with a
wave of two blocks), and the C plans at the UNets' two-pass shapes and the
batches the main paths give them.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from tests.torch_emulation import D, F, HEADS, call, compile_emulated, unet_attn_shapes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_large(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare_large(compile_emulated(tmp_path_factory.mktemp("cuda_emu_large"),
                                     "attn_block_large"))


@pytest.fixture(scope="module")
def emulated_large_short(tmp_path_factory):
    """#2-#5's library with a wave of 2 blocks: several tiles a split at
    short rows (splits = min(tiles, 2 blocks an SM x 2 // B) at C <= 64)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare_large(compile_emulated(tmp_path_factory.mktemp("cuda_emu_large_short"),
                                     "attn_block_large",
                                     {"constexpr int kWave = 132;": "constexpr int kWave = 2;"}))


def _large_case(b, n, c, dtype, seed=0, jump=None, heads=HEADS):
    """Inputs of kernels #2-#5 as the wrappers pass them (matrices in the
    activation dtype, vectors f32) and the plain versions' intermediates.
    With `jump` a token: channel 0 of x is 0 before it and 30 from it on,
    its gain 1.5 and its row of Wk 20 times larger, so that k rises by tens
    there and the online softmax must rescale what it has summed."""
    from ccdm_tpu_torch.ops import attn_block as ab

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    assert F % heads == 0  # F 128 at every head count: dim_head F / heads
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    xa, gp, wa = rng.normal(0, 1.0, (b, n, c)), 1 + 0.5 * rng.normal(size=c), 0.1 * rng.normal(size=(c, 3 * F))
    if jump is not None:
        xa[:, :jump, 0], xa[:, jump:, 0] = 0.0, 30.0
        gp[0] = 1.5
        wa[0, F:2 * F] *= 20
    x = f32(xa).to(dt)
    g_pre, g_out = f32(gp), f32(1 + 0.5 * rng.normal(size=c))
    wqkv, wout = f32(wa).to(dt), f32(0.1 * rng.normal(size=(F, c))).to(dt)
    bout = f32(0.1 * rng.normal(size=c))
    dy = f32(rng.normal(size=(b, n, c))).to(dt)
    a, s, kmax = ab.ctx_large_reference(x, g_pre, wqkv, heads)
    ctx = ab.finalize_ctx(a, s, dt)
    do, d_ctx, *_ = ab.bwd_a_reference(x, dy, g_pre, wqkv, ctx, wout, bout, g_out, heads)
    d_a, d_s = ab.finalize_ctx_backward(d_ctx, a, s)
    return dict(x=x, g_pre=g_pre, wqkv=wqkv, wout=wout, bout=bout, g_out=g_out, dy=dy,
                a=a, s=s, kmax=kmax, ctx=ctx, do=do, d_a=d_a.contiguous(), d_s=d_s.contiguous(),
                heads=heads)


def _close(got, want, dtype, what):
    """f32: the same operands summed in another order; bf16: an operand
    rounding may flip where the orders differ (tests/test_attn_block.py:301-308)."""
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), what
    scale = max(float(want.abs().max()), 1e-30)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale, msg=what)
    else:
        torch.testing.assert_close(got, want, rtol=1e-1, atol=0.02 * max(scale, 1.0), msg=what)


def _ctx_large(lib, x, g_pre, wqkv, bf16, heads=HEADS):
    """#2 in the emulation, with the workspace its plan sizes: (kmax, s, a)."""
    b, n, c = x.shape
    d = F // heads
    nbytes = _large_plan(lib, 2, b, n, c, bf16, heads, d)[4]
    kmax, s, a = torch.empty(b, F), torch.empty(b, F), torch.empty(b, heads, d, d)
    call(lib, "ccdm_attn_ctx_large", x, g_pre, wqkv, kmax, s, a, torch.empty(-(-nbytes // 4)),
          b, n, c, heads, d, bf16, nbytes)
    return kmax, s, a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (1, 80, 64)])
def test_emulated_two_pass_forward_matches_plain(emulated_large, b, n, c, dtype):
    from ccdm_tpu_torch.ops import attn_block as ab

    k = _large_case(b, n, c, dtype)
    bf16 = int(dtype == "bfloat16")
    kmax, s, a = _ctx_large(emulated_large, k["x"], k["g_pre"], k["wqkv"], bf16)
    torch.testing.assert_close(kmax, k["kmax"], rtol=1e-5, atol=1e-5)
    _close(s, k["s"], dtype, "s")
    _close(a, k["a"], dtype, "a")

    y = torch.empty_like(k["x"])
    call(emulated_large, "ccdm_attn_out_large", k["x"], k["g_pre"], k["wqkv"], k["ctx"],
          k["wout"], k["bout"], k["g_out"], y, b, n, c, HEADS, D, bf16)
    want = ab.out_large_reference(k["x"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
                                  k["bout"], k["g_out"], HEADS)
    if dtype == "float32":
        torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-4)
    else:
        scale = torch.maximum(want.float().abs(), (want.float() - k["x"].float()).abs())
        assert bool(((y.float() - want.float()).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.parametrize("lib,b,n,c,splits,x_offset,jump", [
    ("", 1, 200, 64, 2, 0, None),       # a ragged last tile of 72 tokens; two splits merged in order
    ("", 1, 200, 32, 2, 0, None),       # ... at C 32, the Cell-200 teacher's top level
    ("", 2, 80, 128, 1, 0, None),       # C 128: Wkv, Wq and Wout resident, one ragged tile a row
    ("", 1, 300, 96, 3, 0, None),       # C 96, three splits; the last tile's 44 tokens end in warp 2
    ("", 1, 200, 64, 2, 1, None),       # x one element past an aligned base: element loads
    ("_short", 1, 600, 64, 4, 0, 560),  # k jumps late in the last split, its second tile
    ("_short", 2, 520, 128, 1, 0, 400),  # ... in the fourth of a split's five tiles, C 128
    ("", 1, 200, 72, 2, 0, None),       # C 72 (UK64's dim) padded to 96: two splits, a ragged tile
    ("", 1, 200, 72, 2, 1, None),       # ... x one element past an aligned base: element loads
])
def test_emulated_two_pass_tensor_route_matches_plain(request, lib, b, n, c, splits, x_offset,
                                                      jump):
    """#2 and #3 in bf16 on their tensor-core route in the emulation
    (mma.sync, ldmatrix and cp.async with the ISA's fragment layouts), with
    the plan's splits, at phase 6's bounds: kmax within 1e-5 of the plain
    version at the route's rounding points (ctx_large_tensor_reference,
    whose xn is the kernel's) and of ctx_large_reference; a and s within
    3e-2 of their largest value; y within 3e-2 relative to max(|y|, |y - x|).
    At C not a multiple of 32 (C % 8 == 0) padded to whole 32-column blocks
    in shared memory, zero past C."""
    from ccdm_tpu_torch.ops import attn_block as ab

    lib = request.getfixturevalue("emulated_large" + lib)
    k = _large_case(b, n, c, "bfloat16", seed=n + c, jump=jump)
    xs = torch.empty(k["x"].numel() + x_offset, dtype=torch.bfloat16)[x_offset:].view(b, n, c)
    xs.copy_(k["x"])
    for kernel in (2, 3):
        assert _large_plan(lib, kernel, b, n, c, 1)[:3] == ("tensor", 128, splits), kernel
    kmax, s, a = _ctx_large(lib, xs, k["g_pre"], k["wqkv"], 1)
    _, _, own_kmax = ab.ctx_large_tensor_reference(k["x"], k["g_pre"], k["wqkv"], HEADS)
    for want in (own_kmax, k["kmax"]):
        torch.testing.assert_close(kmax, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    for got, want in ((a, k["a"]), (s, k["s"])):
        assert bool(((got - want).abs() <= 3e-2 * (want.abs() + want.abs().max())).all())

    ys = torch.empty(k["x"].numel() + x_offset, dtype=torch.bfloat16)[x_offset:].view(b, n, c)
    call(lib, "ccdm_attn_out_large", xs, k["g_pre"], k["wqkv"], k["ctx"], k["wout"], k["bout"],
          k["g_out"], ys, b, n, c, HEADS, D, 1)
    want = ab.out_large_reference(k["x"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"], k["bout"],
                                  k["g_out"], HEADS).float()
    scale = torch.maximum(want.abs(), (want - k["x"].float()).abs())
    assert bool(((ys.float() - want).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.parametrize("batch", [128, 64, 16, 8, 32])
def test_emulated_two_pass_plan_at_the_unet_shapes(emulated_large, batch):
    """The C plan of #2 and #3 at the two-pass shapes: bf16 on the tensor
    cores, 128-token tiles, min(tiles, floor(132 k / B)) blocks a row with k
    = 2 blocks an SM where their shared memory fits twice (C 64) and 1 (C
    128); #2's workspace its f32 records (2 a block, 2F + F D floats each),
    #3's none; UK64's C 72 too, padded to 96 (one block an SM). f32 on the
    CUDA cores: #2 with the first design's splits and its m, s and a
    partials, #3 a block per 32-token tile. The batches: the 64x64
    training's 128, the two-rank 64, UK128's micro-batch of 32 (N 16384 and
    4096) and UK192's of 16 (N 36864), the eval's 8: every one of those
    shapes on the tensor cores."""
    up = lambda v: -(-v // 256) * 256
    for n, c in TWO_PASS_SHAPES:
        tiles = -(-n // 128)
        splits = min(tiles, max(1, (2 if c <= 64 else 1) * 132 // batch))
        cores = min(-(-512 // batch), -(-n // 32))
        parts = batch * cores
        assert _large_plan(emulated_large, 2, batch, n, c, 1) == (
            "tensor", 128, splits, 0, up(batch * splits * 2 * (2 * F + F * 32) * 4)), (n, c)
        assert _large_plan(emulated_large, 3, batch, n, c, 1) == ("tensor", 128, splits, 0, 0)
        assert _large_plan(emulated_large, 2, batch, n, c, 0)[::2] == (
            "cores", cores, 2 * up(parts * F * 4) + up(parts * F * 32 * 4))
        assert _large_plan(emulated_large, 3, batch, n, c, 0) == ("cores", 32, n // 32, 0, 0)
    # C 40 pads to 64 on the tensor cores, two blocks an SM; bf16 at other
    # head counts, C not a multiple of 8 or C above 128: the CUDA cores
    splits = min(32, max(1, 264 // batch))
    assert _large_plan(emulated_large, 2, batch, 4096, 40, 1) == (
        "tensor", 128, splits, 0, up(batch * splits * 2 * (2 * F + F * 32) * 4))
    assert _large_plan(emulated_large, 3, batch, 4096, 40, 1) == ("tensor", 128, splits, 0, 0)
    for n, c, heads in ((4096, 64, 2), (4096, 36, HEADS), (4096, 160, HEADS)):
        for kernel in (2, 3):
            assert _large_plan(emulated_large, kernel, batch, n, c, 1, heads)[0] == "cores"


LARGE_ROUTES = ("cores", "tensor")


def _large_plan(lib, kernel, b, n, c, bf16, heads=HEADS, dim_head=D):
    """(route, tile, splits, wgrad splits, workspace bytes) of the library's
    plan for one call of #2, #3, #4 or #5 (kernel 2 to 5)."""
    out = (ctypes.c_int * 4)()
    nbytes = lib.ccdm_attn_large_plan(kernel, b, n, c, heads, dim_head, bf16, out)
    assert out[0] >= 0, (kernel, b, n, c, bf16)
    return LARGE_ROUTES[out[0]], out[1], out[2], out[3], nbytes


def _fused_backward(lib, k, dtype, x_offset=0):
    """#4 then #5 in the emulation on _large_case's inputs k, x at `x_offset`
    elements past an aligned base; returns their plans and outputs."""
    b, n, c = k["x"].shape
    heads = k["heads"]
    d = F // heads
    bf16 = int(dtype == "bfloat16")
    xs = torch.empty(k["x"].numel() + x_offset, dtype=k["x"].dtype)[x_offset:].view(b, n, c)
    xs.copy_(k["x"])
    plan_a, plan_b = (_large_plan(lib, kn, b, n, c, bf16, heads, d) for kn in (4, 5))
    do, d_ctx, d_wout, d_bout, d_gout = (torch.empty(b, n, c), torch.empty(b, heads, d, d),
                                         torch.empty(F, c), torch.empty(c), torch.empty(c))
    call(lib, "ccdm_attn_bwd_a", xs, k["dy"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
          k["bout"], k["g_out"], do, d_ctx, d_wout, d_bout, d_gout,
          torch.empty(-(-plan_a[4] // 4)), b, n, c, heads, d, bf16, plan_a[4])
    dx, d_wqkv, d_gpre = torch.empty_like(k["x"]), torch.empty(c, 3 * F), torch.empty(c)
    call(lib, "ccdm_attn_bwd_b", xs, k["dy"], k["do"], k["g_pre"], k["wqkv"], k["ctx"],
          k["wout"], k["kmax"], k["d_a"], k["d_s"], dx, d_wqkv, d_gpre,
          torch.empty(-(-plan_b[4] // 4)), b, n, c, heads, d, bf16, plan_b[4])
    return plan_a, plan_b, (do, d_ctx, d_wout, d_bout, d_gout), (dx, d_wqkv, d_gpre)


def _bwd_reference(k, d_a=None):
    """The plain #4 and #5 on k (#5 with d_a in its place, if given)."""
    from ccdm_tpu_torch.ops import attn_block as ab

    want_a = ab.bwd_a_reference(k["x"], k["dy"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
                                k["bout"], k["g_out"], k["heads"])
    want_b = ab.bwd_b_reference(k["x"], k["dy"], k["do"], k["g_pre"], k["wqkv"], k["ctx"],
                                k["wout"], k["kmax"], k["d_a"] if d_a is None else d_a,
                                k["d_s"], k["heads"])
    return want_a, want_b


def _check_backward(got_a, got_b, k, dtype):
    want_a, want_b = _bwd_reference(k)
    for name, got, w in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"), got_a, want_a):
        _close(got, w, dtype, name)
    for name, got, w in zip(("dx", "d_wqkv", "d_gpre"), got_b, want_b):
        _close(got, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (1, 80, 64)])
def test_emulated_fused_backward_matches_plain(emulated_large, b, n, c, dtype):
    """#4 and #5 against their plain versions: f32 on the CUDA cores, bf16
    (C a multiple of 32) on the tensor cores."""
    k = _large_case(b, n, c, dtype, seed=1)
    plan_a, plan_b, got_a, got_b = _fused_backward(emulated_large, k, dtype)
    route = "cores" if dtype == "float32" else "tensor"
    assert plan_a[0] == plan_b[0] == route
    _check_backward(got_a, got_b, k, dtype)


@pytest.mark.parametrize("b,n,c,splits,x_offset", [
    (1, 200, 64, 2, 0),    # a ragged last tile of 72 tokens; two splits merged in order
    (1, 200, 32, 2, 0),    # ... at C 32, the Cell-200 teacher's top level
    (2, 80, 128, 1, 0),    # C 128: Wqkv 100 KB resident, one ragged tile a row
    (1, 300, 96, 3, 0),    # three splits; the last tile's 44 tokens end inside warp 2
    (1, 200, 64, 2, 1),    # x one element past an aligned base: element loads
    (1, 200, 72, 2, 0),    # C 72 (UK64's dim) padded to 96: two splits, a ragged tile
    (1, 200, 72, 2, 1),    # ... x one element past an aligned base: element loads
    (1, 300, 104, 3, 0),   # C 104 padded to 128, three splits
])
def test_emulated_bwd_tensor_route_matches_plain(emulated_large, b, n, c, splits, x_offset):
    """The tensor-core route of #4 and #5 in the emulation (mma.sync,
    ldmatrix and cp.async with the ISA's fragment layouts) at the card's
    bf16 bound, with the plan's splits; at C not a multiple of 32 (C % 8
    == 0) padded to whole 32-column blocks in shared memory, zero past C."""
    k = _large_case(b, n, c, "bfloat16", seed=n + c)
    plan_a, plan_b, got_a, got_b = _fused_backward(emulated_large, k, "bfloat16", x_offset)
    assert plan_a[:3] == plan_b[:3] == ("tensor", 128, splits)
    _check_backward(got_a, got_b, k, "bfloat16")


def test_emulated_bwd_b_keeps_d_a_in_f32(emulated_large):
    """#5 in bf16 takes d_a at f32 precision in d_e = v . d_a^T and d_v = e .
    d_a (as bf16 hi + lo, two products each), as the JAX kernel does: every
    output's mean distance to the plain version is at most a quarter of
    its distance to the plain version with d_a rounded to bf16 (chip_smoke's
    check_rounding). The d_qkv rounding that follows hides the difference
    from the elementwise bound."""
    k = _large_case(1, 200, 64, "bfloat16", seed=3)
    _, _, _, got_b = _fused_backward(emulated_large, k, "bfloat16")
    _, own = _bwd_reference(k)
    _, other = _bwd_reference(k, d_a=k["d_a"].bfloat16().float())
    for name, got, o1, o2 in zip(("dx", "d_wqkv", "d_gpre"), got_b, own, other):
        near = float((got.float() - o1.float()).abs().mean())
        far = float((got.float() - o2.float()).abs().mean())
        assert near <= 0.25 * far, (name, near, far)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [2, 8])
def test_emulated_two_pass_other_dim_heads_match_plain(emulated_large, heads, dtype):
    """#2-#5 at dim_head 64 (2 heads) and 16 (8 heads), F 128: the plan
    sends every one to the CUDA cores in both types, with two splits and a
    ragged last tile; each against its plain version (kmax within 1e-5 in
    f32; the rest at the bounds of test_emulated_two_pass_forward_matches_plain
    and test_emulated_fused_backward_matches_plain)."""
    from ccdm_tpu_torch.ops import attn_block as ab

    b, n, c, d = 1, 200, 64, F // heads
    bf16 = int(dtype == "bfloat16")
    k = _large_case(b, n, c, dtype, seed=heads, heads=heads)
    for kernel in (2, 3, 4, 5):
        assert _large_plan(emulated_large, kernel, b, n, c, bf16, heads, d)[0] == "cores"
    kmax, s, a = _ctx_large(emulated_large, k["x"], k["g_pre"], k["wqkv"], bf16, heads)
    if dtype == "float32":
        torch.testing.assert_close(kmax, k["kmax"], rtol=1e-5, atol=1e-5)
    else:
        _close(kmax, k["kmax"], dtype, "kmax")
    _close(s, k["s"], dtype, "s")
    _close(a, k["a"], dtype, "a")
    y = torch.empty_like(k["x"])
    call(emulated_large, "ccdm_attn_out_large", k["x"], k["g_pre"], k["wqkv"], k["ctx"],
          k["wout"], k["bout"], k["g_out"], y, b, n, c, heads, d, bf16)
    want = ab.out_large_reference(k["x"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
                                  k["bout"], k["g_out"], heads).float()
    if dtype == "float32":
        torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-4)
    else:
        scale = torch.maximum(want.abs(), (want - k["x"].float()).abs())
        assert bool(((y.float() - want).abs() <= 3e-2 + 3e-2 * scale).all())
    _, _, got_a, got_b = _fused_backward(emulated_large, k, dtype)
    _check_backward(got_a, got_b, k, dtype)


# (N, C) of the two-pass blocks (N % 2048 == 0) of the three UNets: the
# 64x64's N 4096 levels, the 128x128's 128^2 and 64^2 up levels, the 192x192's
# 192^2 level; and N 2048, phase 6's shorter shape
TWO_PASS_SHAPES = [(4096, 64), (16384, 64), (4096, 128), (36864, 64), (2048, 64), (4096, 72)]


def test_emulated_two_pass_shapes_are_the_unets():
    """...and UK64's N 4096 levels (dim 72, mults 1_2_4_4_8): C 72."""
    two_pass = {(n, c) for size, mults, dim in ((64, (1, 2, 2, 4, 8), 64),
                                                (128, (1, 2, 4, 4, 8, 8), 64),
                                                (192, (1, 2, 2, 4, 4, 8, 8), 64),
                                                (64, (1, 2, 4, 4, 8), 72))
                for n, c in unet_attn_shapes(size, mults, dim) if n % 2048 == 0}
    assert two_pass == set(TWO_PASS_SHAPES) - {(2048, 64)}


@pytest.mark.parametrize("batch", [128, 64, 16, 8, 32])
def test_emulated_bwd_plan_at_the_unet_shapes(emulated_large, batch):
    """The C plan of #4 and #5 at the two-pass shapes: bf16 on the tensor
    cores, 128-token tiles, min(tiles, max(1, floor(132 / B))) blocks a row
    (one an SM, one wave); #4's workspace its f32 partials (d_ctx, dbout,
    dg_out, dWout), #5's xn and d_qkv in bf16, its dg_pre partials and
    min(264 / output tiles, ceil(B N / 32)) token splits of dWqkv (264
    blocks of 64 x 128 outputs), UK64's C 72 included (padded to 96 in
    shared memory; its workspace at C 72); f32 on the CUDA cores with the
    first design's splits. The batches as for #2 and #3: UK128's
    micro-batch of 32 and UK192's of 16 on the tensor cores at their
    shapes."""
    up = lambda v: -(-v // 256) * 256
    for n, c in TWO_PASS_SHAPES:
        m, tiles = batch * n, -(-n // 128)
        splits = min(tiles, max(1, 132 // batch))
        parts = batch * splits
        got_a, got_b = (_large_plan(emulated_large, kn, batch, n, c, 1) for kn in (4, 5))
        assert got_a == ("tensor", 128, splits, 0,
                         up(parts * F * 32 * 4) + 2 * up(parts * c * 4) + up(parts * F * c * 4))
        wsplits = min(264 // (-(-c // 64) * 3), -(-m // 32))
        assert got_b == ("tensor", 128, splits, wsplits,
                         up(m * c * 2) + up(m * 3 * F * 2) + up(parts * c * 4)
                         + up(wsplits * c * 3 * F * 4)), (n, c)
        cores = min(-(-512 // batch), -(-n // 32))
        for kn in (4, 5):
            route, _, got, _, _ = _large_plan(emulated_large, kn, batch, n, c, 0)
            assert (route, got) == ("cores", cores)
    # bf16 at other head counts, C not a multiple of 8 or C above 128: the CUDA cores
    for n, c, heads in ((4096, 64, 2), (4096, 36, HEADS), (4096, 160, HEADS), (4096, 64, 8)):
        for kn in (4, 5):
            assert _large_plan(emulated_large, kn, batch, n, c, 1, heads)[0] == "cores"

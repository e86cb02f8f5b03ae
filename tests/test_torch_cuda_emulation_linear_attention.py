"""Kernels #6-#9 (csrc/linear_attention.cu, the standalone linear attention)
compiled for the CPU behind the emulation of tests/torch_emulation.py and
held against their plain versions at the bounds of
tests/test_linear_attention.py: the CUDA-core routes, the tensor-core route
of #6 and #8, #7's and #9's bf16 routes (several tiles a split through a
library planned for a card of one SM), and the plans at the UNet's levels.
"""

import shutil

import numpy as np
import pytest
import torch

from tests.torch_emulation import D, F, HEADS, call, compile_emulated, unet_attn_shapes

torch.set_num_threads(2)


def _emulated_la(tmp_path_factory, subs=None):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import linear_attention as la

    return la.declare(compile_emulated(tmp_path_factory.mktemp("cuda_emu_la"), "linear_attention", subs))


@pytest.fixture(scope="module")
def emulated_la(tmp_path_factory):
    return _emulated_la(tmp_path_factory)


@pytest.fixture(scope="module")
def emulated_la_short(tmp_path_factory):
    """#6-#9's library planned for a card of one SM: on the tensor route a
    wave of 2 blocks (1 at D 128), so that at short rows a batch row takes
    two splits of several tiles each."""
    return _emulated_la(tmp_path_factory, {"constexpr int kCardSMs = 132;":
                                           "constexpr int kCardSMs = 1;"})


def _fulllane(lib, q, k, v):
    """#6 in the emulation, with the workspace its plan sizes: (out, plan)."""
    from ccdm_tpu_torch.ops import linear_attention as la

    b, n, h, d = q.shape
    plan = la.plan_of(lib, b, n, h, d, q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    call(lib, "ccdm_la_fulllane", q, k, v, out, torch.empty(plan.ws_bytes, dtype=torch.uint8),
          b, n, h, d, int(q.dtype == torch.bfloat16), plan.ws_bytes)
    return out, plan


def _per_head(lib, q, k, v):
    """#9 in the emulation, with the workspace its plan sizes: (out, plan)."""
    from ccdm_tpu_torch.ops import linear_attention as la

    b, n, h, d = q.shape
    plan = la.per_head_plan_of(lib, b, n, h, d, q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    call(lib, "ccdm_la_per_head", q, k, v, out, torch.empty(plan.ws_bytes, dtype=torch.uint8),
          b, n, h, d, int(q.dtype == torch.bfloat16), plan.ws_bytes)
    return out, plan


def _twopass(lib, k, v, m, chunk):
    """#7 in the emulation, with the workspace its plan sizes: (a, s, plan)."""
    from ccdm_tpu_torch.ops import linear_attention as la

    b, n, h, d = k.shape
    plan = la.twopass_plan_of(lib, b, n, h, d, chunk, k.dtype == torch.bfloat16)
    a, s = torch.empty(b, h, d, d), torch.empty(b, h * d)
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8)
    call(lib, "ccdm_la_ctx_twopass", k, v, m, a, s, ws, b, n, h, d, chunk,
          int(k.dtype == torch.bfloat16), plan.ws_bytes)
    return a, s, plan


def _la_inputs(b, n, h, d, dtype, seed):
    rng = np.random.default_rng(seed)
    std = 2.0 if dtype == "float32" else 1.0
    return [torch.from_numpy(rng.normal(0, std, (b, n, h, d)).astype(np.float32))
            .to(getattr(torch, dtype)) for _ in range(3)]


def _la_close(got, want, dtype):
    """The bounds of tests/test_linear_attention.py: f32 rtol 2e-3, atol
    1e-4; bf16 rtol 3e-2 and atol 3e-2 of max |want| (the outputs lie near
    1e-2)."""
    tol = (dict(rtol=2e-3, atol=1e-4) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-2 * float(want.float().abs().max())))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _la_rounding(got, own, other):
    """In bf16 a kernel keeps its plain version's rounding points: its mean
    abs difference to `own` is at most a quarter of that to `other`, the
    same function rounded at other points."""
    near = float((got.float() - own.float()).abs().mean())
    far = float((got.float() - other.float()).abs().mean())
    assert near <= 0.25 * far, (near, far)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d", [
    (2, 100, 4, 32),  # N past one 64-token tile and 3 context tiles, short last tile
    (1, 70, 2, 64),
    (1, 33, 8, 16),
    (1, 20, 1, 128),
    (1, 40, 3, 24),   # D 24 in the width-32 instantiation: padded channels
])
def test_emulated_fulllane_and_per_head_match_plain(emulated_la, b, n, h, d, dtype):
    """Kernels #6 and #9 against their plain versions (bounds of
    tests/test_linear_attention.py), in bf16 each nearer its own rounding
    points than the other's."""
    from ccdm_tpu_torch.ops import linear_attention as la

    q, k, v = _la_inputs(b, n, h, d, dtype, seed=n + d)
    bf16 = int(dtype == "bfloat16")
    out, _ = _fulllane(emulated_la, q, k, v)
    assert bool(torch.isfinite(out.float()).all())
    want6, want9 = la.fulllane_reference(q, k, v), la.linear_attention_reference(q, k, v)
    _la_close(out, want6, dtype)
    out9, _ = _per_head(emulated_la, q, k, v)
    _la_close(out9, want9, dtype)
    if bf16:  # #6 rounds k', v, ctx and q'; #9 only its output
        _la_rounding(out, want6, want9)
        _la_rounding(out9, want9, want6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,chunk", [
    (2, 300, 4, 32, 128),  # three chunks, the last one 44 tokens
    (1, 256, 2, 64, 256),  # one chunk
    (1, 90, 8, 16, 64),
    (1, 50, 1, 128, 32),
])
def test_emulated_twopass_matches_plain(emulated_la, b, n, h, d, chunk, dtype):
    """Kernel #7 (partials per chunk, then their sum in order) and #8
    against their plain versions; a and s relative to their largest value;
    in bf16 each nearer its own rounding points than another's."""
    from ccdm_tpu_torch.ops import linear_attention as la

    q, k, v = _la_inputs(b, n, h, d, dtype, seed=n * 3 + d)
    bf16 = int(dtype == "bfloat16")
    f = h * d
    m = k.float().amax(1).reshape(b, f).contiguous()
    a, s, _ = _twopass(emulated_la, k, v, m, chunk)
    ra, rs = la.ctx_twopass_reference(k, v, m)
    for got, want in ((a, ra), (s, rs)):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-4 * float(want.abs().max()))
    ctx = la.finalize_ctx(ra, rs, q.dtype)
    out = torch.empty_like(q)
    call(emulated_la, "ccdm_la_out_twopass", q, ctx, out, b, n, h, d, bf16)
    want = la.out_twopass_reference(q, ctx)
    _la_close(out, want, dtype)
    if bf16:  # #7 rounds exp(k - m), s sums it unrounded; #8 rounds q'
        e = torch.exp(k.float() - m.view(b, 1, h, d))
        _la_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()))
        _la_rounding(s, rs, e.bfloat16().float().sum(1).reshape(b, f))
        _la_rounding(out, want, torch.einsum("bnhd,bhde->bnhe", la._q_prime(q, torch.float32),
                                             ctx.float()).to(q.dtype))


def _offset(t, off):
    """t copied to `off` elements past an aligned base (off 0: t itself)."""
    if not off:
        return t
    return torch.empty(t.numel() + off, dtype=t.dtype)[off:].view(t.shape).copy_(t)


@pytest.mark.parametrize("lib,b,n,h,d,splits,x_offset,jump", [
    ("", 2, 100, 4, 32, (2, 1), 0, False),         # a ragged last tile: 36 of 64 tokens
    ("", 1, 70, 2, 64, (2, 1), 0, False),
    ("", 1, 33, 8, 16, (1, 1), 0, False),
    ("", 1, 20, 1, 128, (1, 1), 0, False),
    ("", 1, 90, 2, 48, (2, 1), 0, False),          # F 96: 12 chunks a row, 4 threads idle
    ("", 1, 80, 8, 32, (2, 1), 0, False),          # F 256: two groups of four heads
    ("_short", 1, 300, 4, 32, (2, 2), 0, False),   # two splits of 2-3 tiles; out steps of 128, 44
    ("_short", 1, 300, 4, 32, (2, 2), 1, False),   # q, k, v one element off: element loads
    ("_short", 1, 260, 4, 32, (2, 2), 0, True),    # k jumps by 30 in split 1's last tile
    ("_short", 1, 150, 1, 128, (1, 1), 0, False),  # D 128: a wave of one block, three tiles
])
def test_emulated_la_tensor_route_matches_plain(request, lib, b, n, h, d, splits, x_offset,
                                                jump):
    """#6 and #8 in bf16 on the tensor route (whole rows, mma.sync, ldmatrix
    and cp.async with the ISA's layouts; the statistics and context partials
    merged in order) against fulllane_reference and out_twopass_reference at
    la_check's bounds, each nearer its own rounding points than the f32
    function's; #6 the same bits twice."""
    from ccdm_tpu_torch.ops import linear_attention as la

    emulated = request.getfixturevalue("emulated_la" + lib)
    q, k, v = _la_inputs(b, n, h, d, "bfloat16", seed=7 * n + d)
    if jump:
        k[:, 3 * n // 4:, 0, 0] += 30
    q, k, v = (_offset(t, x_offset) for t in (q, k, v))
    out, plan = _fulllane(emulated, q, k, v)
    assert (plan.route, plan.ctx_splits, plan.out_splits) == ("tensor", *splits)
    want = la.fulllane_reference(q, k, v)
    _la_close(out, want, "bfloat16")
    _la_rounding(out, want, la.linear_attention_reference(q, k, v))
    assert torch.equal(_fulllane(emulated, q, k, v)[0], out)
    ra, rs = la.ctx_twopass_reference(k, v, k.float().amax(1).reshape(b, h * d))
    ctx = la.finalize_ctx(ra, rs, torch.bfloat16)
    out8 = torch.empty_like(q)
    call(emulated, "ccdm_la_out_twopass", q, ctx, out8, b, n, h, d, 1)
    want8 = la.out_twopass_reference(q, ctx)
    _la_close(out8, want8, "bfloat16")
    _la_rounding(out8, want8, torch.einsum("bnhd,bhde->bnhe", la._q_prime(q, torch.float32),
                                           ctx.float()).to(q.dtype))


@pytest.mark.parametrize("b,n,h,d", [(1, 40, 16, 8), (2, 50, 4, 24)])
def test_emulated_la_other_widths_take_the_cuda_cores(emulated_la, b, n, h, d):
    """bf16 at D % 16 != 0 (D 8 at H 16, D 24) takes the CUDA-core route of
    #6 and #8, at the same bounds and rounding rule."""
    from ccdm_tpu_torch.ops import linear_attention as la

    q, k, v = _la_inputs(b, n, h, d, "bfloat16", seed=n + h)
    out, plan = _fulllane(emulated_la, q, k, v)
    assert plan.route == "cores"
    want = la.fulllane_reference(q, k, v)
    _la_close(out, want, "bfloat16")
    _la_rounding(out, want, la.linear_attention_reference(q, k, v))
    ctx = la.finalize_ctx(*la.ctx_twopass_reference(k, v, k.float().amax(1).reshape(b, h * d)),
                          torch.bfloat16)
    out8 = torch.empty_like(q)
    call(emulated_la, "ccdm_la_out_twopass", q, ctx, out8, b, n, h, d, 1)
    _la_close(out8, la.out_twopass_reference(q, ctx), "bfloat16")


def _check_twopass_rounding(a, s, ra, rs, k, v, m):
    """#7's a and s nearer their own rounding points (exp(k - m) and v rounded
    for the product, s summing the unrounded values) than the other ones: a
    from the unrounded exp(k - m), s from the rounded one."""
    b, _, h, d = k.shape
    e = torch.exp(k.float() - m.view(b, 1, h, d))
    _la_rounding(a, ra, torch.einsum("bnhd,bnhe->bhde", e, v.float()))
    _la_rounding(s, rs, e.bfloat16().float().sum(1).reshape(b, h * d))


@pytest.mark.parametrize("lib,b,n,h,d,splits,x_offset,jump,shift", [
    ("", 2, 100, 4, 32, 2, 0, False, 0.0),         # a ragged last tile: 36 of 64 tokens
    ("", 1, 70, 2, 64, 2, 0, False, 0.0),
    ("", 1, 33, 8, 16, 1, 0, False, 0.0),          # one split: a and s written in place
    ("", 1, 20, 1, 128, 1, 0, False, 0.0),
    ("", 1, 90, 2, 48, 2, 0, False, 0.0),          # F 96: 12 chunks a row, 4 threads idle
    ("_short", 1, 300, 4, 32, 2, 0, False, 0.0),   # two splits of 2 and 3 tiles
    ("_short", 1, 300, 4, 32, 2, 1, False, 0.0),   # k and v one element off: element loads
    ("_short", 1, 260, 4, 32, 2, 0, True, 0.0),    # k jumps by 30 in split 1's last tile
    ("_short", 1, 300, 4, 32, 2, 0, False, 0.5),   # m = colmax + 0.5, used as given
    ("_short", 1, 200, 2, 48, 2, 0, False, 0.0),   # F 96 over several tiles a split
])
def test_emulated_twopass_tensor_route_matches_plain(request, lib, b, n, h, d, splits, x_offset,
                                                     jump, shift):
    """#7 in bf16 on the tensor route (whole rows, exp(k - m) rounded in place
    for mma.sync, s summed per thread before the rounding and merged in
    order, the splits' partials summed in order) against
    ctx_twopass_reference at the existing bounds (rtol 2e-3, atol 1e-4 of
    max |want|), nearer its own rounding points than the other ones, the
    same bits twice; the chunk does not change the route's splits."""
    from ccdm_tpu_torch.ops import linear_attention as la

    emulated = request.getfixturevalue("emulated_la" + lib)
    _, k, v = _la_inputs(b, n, h, d, "bfloat16", seed=5 * n + d)
    if jump:
        k[:, 3 * n // 4:, 0, 0] += 30
    m = (k.float().amax(1).reshape(b, h * d) + shift).contiguous()
    k, v = (_offset(t, x_offset) for t in (k, v))
    a, s, plan = _twopass(emulated, k, v, m, 64)
    assert (plan.route, plan.splits) == ("tensor", splits)
    assert la.twopass_plan_of(emulated, b, n, h, d, 2048, True) == plan
    ra, rs = la.ctx_twopass_reference(k, v, m)
    for got, want in ((a, ra), (s, rs)):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-4 * float(want.abs().max()))
    _check_twopass_rounding(a, s, ra, rs, k, v, m)
    again = _twopass(emulated, k, v, m, 64)
    assert torch.equal(again[0], a) and torch.equal(again[1], s)


@pytest.mark.parametrize("lib,b,n,h,d,splits,x_offset,jump", [
    ("", 2, 100, 4, 32, (2, 4, 2), 0, False),        # ragged last tiles: 36 of 64, 4 of 32
    ("", 1, 70, 2, 64, (2, 3, 2), 0, False),
    ("", 1, 33, 8, 16, (1, 2, 1), 0, False),
    ("", 1, 20, 1, 128, (1, 1, 1), 0, False),        # one split: the sum launch skipped
    ("", 1, 90, 2, 48, (2, 3, 2), 0, False),         # F 96: 12 chunks a row
    ("_short", 1, 300, 4, 32, (3, 2, 2), 0, False),  # splits of several tiles and steps
    ("_short", 1, 300, 4, 32, (3, 2, 2), 1, False),  # q, k, v one element off: element loads
    ("_short", 1, 260, 4, 32, (3, 2, 2), 0, True),   # k jumps by 30 late in a split
    ("_short", 1, 150, 1, 128, (3, 2, 1), 0, False),  # D 128: one out block an SM
    ("_short", 1, 200, 2, 48, (3, 2, 2), 0, False),  # F 96 over several tiles a split
])
def test_emulated_per_head_rows_route_matches_plain(request, lib, b, n, h, d, splits, x_offset,
                                                    jump):
    """#9 in bf16 on the whole-row route (#6's statistics, f32 context
    partials with register-blocked FMAs, their ordered sum, the f32 out
    pass) against linear_attention_reference at la_check's bounds, nearer
    its own rounding points (only the output rounded) than #6's, the same
    bits twice."""
    from ccdm_tpu_torch.ops import linear_attention as la

    emulated = request.getfixturevalue("emulated_la" + lib)
    q, k, v = _la_inputs(b, n, h, d, "bfloat16", seed=11 * n + d)
    if jump:
        k[:, 3 * n // 4:, 0, 0] += 30
    q, k, v = (_offset(t, x_offset) for t in (q, k, v))
    out, plan = _per_head(emulated, q, k, v)
    assert plan[:4] == ("rows", *splits)
    want = la.linear_attention_reference(q, k, v)
    _la_close(out, want, "bfloat16")
    _la_rounding(out, want, la.fulllane_reference(q, k, v))
    assert torch.equal(_per_head(emulated, q, k, v)[0], out)


@pytest.mark.parametrize("batch", [64, 128])
def test_emulated_la_plan_at_the_unet_shapes(emulated_la, batch):
    """The plans at the UNet's ten attention levels (LinearAttention(C, 4,
    32): H 4, D 32 at every level). #6 and #8: bf16 on the tensor route,
    its splits filling one wave of 132 SMs x 2 blocks (x 3 for the
    statistics launch) with the batch rows, at least one tile a split; the
    workspace ctx, two record arrays and, past one split, the partials;
    f32 on the CUDA cores with ctx alone. #7 and #9 likewise, each with its
    own tiles and workspace."""
    from ccdm_tpu_torch.ops import linear_attention as la

    align = lambda nbytes: -(-nbytes // 256) * 256
    for n, _ in unet_attn_shapes(64, (1, 2, 2, 4, 8)):
        p = la.plan_of(emulated_la, batch, n, HEADS, D, True)
        splits, stat_splits = min(264 // batch, -(-n // 64)), min(396 // batch, -(-n // 64))
        parts = batch * splits * F * D * 4 if splits > 1 else 0
        assert p == la.LaPlan("tensor", 64, splits, 128, min(264 // batch, -(-n // 128)),
                              stat_splits, align(batch * F * D * 2)
                              + 2 * align(batch * stat_splits * F * 4) + parts), (n, p)
        assert batch * p.ctx_splits <= 264 and batch * p.out_splits <= 264
        assert la.plan_of(emulated_la, batch, n, HEADS, D, False) == la.LaPlan(
            "cores", 32, 1, 64, -(-n // 64), 0, align(batch * F * D * 4))
        # #7: the tensor route splits as #6's context launch, whatever the
        # chunk; the CUDA cores a split a chunk; partials a and s, f32
        parts7 = lambda nc: align(batch * nc * F * D * 4) + align(batch * nc * F * 4)
        for chunk in (2048, 64):
            assert la.twopass_plan_of(emulated_la, batch, n, HEADS, D, chunk, True) == (
                la.TwopassPlan("tensor", splits, parts7(splits) if splits > 1 else 0))
            nc = -(-n // chunk)
            assert la.twopass_plan_of(emulated_la, batch, n, HEADS, D, chunk, False) == (
                la.TwopassPlan("cores", nc, parts7(nc)))
        # #9: #6's statistics splits, context splits of 32-token tiles and
        # out splits of 64-token steps, each filling 132 SMs x 2 blocks; the
        # workspace ctx (f32), two record arrays and, past one split, the
        # partials; f32 on the CUDA cores, a block per (batch, head)
        ctx9, out9 = min(264 // batch, -(-n // 32)), min(264 // batch, -(-n // 64))
        assert la.per_head_plan_of(emulated_la, batch, n, HEADS, D, True) == la.PerHeadPlan(
            "rows", stat_splits, ctx9, out9, align(batch * F * D * 4)
            + 2 * align(batch * stat_splits * F * 4)
            + (batch * ctx9 * F * D * 4 if ctx9 > 1 else 0)), n
        assert la.per_head_plan_of(emulated_la, batch, n, HEADS, D, False) == la.PerHeadPlan(
            "cores", 0, 1, 1, 0)
    # phase 14's #7 at B 64, N 16384: 4 splits of 64 tiles
    assert la.twopass_plan_of(emulated_la, 64, 16384, HEADS, D, 2048, True).splits == 4

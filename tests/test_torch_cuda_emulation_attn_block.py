"""Kernel #1 (csrc/attn_block.cu) compiled for the CPU behind the emulation of
tests/torch_emulation.py and held against its plain version: the CUDA-core
route in f32 and at other shapes, the fused and split tensor-core routes in
bf16 (the split route at short rows through a library built with a wave of
two blocks and no fused route), and the C plan at the UNets' shapes and the
batches the main paths give the kernel. Bounds of the card's checks: f32
rtol 2e-3 / atol 2e-4; bf16 3e-2 relative to max(|y|, |y - x|).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops.attn_block import attn_block_reference
from tests.torch_emulation import D, F, HEADS, call, compile_emulated, unet_attn_shapes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare(compile_emulated(tmp_path_factory.mktemp("cuda_emu"), "attn_block"))


@pytest.fixture(scope="module")
def emulated_short(tmp_path_factory):
    """#1's library with a wave of 2 blocks and no fused route: the split
    route at short rows, with splits = min(tiles, 4 // B)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare(compile_emulated(
        tmp_path_factory.mktemp("cuda_emu_short"), "attn_block",
        {"constexpr int kWave = 132;": "constexpr int kWave = 2;",
         "constexpr int kFusedMaxN = 128;": "constexpr int kFusedMaxN = 0;"}))


ATTN_ROUTES = ("cores", "fused", "split")


def _attn_plan(lib, b, n, c, heads, bf16, dim_head=D):
    """(route, splits, workspace) of the library's plan for one call of #1."""
    out = (ctypes.c_int * 3)()
    nbytes = lib.ccdm_attn_block_plan(b, n, c, heads, dim_head, bf16, out)
    assert out[0] >= 0, (b, n, c, bf16)
    return ATTN_ROUTES[out[0]], out[2], nbytes


def _attn_inputs(b, n, c, dtype, seed=0, jump=False, heads=HEADS, dim_head=D):
    """x [b, n, c] ~ N(0, 2) in f32 and N(0, 1) in bf16, and the weights
    (g_pre, wqkv, wout, bout, g_out), in `dtype`. With `jump`, channel 0 of x
    is 0 in the first half of the tokens and 30 in the second, its gain 1.5
    and its row of Wk 20 times larger: k rises by tens halfway through the
    row, so the online softmax's running max must rescale what it has summed."""
    rng = np.random.default_rng(seed)
    f = heads * dim_head
    x = rng.normal(0, 2.0 if dtype == "float32" else 1.0, (b, n, c))
    w = (1 + 0.5 * rng.normal(size=c), 0.1 * rng.normal(size=(c, 3 * f)),
         0.1 * rng.normal(size=(f, c)), 0.1 * rng.normal(size=c), 1 + 0.5 * rng.normal(size=c))
    if jump:
        x[:, :n // 2, 0], x[:, n // 2:, 0] = 0.0, 30.0
        w[0][0] = 1.5
        w[1][0, f:2 * f] *= 20
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a.astype(np.float32)).to(dt).contiguous() for a in (x, *w)]


def _attn_block(lib, b, n, c, dtype, seed=0, x_offset=0, jump=False, heads=HEADS, dim_head=D):
    """#1 in the emulation on _attn_inputs against attn_block_reference, at
    the card's bounds (f32 rtol 2e-3 / atol 2e-4; bf16 3e-2 relative to
    max(|y|, |y - x|)), x at `x_offset` elements past an aligned base.
    Returns (route, splits) and y."""
    ins = _attn_inputs(b, n, c, dtype, seed, jump, heads, dim_head)
    dt = ins[0].dtype
    xs = torch.empty(ins[0].numel() + x_offset, dtype=dt)[x_offset:].view(b, n, c)
    xs.copy_(ins[0])
    bf16 = int(dt == torch.bfloat16)
    route, splits, nbytes = _attn_plan(lib, b, n, c, heads, bf16, dim_head)
    ws = torch.empty(nbytes // 4)
    y = torch.empty_like(ins[0])
    call(lib, "ccdm_attn_block_forward", xs, *ins[1:], y, ws, b, n, c, heads, dim_head, bf16,
          nbytes)
    want = attn_block_reference(*(t.float() for t in ins), heads, dim_head)
    got = y.float()
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    else:
        scale = torch.maximum(want.abs(), (want - ins[0].float()).abs())
        assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())
    return (route, splits), y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (2, 100, 64), (1, 16, 512)])
def test_emulated_kernel_matches_plain_version(emulated, b, n, c, dtype):
    """Kernel #1 at these short rows takes the CUDA cores in f32 and the fused
    route (tensor cores, one block a row) in bf16."""
    (route, _), _ = _attn_block(emulated, b, n, c, dtype)
    assert route == ("cores" if dtype == "float32" else "fused")


@pytest.mark.parametrize("lib,b,n,c,route,splits,x_offset,jump", [
    ("", 1, 16, 512, "fused", 1, 0, False),       # C 512: four Wout chunks, 16 of a 64 tile
    ("", 2, 64, 128, "fused", 1, 0, False),
    ("", 1, 64, 512, "fused", 1, 0, False),       # C 512, N 64: k and v through a narrow ring
    ("_short", 2, 100, 64, "split", 2, 0, False),  # a ragged last tile of 36 tokens
    ("_short", 1, 200, 64, "split", 4, 0, False),  # four splits merged in order
    ("_short", 2, 100, 64, "split", 2, 1, False),  # x one element past an aligned base
    ("", 1, 70, 40, "fused", 1, 0, False),        # C 40: element loads, part K slices
    ("_short", 4, 200, 64, "split", 1, 0, False),  # four tiles a block: the next one loads
    ("_short", 1, 300, 256, "split", 4, 0, False),  # C 256: the weights streamed, two Wout chunks
    ("_short", 4, 256, 64, "split", 1, 0, True),   # k jumps at tile 2 of 4: a rescale
    ("_short", 1, 200, 32, "split", 4, 0, False),  # C 32 (the Cell-200 teacher's top level)
    ("", 1, 128, 64, "fused", 1, 0, True),        # ... at tile 1 of 2 in the fused route
])
def test_emulated_attn_bf16_routes_match_plain(request, lib, b, n, c, route, splits, x_offset,
                                               jump):
    """The tensor-core routes of #1 in the emulation (mma.sync, ldmatrix and
    cp.async with the ISA's fragment layouts): the fused route, and the split
    route reached at short rows through a library built with no fused route
    and a wave of two blocks (emulated_short), at the card's bf16 bound."""
    emulated = request.getfixturevalue("emulated" + lib)
    got, _ = _attn_block(emulated, b, n, c, "bfloat16", seed=n + c, x_offset=x_offset,
                         jump=jump)
    assert got == (route, splits)


@pytest.mark.parametrize("lib,b,n,c", [("", 2, 64, 512), ("", 2, 16, 512),
                                       ("_short", 2, 100, 64)])
def test_emulated_attn_bf16_matches_its_rounding_points(request, lib, b, n, c):
    """#1 in bf16 against the plain version at its own rounding points (the
    plain #2 for xn, exp(k - m), v and s, ctx = a / s rounded to bf16, the
    plain #3 for q', the attention output and the epilogue: chip_smoke's
    attn_rounded_reference) at the bf16 bound: at C 512 the roundings
    themselves come near the bound against the f32 plain version, so this is
    the check of the kernel's arithmetic there (fused, narrow ring, split)."""
    from ccdm_tpu_torch.ops import attn_block as ab

    emulated = request.getfixturevalue("emulated" + lib)
    _, y = _attn_block(emulated, b, n, c, "bfloat16", seed=3 * n + c)
    xb, g_pre, wqkv, wout, bout, g_out = _attn_inputs(b, n, c, "bfloat16", seed=3 * n + c)
    a, s, _ = ab.ctx_large_reference(xb, g_pre, wqkv, HEADS)
    ctx = (a / s.clamp_min(1e-30).view(*a.shape[:3], 1)).bfloat16()
    want = ab.out_large_reference(xb, g_pre, wqkv, ctx, wout, bout, g_out, HEADS).float()
    scale = torch.maximum(want.abs(), (want - xb.float()).abs())
    assert bool(((y.float() - want).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.parametrize("b,n,c,heads", [(2, 40, 64, 2), (1, 30, 640, 4)])
def test_emulated_attn_bf16_other_shapes_take_the_cuda_cores(emulated, b, n, c, heads):
    """In bf16, heads other than 4 and C above 512 (no model path) take the
    CUDA-core route, as every bf16 call did before the tensor-core routes,
    at the same bound."""
    got, _ = _attn_block(emulated, b, n, c, "bfloat16", seed=b + c, heads=heads)
    assert got == ("cores", 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,dim_head", [(2, 64), (8, 16), (3, 40)])
def test_emulated_attn_other_dim_heads_take_the_cuda_cores(emulated, heads, dim_head, dtype):
    """#1 at dim_head other than 32 (64 and 16, at F 128 as JAX's kernels
    take them, and 40, a head that is not a multiple of the warp): the plan
    sends it to the CUDA cores in both types, whose warps stride a head's
    channels; at the card's bounds, with a ragged last token tile."""
    got, _ = _attn_block(emulated, 2, 70, 64, dtype, seed=dim_head, heads=heads,
                         dim_head=dim_head)
    assert got == ("cores", 1)


# (N, C) of the attention blocks of the RC-49 64x64 UNet (chip_smoke.FORWARD_SHAPES),
# the 128x128 (mults 1_2_4_4_8_8) and the 192x192 (1_2_2_4_4_8_8) UNet, and
# UK64's (dim 72, mults 1_2_4_4_8: C 72 to 576)
UNET_ATTN_SHAPES = sorted(set(unet_attn_shapes(64, (1, 2, 2, 4, 8)) +
                              unet_attn_shapes(128, (1, 2, 4, 4, 8, 8)) +
                              unet_attn_shapes(192, (1, 2, 2, 4, 4, 8, 8)) +
                              unet_attn_shapes(64, (1, 2, 4, 4, 8), dim=72)))
# those of the UK128 (scripts/UK128/run_ccdm.sh) and UK192 configurations
UK_HIGHRES_SHAPES = sorted(set(unet_attn_shapes(128, (1, 2, 4, 4, 8, 8)) +
                               unet_attn_shapes(192, (1, 2, 2, 4, 4, 8, 8))))


@pytest.mark.parametrize("batch", [64, 128, 72, 8, 400, 32, 16])
def test_emulated_attn_plan_at_the_unet_shapes(emulated, batch):
    """The C plan of #1 at the batches the main paths give it (served,
    trained, the EMA grid, the eval sampling; UK128's and UK192's sampling
    of 200 images a label, a CFG forward of 400 rows, and their
    micro-batches of 32 and 16 at the single-pass levels): bf16 fused (no
    workspace) where N <= 128, else split with min(tiles, max(1, floor(264 /
    B))) blocks a row in each pass (two an SM, one wave; one at B 400) and a
    workspace of their f32 records (m, s, a: 4352 floats, two a block) and
    the bf16 ctx; f32, and bf16 with heads other than 4 or C above 512
    (UK64's N 16 C 576), the CUDA cores through an f32 qkv workspace. Every
    shape of UK128 and UK192 takes a tensor-core route in bf16."""
    for n, c in UK_HIGHRES_SHAPES:
        assert _attn_plan(emulated, batch, n, c, HEADS, 1)[0] in ("fused", "split"), (n, c)
    for n, c in UNET_ATTN_SHAPES:
        out = (ctypes.c_int * 3)()
        nbytes = emulated.ccdm_attn_block_plan(batch, n, c, HEADS, D, 1, out)
        route, tile, splits = ATTN_ROUTES[out[0]], out[1], out[2]
        if c > 512:
            assert route == "cores" and nbytes == (batch * n * 3 * F + batch * F * 32) * 4, (n, c)
        elif n <= 128:
            assert (route, tile, splits, nbytes) == ("fused", 64, 1, 0), (n, c)
        else:
            want = min(-(-n // 64), max(1, 264 // batch))
            assert (route, tile, splits) == ("split", 64, want), (n, c)
            assert nbytes == batch * want * 2 * 4352 * 4 + batch * F * 32 * 2
        f32 = (ctypes.c_int * 3)()
        assert emulated.ccdm_attn_block_plan(batch, n, c, HEADS, D, 0, f32) == \
            (batch * n * 3 * F + batch * F * 32) * 4 and f32[0] == 0
    # bf16 shapes the tensor-core routes do not take: the CUDA cores (at C 512
    # the fused route's shared memory holds 77 tokens, the split route's none)
    for n, c, heads in ((64, 640, HEADS), (64, 64, 2), (64, 64, 8), (78, 512, HEADS),
                        (1024, 512, HEADS)):
        f = heads * 32
        assert emulated.ccdm_attn_block_plan(batch, n, c, heads, D, 1, out) == \
            (batch * n * 3 * f + batch * f * 32) * 4 and out[0] == 0, (n, c, heads)
    for n in (48, 77):  # C 512: the wide ring to N 53, the narrow one to N 77
        assert emulated.ccdm_attn_block_plan(batch, n, 512, HEADS, D, 1, out) == 0 and out[0] == 1

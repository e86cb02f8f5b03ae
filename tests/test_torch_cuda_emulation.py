"""The CUDA source of the attention block, compiled for the CPU and emulated.

There is no nvcc here, so csrc/attn_block.cu is compiled with g++ behind a
small emulation of the CUDA built-ins it uses: each block runs as one OS
thread per CUDA thread, `__syncthreads` and the warp shuffles are barriers,
shared memory is memory shared by those threads, blocks run one after
another. That checks the kernel's own indexing, tiling, masking and
arithmetic against the plain PyTorch version on small shapes, at the bounds
the card's checks use (f32 rtol 2e-3 / atol 2e-4; bf16 3e-2 relative to
max(|y|, |y - x|)). It cannot show that nvcc accepts the source or how the
card schedules it: chip_smoke.py does that on the card.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ccdm_tpu_torch.ops import _build
from ccdm_tpu_torch.ops.attn_block import attn_block_reference

torch.set_num_threads(2)

HEADS, D, F = 4, 32, 128

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
using std::min;
using std::max;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }
inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
inline float __frsqrt_rn(float v) { return float(1.0 / std::sqrt(double(v))); }
inline float __expf(float v) { return std::exp(v); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
namespace emu {
inline thread_local dim3 tid, bid;
inline dim3 grid_dim;
inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::barrier<>*> warp_barriers;
inline float exchange[64][32];
inline float* dynamic_smem = nullptr;
template <typename F>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F body) {
  const int n = block.x;
  grid_dim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(n);
      block_barrier = &bar;
      std::vector<std::barrier<>*> warps;
      for (int w = 0; w < n / 32; ++w) warps.push_back(new std::barrier<>(32));
      warp_barriers = warps;
      std::vector<float> shared(smem / sizeof(float) + 4, NAN);  // NaN: reads before writes show
      dynamic_smem = shared.data();
      std::vector<std::thread> threads;
      for (int t = 0; t < n; ++t)
        threads.emplace_back([&, t] { tid = dim3(t); bid = dim3(bx, by, bz); body(); });
      for (auto& th : threads) th.join();
      for (auto* w : warps) delete w;
    }
}
}  // namespace emu
#define threadIdx emu::tid
#define blockIdx emu::bid
#define gridDim emu::grid_dim
inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::exchange[w][l] = v;
  emu::warp_barriers[w]->arrive_and_wait();
  const float r = emu::exchange[w][l ^ lane_mask];
  emu::warp_barriers[w]->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src_lane) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::exchange[w][l] = v;
  emu::warp_barriers[w]->arrive_and_wait();
  const float r = emu::exchange[w][src_lane];
  emu::warp_barriers[w]->arrive_and_wait();
  return r;
}
// The PTX helpers of a source (CCDM_PTX_EMULATED), with the fragment layouts
// of the PTX ISA ("Matrix Fragments for mma.m16n8k16", bf16 inputs;
// "ldmatrix"): each lane publishes its operands, the warp meets at a barrier,
// each lane reads what the ISA puts in its registers.
#define CCDM_PTX_EMULATED 1
namespace emu {
inline uint32_t regs[64][32][6];
inline const void* rows[64][32];
inline float bf16_bits(uint32_t r, int high) {
  const uint32_t u = high ? (r & 0xffff0000u) : (r << 16);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// Lane l gives the address of row l % 8 of matrix l / 8. Register i of lane l:
// row l / 4 of matrix i, elements 2 (l % 4) and 2 (l % 4) + 1 (low half
// first); with trans, the same of the transposed matrix.
inline void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  rows[w][l] = p;
  warp_barriers[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t e[2];
    for (int j = 0; j < 2; ++j) {
      const int a = 2 * (l % 4) + j;
      e[j] = trans ? static_cast<const uint16_t*>(rows[w][8 * i + a])[l / 4]
                   : static_cast<const uint16_t*>(rows[w][8 * i + l / 4])[a];
    }
    r[i] = uint32_t(e[0]) | (uint32_t(e[1]) << 16);
  }
  warp_barriers[w]->arrive_and_wait();
}
}  // namespace emu
inline void cp_async_16(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { emu::ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { emu::ldmatrix(r, p, true); }
// A 16x16: a0 (row g, k 2t, 2t+1), a1 (row g+8), a2 (k + 8), a3 (row g+8, k + 8);
// B 16x8: b0 (k 2t, 2t+1, col g), b1 (k + 8); D 16x8: d0, d1 (row g, cols
// 2t, 2t+1), d2, d3 (row g+8); g = lane / 4, t = lane % 4.
inline void mma_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) emu::regs[w][l][i] = a[i];
  for (int i = 0; i < 2; ++i) emu::regs[w][l][4 + i] = b[i];
  emu::warp_barriers[w]->arrive_and_wait();
  auto A = [&](int row, int k) {
    const uint32_t r = emu::regs[w][(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
    return emu::bf16_bits(r, k % 2);
  };
  auto B = [&](int k, int n) {
    return emu::bf16_bits(emu::regs[w][n * 4 + (k % 8) / 2][4 + (k >= 8)], k % 2);
  };
  for (int i = 0; i < 4; ++i) {
    const int row = l / 4 + 8 * (i / 2), col = 2 * (l % 4) + i % 2;
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    d[i] = s;
  }
  emu::warp_barriers[w]->arrive_and_wait();
}
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u; std::memcpy(&u, &f, 4);
  __nv_bfloat16 b; b.x = uint16_t((u + 0x7fff + ((u >> 16) & 1)) >> 16); return b;
}
"""


def _to_cpp(src: str) -> str:
    """Shared memory becomes memory shared by the block's threads, and each
    `kernel<<<grid, block, smem, stream>>>(args)` an emu::launch call."""
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu::dynamic_smem;")
    src = src.replace("__shared__", "static")
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        k = j
        if src[k - 1] == ">":  # template arguments: back over the balanced <...>
            depth = 0
            while True:
                k -= 1
                depth += {">": 1, "<": -1}.get(src[k], 0)
                if depth == 0:
                    break
        while src[k - 1] not in " \n(":
            k -= 1
        end = src.index(">>>", j)
        p = q = end + 3
        depth = 0
        while True:
            depth += {"(": 1, ")": -1}.get(src[q], 0)
            if depth == 0:
                break
            q += 1
        out += [src[i:k], f"emu::launch({src[j + 3:end]}, [=]() {{ {src[k:j]}"
                          f"({src[p + 1:q]}); }})"]
        i = q + 1
    return "".join(out) + src[i:]


def _compile(d, name, subs=None):
    """g++-compile csrc/<name>.cu behind the emulation into d/lib<name>.so,
    each declaration `old` of `subs` replaced by `new` first in the one file,
    the source or a header of csrc/, that declares it (the headers are
    copied to d, which the source's includes search first)."""
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cuda_bf16.h").write_text(CUDA_BF16_H)
    texts = {f"{name}.cu": (_build.CSRC_DIR / f"{name}.cu").read_text(),
             **{h.name: h.read_text() for h in _build.CSRC_DIR.glob("*.cuh")}}
    for old, new in (subs or {}).items():
        hits = [f for f, text in texts.items() if old in text]
        assert len(hits) == 1 and texts[hits[0]].count(old) == 1, old
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for f, text in texts.items():
        if f.endswith(".cuh"):
            (d / f).write_text(text)
    (d / f"{name}.cpp").write_text(_to_cpp(texts[f"{name}.cu"]))
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{d}",
                    f"-I{_build.CSRC_DIR}", "-include", "cuda_runtime.h",
                    "-o", str(d / f"lib{name}.so"), str(d / f"{name}.cpp")],
                   check=True, timeout=300)
    return ctypes.CDLL(str(d / f"lib{name}.so"))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare(_compile(tmp_path_factory.mktemp("cuda_emu"), "attn_block"))


@pytest.fixture(scope="module")
def emulated_short(tmp_path_factory):
    """#1's library with a wave of 2 blocks and no fused route: the split
    route at short rows, with splits = min(tiles, 4 // B)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare(_compile(
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
    _call(lib, "ccdm_attn_block_forward", xs, *ins[1:], y, ws, b, n, c, heads, dim_head, bf16,
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


def _unet_attn_shapes(size, mults, dim=64):
    """(N, C) of a UNet's attention blocks: each down level at its input
    width, each up level at its output width (models/unet.py)."""
    dims = [dim] + [dim * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    down = [((size >> i) ** 2, c_in) for i, (c_in, _) in enumerate(pairs)]
    up = [((size >> (len(pairs) - 1 - i)) ** 2, c_out)
          for i, (_, c_out) in enumerate(reversed(pairs))]
    return down + up


# (N, C) of the attention blocks of the RC-49 64x64 UNet (chip_smoke.FORWARD_SHAPES),
# the 128x128 (mults 1_2_4_4_8_8) and the 192x192 (1_2_2_4_4_8_8) UNet, and
# UK64's (dim 72, mults 1_2_4_4_8: C 72 to 576)
UNET_ATTN_SHAPES = sorted(set(_unet_attn_shapes(64, (1, 2, 2, 4, 8)) +
                              _unet_attn_shapes(128, (1, 2, 4, 4, 8, 8)) +
                              _unet_attn_shapes(192, (1, 2, 2, 4, 4, 8, 8)) +
                              _unet_attn_shapes(64, (1, 2, 4, 4, 8), dim=72)))


@pytest.mark.parametrize("batch", [64, 128, 72, 8])
def test_emulated_attn_plan_at_the_unet_shapes(emulated, batch):
    """The C plan of #1 at the batches the main paths give it (served,
    trained, the EMA grid, the eval sampling): bf16 fused (no workspace)
    where N <= 128, else split with min(tiles, max(1, floor(264 / B))) blocks
    a row in each pass (two an SM, one wave) and a workspace of their f32
    records (m, s, a: 4352 floats, two a block) and the bf16 ctx; f32, and
    bf16 with heads other than 4 or C above 512 (UK64's N 16 C 576), the
    CUDA cores through an f32 qkv workspace."""
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


# ------------------------------------------- kernels #2-#5 (two-pass path)

@pytest.fixture(scope="module")
def emulated_large(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare_large(_compile(tmp_path_factory.mktemp("cuda_emu_large"),
                                     "attn_block_large"))


@pytest.fixture(scope="module")
def emulated_large_short(tmp_path_factory):
    """#2-#5's library with a wave of 2 blocks: several tiles a split at
    short rows (splits = min(tiles, 2 blocks an SM x 2 // B) at C <= 64)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import attn_block as ab

    return ab.declare_large(_compile(tmp_path_factory.mktemp("cuda_emu_large_short"),
                                     "attn_block_large",
                                     {"constexpr int kWave = 132;": "constexpr int kWave = 2;"}))


def _call(lib, name, *args):
    err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                               for a in args), None)
    assert err == 0, name


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
    _call(lib, "ccdm_attn_ctx_large", x, g_pre, wqkv, kmax, s, a, torch.empty(-(-nbytes // 4)),
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
    _call(emulated_large, "ccdm_attn_out_large", k["x"], k["g_pre"], k["wqkv"], k["ctx"],
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
    _call(lib, "ccdm_attn_out_large", xs, k["g_pre"], k["wqkv"], k["ctx"], k["wout"], k["bout"],
          k["g_out"], ys, b, n, c, HEADS, D, 1)
    want = ab.out_large_reference(k["x"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"], k["bout"],
                                  k["g_out"], HEADS).float()
    scale = torch.maximum(want.abs(), (want - k["x"].float()).abs())
    assert bool(((ys.float() - want).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.parametrize("batch", [128, 64, 16, 8])
def test_emulated_two_pass_plan_at_the_unet_shapes(emulated_large, batch):
    """The C plan of #2 and #3 at the two-pass shapes: bf16 on the tensor
    cores, 128-token tiles, min(tiles, floor(132 k / B)) blocks a row with k
    = 2 blocks an SM where their shared memory fits twice (C 64) and 1 (C
    128); #2's workspace its f32 records (2 a block, 2F + F D floats each),
    #3's none; UK64's C 72 too, padded to 96 (one block an SM). f32 on the
    CUDA cores: #2 with the first design's splits and its m, s and a
    partials, #3 a block per 32-token tile."""
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
    _call(lib, "ccdm_attn_bwd_a", xs, k["dy"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
          k["bout"], k["g_out"], do, d_ctx, d_wout, d_bout, d_gout,
          torch.empty(-(-plan_a[4] // 4)), b, n, c, heads, d, bf16, plan_a[4])
    dx, d_wqkv, d_gpre = torch.empty_like(k["x"]), torch.empty(c, 3 * F), torch.empty(c)
    _call(lib, "ccdm_attn_bwd_b", xs, k["dy"], k["do"], k["g_pre"], k["wqkv"], k["ctx"],
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
    _call(emulated_large, "ccdm_attn_out_large", k["x"], k["g_pre"], k["wqkv"], k["ctx"],
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
                for n, c in _unet_attn_shapes(size, mults, dim) if n % 2048 == 0}
    assert two_pass == set(TWO_PASS_SHAPES) - {(2048, 64)}


@pytest.mark.parametrize("batch", [128, 64, 16, 8])
def test_emulated_bwd_plan_at_the_unet_shapes(emulated_large, batch):
    """The C plan of #4 and #5 at the two-pass shapes: bf16 on the tensor
    cores, 128-token tiles, min(tiles, max(1, floor(132 / B))) blocks a row
    (one an SM, one wave); #4's workspace its f32 partials (d_ctx, dbout,
    dg_out, dWout), #5's xn and d_qkv in bf16, its dg_pre partials and
    min(264 / output tiles, ceil(B N / 32)) token splits of dWqkv (264
    blocks of 64 x 128 outputs), UK64's C 72 included (padded to 96 in
    shared memory; its workspace at C 72); f32 on the CUDA cores with the
    first design's splits."""
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


# --------------------------------------- kernels #10 and #11 (resnet block)

RESNET_ROUTES = ("f32", "fused", "split")


@pytest.fixture(scope="module")
def emulated_resnet(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import resnet_block as rb

    return rb.declare(_compile(tmp_path_factory.mktemp("cuda_emu_resnet"), "resnet_block"))


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
    _call(lib, "ccdm_resnet_half_a", x, scale, shift, w1, b1, g1, h1, ws,
          b, hh, ww, cin, cout, bf16, nbytes)
    want_h1 = rb.half_a_reference(x, scale, shift, w1, b1, g1, hh, ww)
    assert bool(torch.isfinite(h1.float()).all())
    torch.testing.assert_close(h1.float(), want_h1.float(), **tol)

    route_b, ws, nbytes = _resnet_plan(lib, 1, b, hh, ww, cin, cout, int(has_res), bf16)
    y = torch.empty(b, hh * ww, cout, dtype=dt)
    _call(lib, "ccdm_resnet_half_b", want_h1, x, w2, b2, g2, wres, bres, y, ws,
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


PTX_HARNESS = r"""
#include <cstdint>
extern "C" void emu_ldmatrix(const uint16_t* m, uint32_t* out, int trans) {
  emu::launch(dim3(1), dim3(32), 0, nullptr, [=]() {
    const int l = threadIdx.x;
    uint32_t r[4];
    const uint16_t* row = m + 64 * (l / 8) + 8 * (l % 8);  // row l % 8 of matrix l / 8
    if (trans) ldmatrix_x4_trans(r, row); else ldmatrix_x4(r, row);
    for (int i = 0; i < 4; ++i) out[4 * l + i] = r[i];
  });
}
extern "C" void emu_mma(const uint32_t* a, const uint32_t* b, float* d) {
  emu::launch(dim3(1), dim3(32), 0, nullptr, [=]() {
    const int l = threadIdx.x;
    const uint32_t ar[4] = {a[4 * l], a[4 * l + 1], a[4 * l + 2], a[4 * l + 3]};
    const uint32_t br[2] = {b[2 * l], b[2 * l + 1]};
    float dr[4] = {d[4 * l], d[4 * l + 1], d[4 * l + 2], d[4 * l + 3]};
    mma_16816(dr, ar, br);
    for (int i = 0; i < 4; ++i) d[4 * l + i] = dr[i];
  });
}
extern "C" void emu_cp_async(void* dst, const void* src, int src_bytes) {
  cp_async_16(dst, src, src_bytes);
  cp_async_commit();
  cp_async_wait<0>();
}
"""


@pytest.fixture(scope="module")
def ptx_harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulation")
    d = tmp_path_factory.mktemp("cuda_emu_ptx")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "harness.cpp").write_text(PTX_HARNESS)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{d}",
                    "-include", "cuda_runtime.h", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emu_ldmatrix.argtypes = [p, p, i]
    lib.emu_mma.argtypes = [p, p, p]
    lib.emu_cp_async.argtypes = [p, p, i]
    return lib


def _bf16_bits(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().view(torch.int16).numpy() \
        .astype(np.uint32) & 0xFFFF


def _pack(lo, hi):
    return (lo | (hi << 16)).astype(np.uint32)


@pytest.mark.parametrize("trans", [0, 1])
def test_emulated_ldmatrix_follows_the_isa(ptx_harness, trans):
    """ldmatrix .x4: lane l gives row l % 8 of matrix l / 8; register i of
    lane l holds row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of matrix i
    (.trans: of its transpose), the lower element in the low half."""
    m = np.arange(256, dtype=np.uint16)
    out = np.zeros(128, np.uint32)
    ptx_harness.emu_ldmatrix(m.ctypes.data, out.ctypes.data, trans)
    mats = m.reshape(4, 8, 8).astype(np.uint32)
    if trans:
        mats = mats.transpose(0, 2, 1)
    lane = np.arange(32)
    row, col = lane // 4, 2 * (lane % 4)
    want = np.stack([_pack(mats[i, row, col], mats[i, row, col + 1]) for i in range(4)], axis=1)
    np.testing.assert_array_equal(out.reshape(32, 4), want)


def test_emulated_mma_follows_the_isa(ptx_harness):
    """mma.m16n8k16 .row.col, bf16 in, f32 accumulate, with the fragments of
    the ISA built here from A [16, 16], B [16, 8] and C [16, 8]: D = A B + C
    exactly (values on a grid of 1/8, sums exact in f32)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-16, 16, (16, 16)) / 8
    b = rng.integers(-16, 16, (16, 8)) / 8
    c = rng.integers(-64, 64, (16, 8)) / 8
    ab, bb = _bf16_bits(a), _bf16_bits(b)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    a_regs = np.stack([_pack(ab[g + 8 * (i % 2), 2 * t + 8 * (i // 2)],
                             ab[g + 8 * (i % 2), 2 * t + 8 * (i // 2) + 1])
                       for i in range(4)], 1)
    b_regs = np.stack([_pack(bb[2 * t + 8 * i, g], bb[2 * t + 8 * i + 1, g])
                       for i in range(2)], 1)
    at = lambda m: np.stack([m[g + 8 * (i // 2), 2 * t + i % 2] for i in range(4)], 1)
    d = np.ascontiguousarray(at(c), np.float32)
    ptx_harness.emu_mma(np.ascontiguousarray(a_regs).ctypes.data,
                        np.ascontiguousarray(b_regs).ctypes.data, d.ctypes.data)
    np.testing.assert_array_equal(d, at(a @ b + c).astype(np.float32))


@pytest.mark.parametrize("src_bytes", [16, 8, 0])
def test_emulated_cp_async_zero_fills(ptx_harness, src_bytes):
    """cp.async 16 bytes with src-size n: n bytes copied, the rest zero."""
    src = np.arange(1, 17, dtype=np.uint8)
    dst = np.full(16, 0xAA, np.uint8)
    ptx_harness.emu_cp_async(dst.ctypes.data, src.ctypes.data, src_bytes)
    np.testing.assert_array_equal(dst, np.concatenate([src[:src_bytes],
                                                       np.zeros(16 - src_bytes, np.uint8)]))


# ---------------------------------- kernels #6-#9 (standalone linear attention)

def _emulated_la(tmp_path_factory, subs=None):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from ccdm_tpu_torch.ops import linear_attention as la

    return la.declare(_compile(tmp_path_factory.mktemp("cuda_emu_la"), "linear_attention", subs))


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
    _call(lib, "ccdm_la_fulllane", q, k, v, out, torch.empty(plan.ws_bytes, dtype=torch.uint8),
          b, n, h, d, int(q.dtype == torch.bfloat16), plan.ws_bytes)
    return out, plan


def _per_head(lib, q, k, v):
    """#9 in the emulation, with the workspace its plan sizes: (out, plan)."""
    from ccdm_tpu_torch.ops import linear_attention as la

    b, n, h, d = q.shape
    plan = la.per_head_plan_of(lib, b, n, h, d, q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    _call(lib, "ccdm_la_per_head", q, k, v, out, torch.empty(plan.ws_bytes, dtype=torch.uint8),
          b, n, h, d, int(q.dtype == torch.bfloat16), plan.ws_bytes)
    return out, plan


def _twopass(lib, k, v, m, chunk):
    """#7 in the emulation, with the workspace its plan sizes: (a, s, plan)."""
    from ccdm_tpu_torch.ops import linear_attention as la

    b, n, h, d = k.shape
    plan = la.twopass_plan_of(lib, b, n, h, d, chunk, k.dtype == torch.bfloat16)
    a, s = torch.empty(b, h, d, d), torch.empty(b, h * d)
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8)
    _call(lib, "ccdm_la_ctx_twopass", k, v, m, a, s, ws, b, n, h, d, chunk,
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
    _call(emulated_la, "ccdm_la_out_twopass", q, ctx, out, b, n, h, d, bf16)
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
    _call(emulated, "ccdm_la_out_twopass", q, ctx, out8, b, n, h, d, 1)
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
    _call(emulated_la, "ccdm_la_out_twopass", q, ctx, out8, b, n, h, d, 1)
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
    for n, _ in _unet_attn_shapes(64, (1, 2, 2, 4, 8)):
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


# ------------------------------------------------------ kernel #12 (bias_act)


@pytest.fixture(scope="module")
def emulated_style(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    lib = _compile(tmp_path_factory.mktemp("cuda_emu_style"), "style_ops")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccdm_bias_act.argtypes = [p, p, p, ctypes.c_longlong, i, i, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float, i, i, p]
    lib.ccdm_bias_act.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c,vec", [(37, 128, 0), (5, 24, 0), (3, 13, 1), (300, 40, 0)])
def test_emulated_bias_act_matches_plain(emulated_style, rows, c, vec, dtype):
    """Kernel #12, every activation (one instantiation each), with and
    without bias, clamp and an explicit gain; a row count off the block's
    tile of 256 threads x 4 packs; 16-byte packs (vec 0) and one value a
    pack (vec 1); at C 40 several blocks whose packs' columns wrap the row
    as they step. Both compute in f32 and round once: f32 to 1e-5, bf16 to
    one unit where a rounding flips (8e-3)."""
    from ccdm_tpu_torch.ops import style_ops as so

    rng = np.random.default_rng(rows * c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(0, 2, (rows, c)).astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)).to(dt)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    for act in so.activation_funcs:
        for bias, gain, clamp in ((None, None, None), (b, 0.5, 1.5)):
            _, alpha, gain, clamp = so._resolve(act, None, gain, clamp)
            y = torch.empty_like(x)
            err = emulated_style.ccdm_bias_act(
                x.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                x.numel(), c, so._ACT_INDEX[act], alpha, gain, clamp, vec,
                int(dt == torch.bfloat16), None)
            assert err == 0, act
            want = so.bias_act_fused_reference(x, bias, act, alpha, gain, clamp)
            torch.testing.assert_close(y.float(), want.float(), **tol, msg=act)

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

HEADS, F = 4, 128

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
using std::min;
using std::max;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
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
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16; float f; std::memcpy(&f, &u, 4); return f;
}
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


def _compile(d, name):
    """g++-compile csrc/<name>.cu behind the emulation into d/lib<name>.so."""
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (d / f"{name}.cpp").write_text(_to_cpp((_build.CSRC_DIR / f"{name}.cu").read_text()))
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{d}",
                    "-include", "cuda_runtime.h", "-o", str(d / f"lib{name}.so"),
                    str(d / f"{name}.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(d / f"lib{name}.so"))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    lib = _compile(tmp_path_factory.mktemp("cuda_emu"), "attn_block")
    lib.ccdm_attn_block_forward.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                            + [ctypes.c_void_p])
    lib.ccdm_attn_block_forward.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (2, 100, 64), (1, 16, 512)])
def test_emulated_kernel_matches_plain_version(emulated, b, n, c, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0 if dtype == "float32" else 1.0, (b, n, c))
    w = (1 + 0.5 * rng.normal(size=c), 0.1 * rng.normal(size=(c, 3 * F)),
         0.1 * rng.normal(size=(F, c)), 0.1 * rng.normal(size=c), 1 + 0.5 * rng.normal(size=c))
    dt = getattr(torch, dtype)
    ins = [torch.from_numpy(a.astype(np.float32)).to(dt).contiguous() for a in (x, *w)]
    y = torch.empty_like(ins[0])
    qkv = torch.empty(b, n, 3 * F)
    ctx = torch.empty(b, HEADS, 32, 32)
    err = emulated.ccdm_attn_block_forward(*(t.data_ptr() for t in ins), y.data_ptr(),
                                           qkv.data_ptr(), ctx.data_ptr(), b, n, c, HEADS,
                                           int(dt == torch.bfloat16), None)
    assert err == 0
    want = attn_block_reference(*(t.float() for t in ins), HEADS, 32)
    got = y.float()
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    else:
        scale = torch.maximum(want.abs(), (want - ins[0].float()).abs())
        assert bool(((got - want).abs() <= 3e-2 + 3e-2 * scale).all())


# ------------------------------------------- kernels #2-#5 (two-pass path)

LARGE_FNS = {"ccdm_attn_ctx_large": (9, 6), "ccdm_attn_out_large": (8, 5),
             "ccdm_attn_bwd_a": (18, 7), "ccdm_attn_bwd_b": (17, 7)}


@pytest.fixture(scope="module")
def emulated_large(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    lib = _compile(tmp_path_factory.mktemp("cuda_emu_large"), "attn_block_large")
    for name, (n_ptr, n_int) in LARGE_FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _call(lib, name, *args):
    err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                               for a in args), None)
    assert err == 0, name


def _large_case(b, n, c, dtype, seed=0):
    """Inputs of kernels #2-#5 as the wrappers pass them (matrices in the
    activation dtype, vectors f32) and the plain versions' intermediates."""
    from ccdm_tpu_torch.ops import attn_block as ab

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = f32(rng.normal(0, 1.0, (b, n, c))).to(dt)
    g_pre, g_out = f32(1 + 0.5 * rng.normal(size=c)), f32(1 + 0.5 * rng.normal(size=c))
    wqkv, wout = f32(0.1 * rng.normal(size=(c, 3 * F))).to(dt), f32(0.1 * rng.normal(size=(F, c))).to(dt)
    bout = f32(0.1 * rng.normal(size=c))
    dy = f32(rng.normal(size=(b, n, c))).to(dt)
    a, s, kmax = ab.ctx_large_reference(x, g_pre, wqkv, HEADS)
    ctx = ab.finalize_ctx(a, s, dt)
    do, d_ctx, *_ = ab.bwd_a_reference(x, dy, g_pre, wqkv, ctx, wout, bout, g_out, HEADS)
    d_a, d_s = ab.finalize_ctx_backward(d_ctx, a, s)
    return dict(x=x, g_pre=g_pre, wqkv=wqkv, wout=wout, bout=bout, g_out=g_out, dy=dy,
                a=a, s=s, kmax=kmax, ctx=ctx, do=do, d_a=d_a.contiguous(), d_s=d_s.contiguous())


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (1, 80, 64)])
def test_emulated_two_pass_forward_matches_plain(emulated_large, b, n, c, dtype):
    from ccdm_tpu_torch.ops import attn_block as ab

    k = _large_case(b, n, c, dtype)
    bf16 = int(dtype == "bfloat16")
    nsplit = ab._splits(b, n)
    m_part, s_part, a_part = (torch.empty(b * nsplit, F), torch.empty(b * nsplit, F),
                              torch.empty(b * nsplit, F, 32))
    kmax, s, a = torch.empty(b, F), torch.empty(b, F), torch.empty(b, HEADS, 32, 32)
    _call(emulated_large, "ccdm_attn_ctx_large", k["x"], k["g_pre"], k["wqkv"], m_part, s_part,
          a_part, kmax, s, a, b, n, c, HEADS, nsplit, bf16)
    torch.testing.assert_close(kmax, k["kmax"], rtol=1e-5, atol=1e-5)
    _close(s, k["s"], dtype, "s")
    _close(a, k["a"], dtype, "a")

    y = torch.empty_like(k["x"])
    _call(emulated_large, "ccdm_attn_out_large", k["x"], k["g_pre"], k["wqkv"], k["ctx"],
          k["wout"], k["bout"], k["g_out"], y, b, n, c, HEADS, bf16)
    want = ab.out_large_reference(k["x"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
                                  k["bout"], k["g_out"], HEADS)
    if dtype == "float32":
        torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-4)
    else:
        scale = torch.maximum(want.float().abs(), (want.float() - k["x"].float()).abs())
        assert bool(((y.float() - want.float()).abs() <= 3e-2 + 3e-2 * scale).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 64, 32), (1, 80, 64)])
def test_emulated_fused_backward_matches_plain(emulated_large, b, n, c, dtype):
    from ccdm_tpu_torch.ops import attn_block as ab

    k = _large_case(b, n, c, dtype, seed=1)
    dt = getattr(torch, dtype)
    bf16 = int(dtype == "bfloat16")
    nsplit = ab._splits(b, n)
    nw_a, nw_b = ab._wgrad_splits(b * n, F, c), ab._wgrad_splits(b * n, c, 3 * F)
    do, out_g = torch.empty(b, n, c), torch.empty(b, n, F, dtype=dt)
    d_ctx, d_wout, d_bout, d_gout = (torch.empty(b, HEADS, 32, 32), torch.empty(F, c),
                                     torch.empty(c), torch.empty(c))
    _call(emulated_large, "ccdm_attn_bwd_a", k["x"], k["dy"], k["g_pre"], k["wqkv"], k["ctx"],
          k["wout"], k["bout"], k["g_out"], do, out_g, torch.empty(b * nsplit, F, 32),
          torch.empty(b * nsplit, c), torch.empty(b * nsplit, c), torch.empty(nw_a, F, c),
          d_ctx, d_wout, d_bout, d_gout, b, n, c, HEADS, nsplit, nw_a, bf16)
    want = ab.bwd_a_reference(k["x"], k["dy"], k["g_pre"], k["wqkv"], k["ctx"], k["wout"],
                              k["bout"], k["g_out"], HEADS)
    for name, got, w in zip(("do", "d_ctx", "d_wout", "d_bout", "d_gout"),
                            (do, d_ctx, d_wout, d_bout, d_gout), want):
        _close(got, w, dtype, name)

    dx, xn_g, dqkv_g = (torch.empty_like(k["x"]), torch.empty(b, n, c, dtype=dt),
                        torch.empty(b, n, 3 * F, dtype=dt))
    d_wqkv, d_gpre = torch.empty(c, 3 * F), torch.empty(c)
    _call(emulated_large, "ccdm_attn_bwd_b", k["x"], k["dy"], k["do"], k["g_pre"], k["wqkv"],
          k["ctx"], k["wout"], k["kmax"], k["d_a"], k["d_s"], dx, xn_g, dqkv_g,
          torch.empty(b * nsplit, c), torch.empty(nw_b, c, 3 * F), d_wqkv, d_gpre,
          b, n, c, HEADS, nsplit, nw_b, bf16)
    want = ab.bwd_b_reference(k["x"], k["dy"], k["do"], k["g_pre"], k["wqkv"], k["ctx"],
                              k["wout"], k["kmax"], k["d_a"], k["d_s"], HEADS)
    for name, got, w in zip(("dx", "d_wqkv", "d_gpre"), (dx, d_wqkv, d_gpre), want):
        _close(got, w, dtype, name)


# --------------------------------------- kernels #10 and #11 (resnet block)

RESNET_FNS = {"ccdm_resnet_half_a": (7, 6), "ccdm_resnet_half_b": (8, 7)}


@pytest.fixture(scope="module")
def emulated_resnet(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    lib = _compile(tmp_path_factory.mktemp("cuda_emu_resnet"), "resnet_block")
    for name, (n_ptr, n_int) in RESNET_FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww,cin,cout", [
    (2, 9, 9, 24, 64),   # projection residual; 162 pixels over two 128-pixel tiles
    (2, 6, 6, 128, 128),  # identity residual; 72 pixels over two 64-pixel tiles
    (3, 4, 5, 20, 40),   # Cout 40: one thread of the block idle, a part K slice
])
def test_emulated_resnet_halves_match_plain(emulated_resnet, b, hh, ww, cin, cout, dtype):
    """Kernels #10 and #11 against their plain versions: tiles that cross
    an image and the map border, part K slices, both residuals. Bounds of
    tests/test_resnet_block.py: f32 rtol 2e-3 / atol 2e-4, bf16 4e-2."""
    from ccdm_tpu_torch.ops import resnet_block as rb

    rng = np.random.default_rng(b * 1000 + cin)
    dt = getattr(torch, dtype)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = f32(rng.normal(size=(b, hh * ww, cin))).to(dt)
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

    h1 = torch.empty(b, hh * ww, cout, dtype=dt)
    _call(emulated_resnet, "ccdm_resnet_half_a", x, scale, shift, w1, b1, g1, h1,
          b, hh, ww, cin, cout, bf16)
    want_h1 = rb.half_a_reference(x, scale, shift, w1, b1, g1, hh, ww)
    assert bool(torch.isfinite(h1.float()).all())
    torch.testing.assert_close(h1.float(), want_h1.float(), **tol)

    y = torch.empty(b, hh * ww, cout, dtype=dt)
    _call(emulated_resnet, "ccdm_resnet_half_b", want_h1, x, w2, b2, g2, wres, bres, y,
          b, hh, ww, cin, cout, int(has_res), bf16)
    want = rb.half_b_reference(want_h1, x, w2, b2, g2, wres, bres, hh, ww)
    assert bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), want.float(), **tol)


# ---------------------------------- kernels #6-#9 (standalone linear attention)

LA_FNS = {"ccdm_la_fulllane": (5, 5), "ccdm_la_per_head": (4, 5),
          "ccdm_la_ctx_twopass": (7, 6), "ccdm_la_out_twopass": (3, 5)}


@pytest.fixture(scope="module")
def emulated_la(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    lib = _compile(tmp_path_factory.mktemp("cuda_emu_la"), "linear_attention")
    for name, (n_ptr, n_int) in LA_FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    out, ctx = torch.empty_like(q), torch.empty(b, h, d, d, dtype=q.dtype)
    _call(emulated_la, "ccdm_la_fulllane", q, k, v, ctx, out, b, n, h, d, bf16)
    assert bool(torch.isfinite(out.float()).all())
    want6, want9 = la.fulllane_reference(q, k, v), la.linear_attention_reference(q, k, v)
    _la_close(out, want6, dtype)
    out9 = torch.empty_like(q)
    _call(emulated_la, "ccdm_la_per_head", q, k, v, out9, b, n, h, d, bf16)
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
    f, nc = h * d, -(-n // chunk)
    m = k.float().amax(1).reshape(b, f).contiguous()
    a, s = torch.empty(b, h, d, d), torch.empty(b, f)
    _call(emulated_la, "ccdm_la_ctx_twopass", k, v, m, torch.empty(b, nc, h, d, d),
          torch.empty(b, nc, f), a, s, b, n, h, d, chunk, bf16)
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
@pytest.mark.parametrize("rows,c,vec", [(37, 128, 0), (5, 24, 0), (3, 13, 1)])
def test_emulated_bias_act_matches_plain(emulated_style, rows, c, vec, dtype):
    """Kernel #12, every activation, with and without bias, clamp and an
    explicit gain; a row count off the 256-thread tile; 16-byte vectors
    (vec 0) and one value a thread (vec 1). Both compute in f32 and round
    once: f32 to 1e-5, bf16 to one unit where a rounding flips (8e-3)."""
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

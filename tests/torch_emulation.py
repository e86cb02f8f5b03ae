"""The emulation that compiles the port's CUDA sources for the CPU.

There is no nvcc here, so each source of ccdm_tpu_torch/csrc/ is compiled
with g++ behind a small emulation of the CUDA built-ins it uses: each CUDA
thread of a block is a fiber on the calling thread, run in turn until it
waits at a barrier (`__syncthreads`, the warp shuffles) or ends, in
ascending and descending thread order by turns (so a missing barrier shows
whichever thread wrote what another reads), shared
memory is memory shared by those fibers (NaN at the start of a block),
blocks run one after another; `mma.sync` m16n8k16, `ldmatrix` (.x4, .trans) and
`cp.async` follow the PTX ISA's fragment layouts (each lane publishes its
operands, the warp meets at a barrier). The tests/test_torch_cuda_emulation_*.py
files hold each library's kernels against their plain PyTorch versions on
small shapes, at the bounds the card's checks use: that checks a kernel's
own indexing, tiling, masking and arithmetic. It cannot show that nvcc
accepts the source or how the card schedules it: chip_smoke.py does that on
the card.
"""

import ctypes
import subprocess

import torch

from ccdm_tpu_torch.ops import _build

HEADS, D, F = 4, 32, 128

CUDA_RUNTIME_H = r"""
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
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
// A block's CUDA threads are fibers on the calling thread (ucontext), run in
// turn: each runs until it waits at a barrier or ends, then the next one
// resumes. No OS thread waits on another, so a launch costs the same on a
// loaded machine as on an idle one.
inline dim3 tid, bid;
inline dim3 grid_dim;
inline ucontext_t scheduler;
inline std::vector<ucontext_t> fibers;
inline std::vector<char> finished;
inline int current = 0;
inline std::function<void()> fiber_body;
inline void yield() { swapcontext(&fibers[current], &scheduler); }
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void arrive_and_wait() {
    const unsigned phase = phase_;
    if (++arrived_ == n_) {
      arrived_ = 0;
      ++phase_;
      return;
    }
    while (phase_ == phase) yield();
  }

 private:
  const int n_;
  int arrived_ = 0;
  unsigned phase_ = 0;
};
inline Barrier* block_barrier = nullptr;
inline std::vector<Barrier*> warp_barriers;
inline float exchange[64][32];
inline float* dynamic_smem = nullptr;
inline void fiber_entry() {
  fiber_body();
  finished[current] = 1;  // returns to the scheduler through uc_link
}
// The blocks run one after another, each with shared memory filled with NaN
// (reads before writes show).
template <typename F>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F body) {
  constexpr size_t kStack = 256 * 1024;
  const int n = block.x;
  grid_dim = grid;
  Barrier bar(n);
  block_barrier = &bar;
  std::vector<Barrier*> warps;
  for (int w = 0; w < n / 32; ++w) warps.push_back(new Barrier(32));
  warp_barriers = warps;
  std::vector<float> shared(smem / sizeof(float) + 4);
  dynamic_smem = shared.data();
  std::vector<char> stacks(static_cast<size_t>(n) * kStack);
  fibers.assign(n, ucontext_t{});
  finished.assign(n, 0);
  fiber_body = body;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      bid = dim3(bx, by, bz);
      std::fill(shared.begin(), shared.end(), NAN);
      for (int t = 0; t < n; ++t) {
        getcontext(&fibers[t]);
        fibers[t].uc_stack.ss_sp = stacks.data() + static_cast<size_t>(t) * kStack;
        fibers[t].uc_stack.ss_size = kStack;
        fibers[t].uc_link = &scheduler;
        makecontext(&fibers[t], fiber_entry, 0);
        finished[t] = 0;
      }
      // Each round resumes every fiber once, in ascending and descending tid
      // order by turns (an odd block starts descending): a read that lacks
      // its barrier sees a write of a lower tid in one order and not in the
      // other, so it shows whichever thread wrote.
      const unsigned odd = ((bz * grid.y + by) * grid.x + bx) % 2;
      for (unsigned left = n, round = odd; left > 0; ++round)
        for (int i = 0; i < n; ++i) {
          const int t = round % 2 ? n - 1 - i : i;
          if (finished[t]) continue;
          current = t;
          tid = dim3(t);
          swapcontext(&scheduler, &fibers[t]);
          left -= finished[t];
        }
    }
  for (auto* w : warps) delete w;
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


def to_cpp(src: str) -> str:
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


def compile_emulated(d, name, subs=None):
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
    (d / f"{name}.cpp").write_text(to_cpp(texts[f"{name}.cu"]))
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{d}",
                    f"-I{_build.CSRC_DIR}", "-include", "cuda_runtime.h",
                    "-o", str(d / f"lib{name}.so"), str(d / f"{name}.cpp")],
                   check=True, timeout=300)
    return ctypes.CDLL(str(d / f"lib{name}.so"))


def call(lib, name, *args):
    """lib.name(*args, stream=None), tensors passed by their data pointers;
    asserts the cudaError_t it returns is 0."""
    err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                               for a in args), None)
    assert err == 0, name


def unet_attn_shapes(size, mults, dim=64):
    """(N, C) of a UNet's attention blocks: each down level at its input
    width, each up level at its output width (models/unet.py)."""
    dims = [dim] + [dim * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    down = [((size >> i) ** 2, c_in) for i, (c_in, _) in enumerate(pairs)]
    up = [((size >> (len(pairs) - 1 - i)) ** 2, c_out)
          for i, (_, c_out) in enumerate(reversed(pairs))]
    return down + up

// Fused resnet block halves for Hopper (sm_90a): kernels #10 and #11.
//
// Replace the TPU kernels ccdm_tpu/ops/resnet_block.py:_kernel_a and
// _kernel_b (launched by _forward_pallas). For x [B, H*W, Cin] (token-major,
// the NHWC map), tap-major conv weights w [9*Cin, Cout] (row
// (ky*3 + kx)*Cin + ci, the HWIO kernel flattened) and f32 vectors:
//
//   #10 resnet_half_a: h1 = SiLU(FiLM(RMSNorm_g1(conv3x3(x) + b1)))
//   #11 resnet_half_b: y  = SiLU(RMSNorm_g2(conv3x3(h1) + b2)) + res,
//                      res = x when Cin == Cout, else x . Wres + bres
//
// with FiLM h * (scale + 1) + shift per (image, channel), RMSNorm
// h * rsqrt(mean_c(h^2) + 1e-12) * g, SAME zero padding. The products take
// their operands in the activation type (bf16 or f32) and accumulate in f32;
// the bias, norm, FiLM, SiLU and residual run in f32; h1 and y are written in
// the activation type. That is the contract of the TPU kernels. Partial sums
// that pass through device memory stay f32.
//
// The conv is an implicit GEMM: M = B*H*W pixels (tiles run across images),
// N = Cout, K = 9*Cin, in K slices of one tap (dy, dx) x 64 channels. The A
// slice is a gather of the tap's shifted pixels, zero off the map.
//
// What bounds it on this card (NVIDIA H100 SXM, 700 W, data-sheet peaks of
// 989 TFLOP/s bf16 and 3.35 TB/s): one B-64 CFG forward of the RC-49 64x64
// UNet runs 23 launches of each half, 518 GFLOP in all. Per level, the least
// time of both halves' launches is 0.338 ms at 64x64 (bytes), 0.129 at 32x32,
// 0.051 at 16x16, 0.031 at 8x8 and 0.051 at 4x4 (operations): 0.60 ms. So
// the products decide, and at the small maps the few pixels: at 4x4, B 64,
// M is 1024, while K reaches 9*768.
//
// Two routes, chosen by dtype in the entry points (never on failure):
// - f32: the products as f32 FMAs on the CUDA cores (fma_* below), one block
//   owning all of Cout for its pixel tile. It serves the f32 checks, whose
//   bounds TF32 would break.
// - bf16: the products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   accumulate) from shared memory through ldmatrix (.trans for w, which is
//   [K, Cout] row-major), fed by a 3-stage cp.async ring: 16-byte copies of
//   8 channels, src-size 0 for a tap off the map or a channel past the end,
//   so the zeros of the padding cost no branch. Rows of the ring are padded
//   (144 bytes for A, BN*2 + 16 for w) so that ldmatrix has no bank conflicts.
//   Channels not a multiple of 8, or a base not 16-byte aligned, take a
//   predicated element load into the same layout instead. 8 warps, warp tiles
//   32 x 32. A host plan (make_plan, a function of the shape alone) picks:
//   * fused: Cout <= 128 and at least a wave of blocks (132, the SMs). A
//     block owns whole pixel rows (128 px x 64 ch, or 64 px x 128 ch), so the
//     bias, the sum of squares (reduced over the warps through shared memory
//     in a fixed order), norm, FiLM, SiLU, residual and the bf16 store are
//     the launch's epilogue. #11's 1x1 projection runs through the same
//     pipeline into a second accumulator after the conv's norm and SiLU,
//     since the residual is added after them.
//   * split: every other shape (Cout 256 and 512 at the 8x8 and 4x4 maps, and
//     the small batches). Pass 1 tiles (M, Cout, K split) into 64 x 128 tiles,
//     K split so that the grid is about one wave, and writes f32 partial
//     products to a workspace [splits (+1), M, Cout]; #11's projection is one
//     more slab. Pass 2, one warp a pixel row, sums the splits in split order,
//     adds the bias, norm, FiLM or SiLU and the residual in f32 and writes
//     bf16. Deterministic; no atomics. One C call launches both passes; the
//     caller allocates the workspace.
//   Every epilogue stages its tile in shared memory, so that each thread
//   stores 8 consecutive channels of a row in one 16-byte store. The sizes
//   (K slice 64, 3 stages, split to one wave) won a timed comparison of
//   variants on the card (PERF.md, PR 8).
//
// Every PTX instruction is in the helpers of csrc/ptx.cuh, so that an
// emulation can supply the same names (CCDM_PTX_EMULATED) and run the kernels
// on a CPU with the fragment layouts of the PTX ISA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "common.cuh"

namespace {

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// ------------------------------------------------------ f32: CUDA cores

constexpr int kThreads = 256;
constexpr int kKC = 16;  // channels of one tap per K slice
constexpr int kPX = 4;   // pixels per thread
constexpr int kCH = 8;   // output channels per thread

// The block's tile: cg groups of 8 output channels (Cout rounded up to cpad),
// pg = kThreads / cg groups of 4 pixels, mt = 4 pg pixels. Thread t works on
// channel group t % cg of pixel group t / cg; threads past pg * cg only load.
struct Tile {
  int cg, pg, mt, cpad;
};

__host__ __device__ inline Tile make_tile(int cout) {
  Tile t;
  t.cg = (cout + kCH - 1) / kCH;
  t.pg = kThreads / t.cg;
  t.mt = t.pg * kPX;
  t.cpad = t.cg * kCH;
  return t;
}

// Shared memory in floats: the A slice [kKC][mt], the B slice [kKC][cpad],
// partial sums of squares [mt][cg], the per-pixel 1/rms [mt], and the
// image, row and column of each pixel of the tile (3 x mt ints).
__host__ __device__ inline size_t smem_floats(const Tile& t) {
  return (size_t)kKC * (t.mt + t.cpad) + (size_t)t.mt * t.cg + 4 * (size_t)t.mt;
}

struct Smem {
  float* as;
  float* bs;
  float* red;
  float* inv;
  int* img;  // -1 past the last pixel
  int* row;
  int* col;
};

__device__ __forceinline__ Smem carve(float* smem, const Tile& t) {
  Smem s;
  s.as = smem;
  s.bs = s.as + kKC * t.mt;
  s.red = s.bs + kKC * t.cpad;
  s.inv = s.red + t.mt * t.cg;
  s.img = reinterpret_cast<int*>(s.inv + t.mt);
  s.row = s.img + t.mt;
  s.col = s.row + t.mt;
  return s;
}

__device__ __forceinline__ void locate_pixels(const Smem& s, const Tile& t, int m0, int m_total,
                                              int hh, int ww) {
  const int hw = hh * ww;
  for (int p = threadIdx.x; p < t.mt; p += kThreads) {
    const int m = m0 + p;
    s.img[p] = m < m_total ? m / hw : -1;
    s.row[p] = (m % hw) / ww;
    s.col[p] = m % ww;
  }
  __syncthreads();
}

// acc[i][j] += sum_k A[px0 + i][k] * w[k][ch0 + j] over K = ntaps * cin.
// ntaps 9: the 3x3 SAME conv, A read from src at pixel (row + dy, col + dx)
// of the same image, zero outside the map; ntaps 1: the centre only (the 1x1
// projection, w [cin, cout]). Every thread of the block calls it.
__device__ void fma_accumulate(float (&acc)[kPX][kCH], const float* __restrict__ src, int cin,
                               const float* __restrict__ w, int cout, int ntaps, int hh, int ww,
                               const Smem& s, const Tile& t, int px0, int ch0, bool active) {
  for (int tap = 0; tap < ntaps; ++tap) {
    const int dy = ntaps == 1 ? 0 : tap / 3 - 1;
    const int dx = ntaps == 1 ? 0 : tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += kKC) {
      for (int i = threadIdx.x; i < t.mt * kKC; i += kThreads) {
        const int p = i / kKC, k = i % kKC, ci = c0 + k;
        const int r = s.row[p] + dy, c = s.col[p] + dx;
        float v = 0.f;
        if (s.img[p] >= 0 && ci < cin && r >= 0 && r < hh && c >= 0 && c < ww)
          v = src[(((size_t)s.img[p] * hh + r) * ww + c) * cin + ci];
        s.as[k * t.mt + p] = v;
      }
      for (int i = threadIdx.x; i < kKC * t.cpad; i += kThreads) {
        const int k = i / t.cpad, n = i % t.cpad, ci = c0 + k;
        s.bs[i] = (ci < cin && n < cout) ? w[((size_t)tap * cin + ci) * cout + n] : 0.f;
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int k = 0; k < kKC; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(s.as + k * t.mt + px0);
          const float4 b0 = *reinterpret_cast<const float4*>(s.bs + k * t.cpad + ch0);
          const float4 b1 = *reinterpret_cast<const float4*>(s.bs + k * t.cpad + ch0 + 4);
          const float av[kPX] = {a.x, a.y, a.z, a.w};
          const float bv[kCH] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kPX; ++i)
#pragma unroll
            for (int j = 0; j < kCH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
}

// acc += bias (channels past cout set to 0), then s.inv[p] = 1/rms of each
// pixel's row over Cout. Every thread of the block calls it.
__device__ void fma_bias_and_rms(float (&acc)[kPX][kCH], const float* __restrict__ bias,
                                 int cout, const Smem& s, const Tile& t, int px0, int ch0,
                                 int grp_ch, bool active) {
  if (active) {
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const int n = ch0 + j;
        const float v = n < cout ? acc[i][j] + bias[n] : 0.f;
        acc[i][j] = v;
        ss = fmaf(v, v, ss);
      }
      s.red[(px0 + i) * t.cg + grp_ch] = ss;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < t.mt; p += kThreads) {
    float ss = 0.f;
    for (int g = 0; g < t.cg; ++g) ss += s.red[p * t.cg + g];
    s.inv[p] = rsqrtf(ss / (float)cout + 1e-12f);
  }
  __syncthreads();
}

// #10 in f32: one block per tile of mt pixels, all of Cout.
__global__ void __launch_bounds__(kThreads)
fma_half_a_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ g1,
                  float* __restrict__ h1, int batch, int hh, int ww, int cin, int cout) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = make_tile(cout);
  const Smem s = carve(smem, t);
  const int m0 = blockIdx.x * t.mt;
  locate_pixels(s, t, m0, batch * hh * ww, hh, ww);
  const int grp_ch = threadIdx.x % t.cg;
  const int px0 = (threadIdx.x / t.cg) * kPX, ch0 = grp_ch * kCH;
  const bool active = (int)threadIdx.x < t.pg * t.cg;

  float acc[kPX][kCH] = {};
  fma_accumulate(acc, x, cin, w1, cout, 9, hh, ww, s, t, px0, ch0, active);
  fma_bias_and_rms(acc, b1, cout, s, t, px0, ch0, grp_ch, active);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int p = px0 + i, b = s.img[p];
    if (b < 0) continue;
    const float inv = s.inv[p];
    float* out = h1 + (size_t)(m0 + p) * cout;
#pragma unroll
    for (int j = 0; j < kCH; ++j) {
      const int n = ch0 + j;
      if (n >= cout) continue;
      float v = acc[i][j] * inv * g1[n];
      v = v * (scale[(size_t)b * cout + n] + 1.f) + shift[(size_t)b * cout + n];
      out[n] = silu(v);
    }
  }
}

// #11 in f32: conv3x3 over h1 (Cout channels in), norm, SiLU, then the residual.
__global__ void __launch_bounds__(kThreads)
fma_half_b_kernel(const float* __restrict__ h1, const float* __restrict__ x,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ g2, const float* __restrict__ wres,
                  const float* __restrict__ bres, float* __restrict__ y, int batch, int hh,
                  int ww, int cin, int cout, int has_res) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = make_tile(cout);
  const Smem s = carve(smem, t);
  const int m0 = blockIdx.x * t.mt;
  locate_pixels(s, t, m0, batch * hh * ww, hh, ww);
  const int grp_ch = threadIdx.x % t.cg;
  const int px0 = (threadIdx.x / t.cg) * kPX, ch0 = grp_ch * kCH;
  const bool active = (int)threadIdx.x < t.pg * t.cg;

  float acc[kPX][kCH] = {};
  fma_accumulate(acc, h1, cout, w2, cout, 9, hh, ww, s, t, px0, ch0, active);
  fma_bias_and_rms(acc, b2, cout, s, t, px0, ch0, grp_ch, active);
  if (active) {
#pragma unroll
    for (int i = 0; i < kPX; ++i)
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const int n = ch0 + j;
        acc[i][j] = n < cout ? silu(acc[i][j] * s.inv[px0 + i] * g2[n]) : 0.f;
      }
  }
  float res[kPX][kCH] = {};
  if (has_res) fma_accumulate(res, x, cin, wres, cout, 1, hh, ww, s, t, px0, ch0, active);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int p = px0 + i;
    if (s.img[p] < 0) continue;
    const size_t m = (size_t)(m0 + p);
    float* out = y + m * cout;
#pragma unroll
    for (int j = 0; j < kCH; ++j) {
      const int n = ch0 + j;
      if (n >= cout) continue;
      out[n] = acc[i][j] + (has_res ? res[i][j] + bres[n] : x[m * cin + n]);
    }
  }
}

inline int fma_blocks(int batch, int hh, int ww, const Tile& t) {
  return (batch * hh * ww + t.mt - 1) / t.mt;
}

int fma_launch_a(const void* x, const void* scale, const void* shift, const void* w1,
                 const void* b1, const void* g1, void* h1, int batch, int hh, int ww, int cin,
                 int cout, cudaStream_t stream) {
  const Tile t = make_tile(cout);
  if (t.cg > kThreads) return (int)cudaErrorInvalidValue;  // Cout above 2048
  const size_t smem = smem_floats(t) * sizeof(float);
  const int err = (int)cudaFuncSetAttribute(
      fma_half_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  fma_half_a_kernel<<<fma_blocks(batch, hh, ww, t), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g1), static_cast<float*>(h1),
      batch, hh, ww, cin, cout);
  return (int)cudaGetLastError();
}

int fma_launch_b(const void* h1, const void* x, const void* w2, const void* b2, const void* g2,
                 const void* wres, const void* bres, void* y, int batch, int hh, int ww,
                 int cin, int cout, int has_res, cudaStream_t stream) {
  const Tile t = make_tile(cout);
  if (t.cg > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(t) * sizeof(float);
  const int err = (int)cudaFuncSetAttribute(
      fma_half_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  fma_half_b_kernel<<<fma_blocks(batch, hh, ww, t), kThreads, smem, stream>>>(
      static_cast<const float*>(h1), static_cast<const float*>(x),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(g2), static_cast<const float*>(wres),
      static_cast<const float*>(bres), static_cast<float*>(y), batch, hh, ww, cin, cout,
      has_res);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16: tensor cores

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kBK = 64;            // K slice: one tap x 64 channels (four k16 steps)
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kAStride = kBK + 8;  // bf16 per A row of the ring: 144 bytes
constexpr int kSplitBM = 64, kSplitBN = 128;  // pass-1 tile of the split route
constexpr int kSplitWaves = 1;  // the split route's K splits aim at this many waves of blocks

// A BM x BN block tile over 8 warps of 32 x 32: kMI x kNI mma tiles a warp.
template <int BM, int BN>
struct Tiling {
  static constexpr int kWarpsM = BM == 128 ? 4 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kMI = BM / kWarpsM / 16;
  static constexpr int kNI = BN / kWarpsN / 8;
  static constexpr int kBStride = BN + 8;  // bf16 per w row of the ring
  static constexpr int kAElems = BM * kAStride;
  static constexpr int kStageElems = kAElems + kBK * kBStride;
  static constexpr int kAChunks = BM * kBK / 8 / kMmaThreads;  // 16-byte copies a thread
  static constexpr int kBChunks = kBK * BN / 8 / kMmaThreads;  // per stage
  static constexpr size_t kRingBytes = (size_t)kStages * kStageElems * sizeof(bf16);
  // the ring, then the per-warp sums of squares [BM][kWarpsN] and 1/rms [BM]
  static constexpr size_t kSmemBytes = kRingBytes + (size_t)BM * (kWarpsN + 1) * sizeof(float);
  static constexpr int kStageStride = BN + 8;  // f32 per row of the epilogue's staged tile
  static_assert(kMI == 2 && kNI == 4, "warp tiles are 32 x 32");
  static_assert((size_t)BM * kStageStride * sizeof(float) <= kRingBytes, "the tile fits the ring");
  static_assert(kAChunks >= 1 && kBChunks >= 1, "every thread copies A and w");
};

// One product of the GEMM: src [M, c] gathered by tap, times w [ntaps * c, Cout].
struct Product {
  const bf16* src;
  const bf16* w;
  int c;
  int ntaps;  // 9: the 3x3 SAME conv; 1: the centre tap (the 1x1 projection)
};

struct Geometry {
  int m_total, hh, ww, cout;
  int vec;  // 16-byte copies (else element loads)
};

__device__ __forceinline__ int k_tiles(const Product& p) {
  return p.ntaps * ((p.c + kBK - 1) / kBK);
}

// Where accumulator acc[mi][ni][h * 2 + e] of this thread lies in the block
// tile: warp (wm, wn) of the kWarpsM x kWarpsN grid of 32 x 32 warp tiles.
template <int BM, int BN>
struct Frag {
  int wm, wn, lane;
  __device__ Frag() {
    const int warp = threadIdx.x / 32;
    wm = warp / Tiling<BM, BN>::kWarpsN;
    wn = warp % Tiling<BM, BN>::kWarpsN;
    lane = threadIdx.x % 32;
  }
  __device__ int row(int mi, int h) const { return wm * 32 + mi * 16 + (lane >> 2) + h * 8; }
  __device__ int col(int ni, int e) const { return wn * 32 + ni * 8 + (lane & 3) * 2 + e; }
};

// acc += the product over K tiles [kt0, kt1) for the block tile at (m0, n0).
// Ends with the ring drained and the block synchronised. Every thread calls it.
template <int BM, int BN>
__device__ void mma_product(float (&acc)[2][4][4], const Product& p, const Geometry& g, int m0,
                            int n0, int kt0, int kt1, bf16* ring) {
  using T = Tiling<BM, BN>;
  const int tid = threadIdx.x;
  const Frag<BM, BN> f;
  const int hw = g.hh * g.ww, chunks = (p.c + kBK - 1) / kBK;
  const bf16 zero = __float2bfloat16(0.f);

  // the row and column of each pixel this thread copies (row far off the map
  // past the last pixel)
  int a_m[T::kAChunks], a_r[T::kAChunks], a_c[T::kAChunks];
#pragma unroll
  for (int i = 0; i < T::kAChunks; ++i) {
    const int m = m0 + (tid + i * kMmaThreads) / (kBK / 8);
    a_m[i] = m;
    a_r[i] = m < g.m_total ? (m % hw) / g.ww : -(1 << 20);
    a_c[i] = m % g.ww;
  }

  auto load_tile = [&](int slot, int kt) {
    const int tap = kt / chunks, c0 = (kt % chunks) * kBK;
    const int dy = p.ntaps == 1 ? 0 : tap / 3 - 1, dx = p.ntaps == 1 ? 0 : tap % 3 - 1;
    bf16* as = ring + slot * T::kStageElems;
    bf16* bs = as + T::kAElems;
#pragma unroll
    for (int i = 0; i < T::kAChunks; ++i) {
      const int idx = tid + i * kMmaThreads, row = idx / (kBK / 8), q = idx % (kBK / 8);
      const int ci = c0 + q * 8;
      const int r = a_r[i] + dy, c = a_c[i] + dx;
      const bool in = r >= 0 && r < g.hh && c >= 0 && c < g.ww;
      const bf16* s = in ? p.src + ((size_t)(a_m[i] + dy * g.ww + dx) * p.c + ci) : p.src;
      bf16* d = as + row * kAStride + q * 8;
      if (g.vec) {
        cp_async_16(d, in && ci < p.c ? s : p.src, in && ci < p.c ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = in && ci + e < p.c ? s[e] : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < T::kBChunks; ++i) {
      const int idx = tid + i * kMmaThreads, k = idx / (BN / 8), j = idx % (BN / 8);
      const int ci = c0 + k, n = n0 + j * 8;
      const bool ok = ci < p.c && n < g.cout;
      const bf16* s = ok ? p.w + ((size_t)(tap * p.c + ci) * g.cout + n) : p.w;
      bf16* d = bs + k * T::kBStride + j * 8;
      if (g.vec) {
        cp_async_16(d, s, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = ok && n + e < g.cout ? s[e] : zero;
      }
    }
  };

  const int n_kt = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_tile(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed
    __syncthreads();               // ... for every thread; and slot (i - 1) is free
    if (i + kStages - 1 < n_kt) load_tile((i + kStages - 1) % kStages, kt0 + i + kStages - 1);
    cp_async_commit();
    const bf16* as = ring + (i % kStages) * T::kStageElems;
    const bf16* bs = as + T::kAElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], as + (f.wm * 32 + mi * 16 + (f.lane & 15)) * kAStride + kk +
                                (f.lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], bs + (kk + (f.lane & 15)) * T::kBStride + f.wn * 32 +
                                       nj * 16 + (f.lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t b[2] = {bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]};
          mma_16816(acc[mi][ni], af[mi], b);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc += bias (channels past Cout set to 0); inv[r] = 1/rms of each pixel row
// r of the tile, its sum of squares reduced over the quad by shuffles and
// over the warps through shared memory, in a fixed order. Every thread calls it.
template <int BM, int BN>
__device__ void bias_and_rms(float (&acc)[2][4][4], const float* __restrict__ bias, int cout,
                             float* red, float* inv) {
  using T = Tiling<BM, BN>;
  const Frag<BM, BN> f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = f.col(ni, e);
          const float v = n < cout ? acc[mi][ni][h * 2 + e] + bias[n] : 0.f;
          acc[mi][ni][h * 2 + e] = v;
          ss = fmaf(v, v, ss);
        }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if ((f.lane & 3) == 0) red[f.row(mi, h) * T::kWarpsN + f.wn] = ss;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += kMmaThreads) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < T::kWarpsN; ++j) ss += red[r * T::kWarpsN + j];
    inv[r] = rsqrtf(ss / (float)cout + 1e-12f);
  }
  __syncthreads();
}

// Writes the tile (accumulator layout) to shared memory as f32 rows of
// kStageStride (the ring is free by then; float2 writes without bank
// conflicts), then synchronises, so that each thread can take 8 consecutive
// channels of a row for the global store.
template <int BM, int BN>
__device__ void stage_tile(const float (&acc)[2][4][4], float* stage) {
  constexpr int stride = Tiling<BM, BN>::kStageStride;
  const Frag<BM, BN> f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(stage + f.row(mi, h) * stride + f.col(ni, 0)) =
            float2{acc[mi][ni][h * 2], acc[mi][ni][h * 2 + 1]};
  __syncthreads();
}

// Stores v[0..7] at dst: one 16-byte store (bf16) or two (f32) where vec
// (dst 16-byte aligned), else the first n_valid one by one.
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8], int n_valid, int vec) {
  if (vec) {
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(o);
  } else {
    for (int e = 0; e < 8 && e < n_valid; ++e) dst[e] = __float2bfloat16(v[e]);
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8], int n_valid, int vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = float4{v[0], v[1], v[2], v[3]};
    reinterpret_cast<float4*>(dst)[1] = float4{v[4], v[5], v[6], v[7]};
  } else {
    for (int e = 0; e < 8 && e < n_valid; ++e) dst[e] = v[e];
  }
}

// #10, fused route: one block per BM pixel rows, all of Cout (<= BN).
template <int BM, int BN>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_a_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ shift, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ g1,
               bf16* __restrict__ h1, Geometry g, int cin) {
  extern __shared__ __align__(16) float smem[];
  using T = Tiling<BM, BN>;
  float* red = smem + T::kRingBytes / sizeof(float);
  float* inv = red + BM * T::kWarpsN;
  const int m0 = blockIdx.x * BM, hw = g.hh * g.ww, cout = g.cout;
  const Product conv{x, w1, cin, 9};
  float acc[2][4][4] = {};
  mma_product<BM, BN>(acc, conv, g, m0, 0, 0, k_tiles(conv), reinterpret_cast<bf16*>(smem));
  bias_and_rms<BM, BN>(acc, b1, cout, red, inv);
  float* stage = smem;
  stage_tile<BM, BN>(acc, stage);
  for (int idx = threadIdx.x; idx < BM * BN / 8; idx += kMmaThreads) {
    const int r = idx / (BN / 8), n = (idx % (BN / 8)) * 8, m = m0 + r;
    if (m >= g.m_total || n >= cout) continue;
    const float* h = stage + r * T::kStageStride + n;
    const size_t film = (size_t)(m / hw) * cout;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = n + e < cout ? n + e : n;  // past Cout: computed, not stored
      const float u = h[e] * inv[r] * g1[c];
      v[e] = silu(u * (scale[film + c] + 1.f) + shift[film + c]);
    }
    store8(h1 + (size_t)m * cout + n, v, cout - n, g.vec);
  }
}

// #11, fused route: the conv over h1, its norm and SiLU, then the residual
// (the 1x1 projection through the same pipeline into a second accumulator).
template <int BM, int BN>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_b_kernel(const bf16* __restrict__ h1, const bf16* __restrict__ x,
               const bf16* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ g2, const bf16* __restrict__ wres,
               const float* __restrict__ bres, bf16* __restrict__ y, Geometry g, int cin,
               int has_res) {
  extern __shared__ __align__(16) float smem[];
  using T = Tiling<BM, BN>;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* red = smem + T::kRingBytes / sizeof(float);
  float* inv = red + BM * T::kWarpsN;
  const int m0 = blockIdx.x * BM, cout = g.cout;
  const Product conv{h1, w2, cout, 9};
  float acc[2][4][4] = {};
  mma_product<BM, BN>(acc, conv, g, m0, 0, 0, k_tiles(conv), ring);
  bias_and_rms<BM, BN>(acc, b2, cout, red, inv);
  const Frag<BM, BN> f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = f.col(ni, e);
          float& v = acc[mi][ni][h * 2 + e];
          v = n < cout ? silu(v * inv[f.row(mi, h)] * g2[n]) : 0.f;
        }
  float res[2][4][4] = {};
  if (has_res) {
    const Product proj{x, wres, cin, 1};
    mma_product<BM, BN>(res, proj, g, m0, 0, 0, k_tiles(proj), ring);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = f.col(ni, i % 2);
          acc[mi][ni][i] += n < cout ? res[mi][ni][i] + bres[n] : 0.f;
        }
  }
  float* stage = smem;
  stage_tile<BM, BN>(acc, stage);
  for (int idx = threadIdx.x; idx < BM * BN / 8; idx += kMmaThreads) {
    const int r = idx / (BN / 8), n = (idx % (BN / 8)) * 8, m = m0 + r;
    if (m >= g.m_total || n >= cout) continue;
    const float* h = stage + r * T::kStageStride + n;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = h[e] + (has_res || n + e >= cout ? 0.f
                                              : __bfloat162float(x[(size_t)m * cin + n + e]));
    store8(y + (size_t)m * cout + n, v, cout - n, g.vec);
  }
}

// Split route, pass 1: block (m tile, n tile, z) writes the f32 partial
// product of K split z < splits of `conv` to slab z of ws [slabs, M, Cout];
// z == splits (with a projection) writes `proj`, whole, to the last slab.
__global__ void __launch_bounds__(kMmaThreads, 2)
partial_kernel(Product conv, Product proj, float* __restrict__ ws, Geometry g, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z, m0 = blockIdx.x * kSplitBM, n0 = blockIdx.y * kSplitBN;
  const Product p = z < splits ? conv : proj;
  const int kt = k_tiles(p);
  const int kt0 = z < splits ? (int)((long long)z * kt / splits) : 0;
  const int kt1 = z < splits ? (int)((long long)(z + 1) * kt / splits) : kt;
  float acc[2][4][4] = {};
  mma_product<kSplitBM, kSplitBN>(acc, p, g, m0, n0, kt0, kt1, reinterpret_cast<bf16*>(smem));
  stage_tile<kSplitBM, kSplitBN>(acc, smem);
  float* out = ws + (size_t)z * g.m_total * g.cout;
  constexpr int stride = Tiling<kSplitBM, kSplitBN>::kStageStride;
  for (int idx = threadIdx.x; idx < kSplitBM * kSplitBN / 8; idx += kMmaThreads) {
    const int r = idx / (kSplitBN / 8), c = (idx % (kSplitBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= g.m_total || n >= g.cout) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = smem[r * stride + c + e];
    store8(out + (size_t)m * g.cout + n, v, g.cout - n, g.vec);
  }
}

constexpr int kResNone = 0, kResIdentity = 1, kResProj = 2;

// Split route, pass 2: one warp per pixel row m. h = (sum of the splits in
// order) + bias; #10 (residual kResNone): SiLU(FiLM(norm(h))); #11:
// SiLU(norm(h)) + x (kResIdentity) or + the projection slab + bres.
__global__ void __launch_bounds__(kMmaThreads)
split_epilogue_kernel(const float* __restrict__ ws, int splits, int m_total, int hw, int cout,
                      const float* __restrict__ bias, const float* __restrict__ gain,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const bf16* __restrict__ x, int cin, const float* __restrict__ bres,
                      int residual, bf16* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (kMmaThreads / 32) + threadIdx.x / 32;
  const int mm = m < m_total ? m : m_total - 1;  // every lane takes part in the shuffles
  const size_t slab = (size_t)m_total * cout;
  const float* row = ws + (size_t)mm * cout;
  auto pre = [&](int n) {
    float h = row[n];
    for (int s = 1; s < splits; ++s) h += row[s * slab + n];
    return h + bias[n];
  };
  float ss = 0.f;
  for (int n = lane; n < cout; n += 32) {
    const float h = pre(n);
    ss = fmaf(h, h, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (m >= m_total) return;
  const float inv = rsqrtf(ss / (float)cout + 1e-12f);
  const size_t film = (size_t)(m / hw) * cout;
  for (int n = lane; n < cout; n += 32) {
    float v = pre(n) * inv * gain[n];
    if (residual == kResNone) {
      v = silu(v * (scale[film + n] + 1.f) + shift[film + n]);
    } else {
      v = silu(v) + (residual == kResProj ? row[splits * slab + n] + bres[n]
                                          : __bfloat162float(x[(size_t)m * cin + n]));
    }
    out[(size_t)m * cout + n] = __float2bfloat16(v);
  }
}

// ------------------------------------------------------------- the plan

int g_wave = 132;  // blocks that fill the card once: the SMs of an H100 SXM

constexpr int kRouteF32 = 0, kRouteFused = 1, kRouteSplit = 2;

struct Plan {
  int route, bm, bn, splits;
  long long ws_bytes;  // f32 workspace of the split route
};

// The route and tiles of one call, a function of its shape alone. half_b: the
// conv's K runs over Cout channels (h1), plus a projection slab if has_res.
Plan make_plan(int half_b, int batch, int hh, int ww, int cin, int cout, int has_res,
               int is_bf16) {
  Plan p{kRouteF32, 0, 0, 1, 0};
  if (!is_bf16) return p;
  const long long m = (long long)batch * hh * ww;
  const int bm = cout <= 64 ? 128 : 64;
  if (cout <= 128 && (m + bm - 1) / bm >= g_wave) {
    p.route = kRouteFused;
    p.bm = bm;
    p.bn = cout <= 64 ? 64 : 128;
    return p;
  }
  p.route = kRouteSplit;
  p.bm = kSplitBM;
  p.bn = kSplitBN;
  const long long tiles = ((m + kSplitBM - 1) / kSplitBM) * ((cout + kSplitBN - 1) / kSplitBN);
  const int kt = 9 * (((half_b ? cout : cin) + kBK - 1) / kBK);
  long long splits = ((long long)kSplitWaves * g_wave + tiles - 1) / tiles;
  if (splits > kt / 4) splits = kt / 4;                      // at least 4 K tiles a split
  if (splits > 8) splits = 8;
  p.splits = splits < 1 ? 1 : (int)splits;
  p.ws_bytes = (long long)(p.splits + (half_b && has_res ? 1 : 0)) * m * cout * sizeof(float);
  return p;
}

template <int BM, int BN>
int launch_fused_a(const void* x, const void* scale, const void* shift, const void* w1,
                   const void* b1, const void* g1, void* h1, const Geometry& g, int cin,
                   cudaStream_t stream) {
  using T = Tiling<BM, BN>;
  const int err = allow_smem<fused_a_kernel<BM, BN>>(T::kSmemBytes);
  if (err) return err;
  fused_a_kernel<BM, BN><<<(g.m_total + BM - 1) / BM, kMmaThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g1), static_cast<bf16*>(h1), g,
      cin);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_fused_b(const void* h1, const void* x, const void* w2, const void* b2, const void* g2,
                   const void* wres, const void* bres, void* y, const Geometry& g, int cin,
                   int has_res, cudaStream_t stream) {
  using T = Tiling<BM, BN>;
  const int err = allow_smem<fused_b_kernel<BM, BN>>(T::kSmemBytes);
  if (err) return err;
  fused_b_kernel<BM, BN><<<(g.m_total + BM - 1) / BM, kMmaThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(x), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const bf16*>(wres), static_cast<const float*>(bres), static_cast<bf16*>(y), g,
      cin, has_res);
  return (int)cudaGetLastError();
}

// Both passes of the split route.
int launch_split(const Product& conv, const Product& proj, int slabs, void* ws, const Plan& p,
                 const Geometry& g, const void* bias, const void* gain, const void* scale,
                 const void* shift, const void* x, int cin, const void* bres, int residual,
                 void* out, cudaStream_t stream) {
  using T = Tiling<kSplitBM, kSplitBN>;
  int err = allow_smem<partial_kernel>(T::kSmemBytes);
  if (err) return err;
  const dim3 grid((g.m_total + kSplitBM - 1) / kSplitBM, (g.cout + kSplitBN - 1) / kSplitBN,
                  slabs);
  partial_kernel<<<grid, kMmaThreads, T::kSmemBytes, stream>>>(conv, proj,
                                                               static_cast<float*>(ws), g,
                                                               p.splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int rows_per_block = kMmaThreads / 32;
  split_epilogue_kernel<<<(g.m_total + rows_per_block - 1) / rows_per_block, kMmaThreads, 0,
                          stream>>>(
      static_cast<const float*>(ws), p.splits, g.m_total, g.hh * g.ww, g.cout,
      static_cast<const float*>(bias), static_cast<const float*>(gain),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const bf16*>(x), cin, static_cast<const float*>(bres), residual,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of one call of half a (half_b 0) or b (half_b 1): writes route (0
// f32 on the CUDA cores, 1 fused, 2 split), tile rows, tile channels and K
// splits to out[0..3] (if out is not null); returns the workspace bytes the
// call needs (0 unless split).
extern "C" long long ccdm_resnet_plan(int half_b, int batch, int hh, int ww, int cin, int cout,
                                      int has_res, int is_bf16, int* out) {
  const Plan p = make_plan(half_b, batch, hh, ww, cin, cout, has_res, is_bf16);
  if (out) {
    out[0] = p.route;
    out[1] = p.bm;
    out[2] = p.bn;
    out[3] = p.splits;
  }
  return p.ws_bytes;
}

// The block count that the plan takes for one wave (132 by default). Only the
// CPU emulation of the kernels lowers it, to reach the fused route with a
// few blocks.
extern "C" void ccdm_resnet_set_wave(int blocks) { g_wave = blocks > 0 ? blocks : 1; }

// x [B, H*W, Cin] and w1 [9*Cin, Cout] in the activation type (bf16 if
// is_bf16, else f32); scale, shift [B, Cout], b1, g1 [Cout] f32; h1
// [B, H*W, Cout] in the activation type; ws the f32 workspace of
// ws_bytes >= what ccdm_resnet_plan returns. Launches on `stream` and returns
// the cudaError_t of the launch check.
extern "C" int ccdm_resnet_half_a(const void* x, const void* scale, const void* shift,
                                  const void* w1, const void* b1, const void* g1, void* h1,
                                  void* ws, int batch, int hh, int ww, int cin, int cout,
                                  int is_bf16, long long ws_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return fma_launch_a(x, scale, shift, w1, b1, g1, h1, batch, hh, ww, cin, cout, s);
  const Plan p = make_plan(0, batch, hh, ww, cin, cout, 0, 1);
  if (ws_bytes < p.ws_bytes || (p.ws_bytes && !ws)) return (int)cudaErrorInvalidValue;
  const Geometry g{batch * hh * ww, hh, ww, cout,
                   cin % 8 == 0 && cout % 8 == 0 && aligned16(x) && aligned16(w1) &&
                       aligned16(h1) && aligned16(ws)};
  if (p.route == kRouteFused)
    return p.bm == 128 ? launch_fused_a<128, 64>(x, scale, shift, w1, b1, g1, h1, g, cin, s)
                       : launch_fused_a<64, 128>(x, scale, shift, w1, b1, g1, h1, g, cin, s);
  const Product conv{static_cast<const bf16*>(x), static_cast<const bf16*>(w1), cin, 9};
  return launch_split(conv, conv, p.splits, ws, p, g, b1, g1, scale, shift, nullptr, cin,
                      nullptr, kResNone, h1, s);
}

// h1 [B, H*W, Cout], x [B, H*W, Cin], w2 [9*Cout, Cout], wres [Cin, Cout] (read
// only if has_res) and y [B, H*W, Cout] in the activation type; b2, g2, bres
// [Cout] f32; ws as for ccdm_resnet_half_a. Without has_res, Cin must equal Cout.
extern "C" int ccdm_resnet_half_b(const void* h1, const void* x, const void* w2,
                                  const void* b2, const void* g2, const void* wres,
                                  const void* bres, void* y, void* ws, int batch, int hh,
                                  int ww, int cin, int cout, int has_res, int is_bf16,
                                  long long ws_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_res && cin != cout) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return fma_launch_b(h1, x, w2, b2, g2, wres, bres, y, batch, hh, ww, cin, cout, has_res, s);
  const Plan p = make_plan(1, batch, hh, ww, cin, cout, has_res, 1);
  if (ws_bytes < p.ws_bytes || (p.ws_bytes && !ws)) return (int)cudaErrorInvalidValue;
  const bool vec = cin % 8 == 0 && cout % 8 == 0 && aligned16(h1) && aligned16(w2) &&
                   aligned16(y) && aligned16(ws) && (!has_res || (aligned16(x) && aligned16(wres)));
  const Geometry g{batch * hh * ww, hh, ww, cout, vec};
  if (p.route == kRouteFused)
    return p.bm == 128
               ? launch_fused_b<128, 64>(h1, x, w2, b2, g2, wres, bres, y, g, cin, has_res, s)
               : launch_fused_b<64, 128>(h1, x, w2, b2, g2, wres, bres, y, g, cin, has_res, s);
  const Product conv{static_cast<const bf16*>(h1), static_cast<const bf16*>(w2), cout, 9};
  const Product proj{static_cast<const bf16*>(x), static_cast<const bf16*>(wres), cin, 1};
  return launch_split(conv, proj, p.splits + (has_res ? 1 : 0), ws, p, g, b2, g2, nullptr,
                      nullptr, x, cin, bres, has_res ? kResProj : kResIdentity, y, s);
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

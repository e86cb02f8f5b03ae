// Linear attention for Hopper (sm_90a): kernels #6, #7, #8 and #9.
//
// For q, k, v [B, N, H, D] (token-major: F = H * D channels a token) and each head:
//
//   out = softmax_D(q) D^-1/2 . ctx,   ctx = softmax_N(k)^T v   (D x D)
//
// The q softmax runs over the head's D channels, shifted by the head's own max,
// with the sum guarded by 1e-30; the k softmax runs over the N tokens of each
// channel. The TPU kernels these replace (ccdm_tpu/ops/linear_attention.py)
// packed all heads of a batch row into one [N, F] cell and masked the
// cross-head blocks of an [F, F] context with a block-diagonal ones matrix.
// Here only each head's D x D block is formed (4x fewer products at H 4).
// Entry points:
//   ccdm_la_plan: the route, tiles and splits of #6 and #8 for a shape, and
//     #6's workspace (make_la_plan; a function of the shape alone);
//   ccdm_la_fulllane (#6, _kernel_fulllane). bf16 at D % 16 == 0 takes the
//     tensor-core route ("bf16: tensor cores" below), four launches over
//     splits of N: the column max and sum of exp(k - max) per split; the
//     splits' records merged in order, then the context partials
//     k'^T v on mma.sync, k' = exp(k - max) / sum; the partials summed in
//     order into ctx [B, H, D, D], bf16; the out pass. f32, and bf16 at other
//     D, take the CUDA cores, two launches:
//     1. per (head, batch): the exact column max and sum of exp(k - max) over
//        N (one online sweep), then ctx = k'^T v (a second sweep), written
//        [B, H, D, D] in the operand type;
//     2. per (64 tokens, head, batch): q', then q' . ctx.
//   ccdm_la_ctx_twopass (#7, _kernel_ctx_twopass): given m [B, F] f32 (the
//     column max of k, or any per-column constant: it is used as given), the
//     context partials a = exp(k - m)^T v and s = sum exp(k - m) per split of
//     N, then their sum in order (no atomics) into a [B, H, D, D] and s
//     [B, F], f32. bf16 at D % 16 == 0 takes the tensor route
//     (ccdm_la_twopass_plan: #6's context launch with m given, splits
//     filling a wave, the sum skipped at one split); f32, and bf16 at other
//     D, the CUDA cores, a block per (chunk of tokens, head, batch).
//   ccdm_la_out_twopass (#8, _kernel_out_twopass): #6's out pass on a context
//     the caller finalised (a / s, in the operand type), on #6's route.
//   ccdm_la_per_head (#9, _kernel): #6's function all in f32. bf16 at
//     D % 16 == 0 takes the whole-row f32 route (ccdm_la_per_head_plan: #6's
//     statistics launch, f32 context partials with register-blocked FMAs,
//     their ordered sum, an f32 out pass); f32, and bf16 at other D, one
//     block per (batch, head) sweeping N three times (column max and sum,
//     ctx, out).
// Rounding points on the bf16 path follow each TPU kernel: #6 rounds k', v, ctx
// and q' to bf16 for its products; #7 rounds exp(k - m) and v (s sums the
// unrounded values); #8 rounds q'; #9 rounds only the output. Products
// accumulate in f32. k' needs the exact max and sum over all N before any
// product (an online rescale would move its rounding point), so #6 and #9
// read k twice.
//
// What bounds them on this card: at B 64, N 4096, F 128 in bf16, #6 and #9
// must read q, k, v and write out (268 MB, 80 us at 3.35 TB/s) and do 4 B N F D
// products (4.3 GFLOP: 4.3 us at the bf16 tensor-core rate, 64 us at the f32
// rate #9 needs): bytes. #7 and #8 each move half of that. The tensor and
// whole-row routes stream whole rows (every head of a token, 16 bytes a
// thread) and move 5/4 of #6's and #9's bound (k twice) and #7's once. The
// CUDA-core kernels (f32, and bf16 at D % 16 != 0) run the products as f32
// FMAs from shared memory, a head a block.
//
// D may be any size up to 128: the CUDA-core kernels are instantiated for a
// padded width DP in {16, 32, 64, 128} and hold zeros in the channels past D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;  // tokens per shared-memory tile of a context sweep
constexpr int kTN = 64;  // tokens per block of the out pass

// Shared memory, in floats: a context sweep's kp and v tiles [kTK][DP], the
// column max and sum [DP] each and two [kThreads] reduction buffers; the out
// pass's ctx [DP][DP] and q' [kTN][DP + 1].
template <int DP>
constexpr int ctx_smem_floats() { return 2 * kTK * DP + 2 * DP + 2 * kThreads; }
template <int DP>
constexpr int out_smem_floats() { return DP * DP + kTN * (DP + 1); }

// m_s[c] = max over the n_tok tokens of k[n][c] and s_s[c] = sum_n
// exp(k[n][c] - m_s[c]) for c < d (0 and 1 past d). One sweep: each thread
// keeps a running max and a sum it rescales when the max grows; the
// kThreads / DP partials of a channel are merged in a fixed order.
template <typename T, int DP>
__device__ void col_max_sum(const T* k, size_t ld, int n_tok, int d, float* m_s, float* s_s,
                            float* red_m, float* red_s) {
  constexpr int kRows = kThreads / DP;
  const int c = threadIdx.x % DP;
  float m = -INFINITY, s = 0.f;
  if (c < d) {
    for (int n = threadIdx.x / DP; n < n_tok; n += kRows) {
      const float x = to_f32(k[(size_t)n * ld + c]);
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else {
        s += expf(x - m);
      }
    }
  }
  red_m[threadIdx.x] = m;
  red_s[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < DP) {
    float mm = -INFINITY;
    for (int r = 0; r < kRows; ++r) mm = fmaxf(mm, red_m[r * DP + c]);
    float ss = 0.f;
    for (int r = 0; r < kRows; ++r)
      if (red_s[r * DP + c] > 0.f) ss += red_s[r * DP + c] * expf(red_m[r * DP + c] - mm);
    m_s[c] = c < d ? mm : 0.f;
    s_s[c] = c < d ? ss : 1.f;
  }
  __syncthreads();
}

// The context of one head over tokens [n0, n1): acc[j] += sum_n kp[n][c_j] v[n][e]
// for this thread's outputs (e = threadIdx.x % DP, c_j = threadIdx.x / DP +
// j kThreads / DP), with kp = exp(k - m_s) (divided by s_s if kNorm) and v,
// each rounded to OpT, staged through shared memory kTK tokens at a time.
// Returns this thread's sum of the unrounded exp(k - m_s) over its loads:
// channel e, tile rows threadIdx.x / DP + i kThreads / DP.
template <typename T, typename OpT, int DP, bool kNorm>
__device__ float ctx_sweep(const T* k, const T* v, size_t ld, int n0, int n1, int d,
                           const float* m_s, const float* s_s, float* kp_s, float* v_s,
                           float (&acc)[DP * DP / kThreads]) {
  constexpr int kRows = kThreads / DP;
  constexpr int kP = DP * DP / kThreads;
  const int e = threadIdx.x % DP;
  const int r0 = threadIdx.x / DP;
  float s = 0.f;
  for (int t0 = n0; t0 < n1; t0 += kTK) {
    const int rows = min(kTK, n1 - t0);
    for (int r = r0; r < kTK; r += kRows) {
      float kp = 0.f, vv = 0.f;
      if (r < rows && e < d) {
        const size_t off = (size_t)(t0 + r) * ld + e;
        const float x = expf(to_f32(k[off]) - m_s[e]);
        s += x;
        kp = as_operand<OpT>(kNorm ? x / s_s[e] : x);
        vv = as_operand<OpT>(to_f32(v[off]));
      }
      kp_s[r * DP + e] = kp;
      v_s[r * DP + e] = vv;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float vr = v_s[r * DP + e];
      const float* kr = kp_s + r * DP + r0;
#pragma unroll
      for (int j = 0; j < kP; ++j) acc[j] = fmaf(kr[j * kRows], vr, acc[j]);
    }
    __syncthreads();
  }
  return s;
}

// Write this thread's context outputs (see ctx_sweep) to out [d][d].
template <typename U, int DP>
__device__ void store_ctx(const float (&acc)[DP * DP / kThreads], U* out, int d) {
  constexpr int kRows = kThreads / DP;
  const int e = threadIdx.x % DP;
  const int r0 = threadIdx.x / DP;
#pragma unroll
  for (int j = 0; j < DP * DP / kThreads; ++j) {
    const int c = r0 + j * kRows;
    if (c < d && e < d) out[c * d + e] = from_f32<U>(acc[j]);
  }
}

// out[n][e] = sum_c q'[n][c] ctx_s[c][e] for the tokens [n0, n0 + kTN) of one
// head: q' is the softmax of the head's d channels of q (shifted by their own
// max, the sum guarded by 1e-30) times d^-1/2, rounded to OpT. ctx_s [DP][DP]
// f32 holds zeros past d.
template <typename T, typename OpT, int DP>
__device__ void out_tile(const T* q, T* out, size_t ld, int n0, int n_tok, int d,
                         const float* ctx_s, float* q_s) {
  constexpr int kQS = DP + 1;  // padded row of q'
  constexpr int kPer = (DP + 31) / 32;
  constexpr int kRows = kThreads / DP;
  constexpr int kPO = kTN * DP / kThreads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)d);
  for (int i = warp; i < kTN; i += kWarps) {  // one warp per token
    const int n = n0 + i;
    float x[kPer];
    if (n < n_tok) {  // uniform across the warp
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int c = lane + 32 * p;
        x[p] = c < d ? to_f32(q[(size_t)n * ld + c]) : -INFINITY;
        mx = fmaxf(mx, x[p]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        x[p] = lane + 32 * p < d ? expf(x[p] - mx) : 0.f;
        sum += x[p];
      }
      sum = fmaxf(warp_sum(sum), 1e-30f);
#pragma unroll
      for (int p = 0; p < kPer; ++p) x[p] = x[p] / sum * scale;
    } else {
#pragma unroll
      for (int p = 0; p < kPer; ++p) x[p] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = lane + 32 * p;
      if (c < DP) q_s[i * kQS + c] = as_operand<OpT>(x[p]);
    }
  }
  __syncthreads();
  const int e = threadIdx.x % DP;
  const int r0 = threadIdx.x / DP;
  float acc[kPO] = {};
  for (int c = 0; c < d; ++c) {
    const float cv = ctx_s[c * DP + e];
    const float* qc = q_s + r0 * kQS + c;
#pragma unroll
    for (int j = 0; j < kPO; ++j) acc[j] = fmaf(qc[j * kRows * kQS], cv, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kPO; ++j) {
    const int n = n0 + r0 + j * kRows;
    if (n < n_tok && e < d) out[(size_t)n * ld + e] = from_f32<T>(acc[j]);
  }
  __syncthreads();  // q_s is written again by the next tile
}

// #6 launch 1: ctx [B, H, d, d] in T, per (head, batch).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fulllane_ctx_kernel(const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ ctx,
                    int n_tok, int heads, int d) {
  extern __shared__ __align__(16) float smem[];
  float* kp_s = smem;
  float* v_s = kp_s + kTK * DP;
  float* m_s = v_s + kTK * DP;
  float* s_s = m_s + DP;
  float* red_m = s_s + DP;
  float* red_s = red_m + kThreads;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t ld = (size_t)heads * d;
  const size_t base = (size_t)b * n_tok * ld + (size_t)h * d;
  col_max_sum<T, DP>(k + base, ld, n_tok, d, m_s, s_s, red_m, red_s);
  float acc[DP * DP / kThreads] = {};
  ctx_sweep<T, T, DP, true>(k + base, v + base, ld, 0, n_tok, d, m_s, s_s, kp_s, v_s, acc);
  store_ctx<T, DP>(acc, ctx + ((size_t)b * heads + h) * d * d, d);
}

// #6 launch 2 and #8: out per (kTN tokens, head, batch) from ctx [B, H, d, d] in T.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
out_kernel(const T* __restrict__ q, const T* __restrict__ ctx, T* __restrict__ out,
           int n_tok, int heads, int d) {
  extern __shared__ __align__(16) float smem[];
  float* ctx_s = smem;
  float* q_s = ctx_s + DP * DP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* cb = ctx + ((size_t)b * heads + h) * d * d;
  for (int i = threadIdx.x; i < DP * DP; i += kThreads) {
    const int c = i / DP;
    const int e = i % DP;
    ctx_s[i] = (c < d && e < d) ? to_f32(cb[c * d + e]) : 0.f;
  }
  __syncthreads();
  const size_t ld = (size_t)heads * d;
  const size_t base = (size_t)b * n_tok * ld + (size_t)h * d;
  out_tile<T, T, DP>(q + base, out + base, ld, blockIdx.x * kTN, n_tok, d, ctx_s, q_s);
}

// #9: everything of one (batch, head) in one block, in f32.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
per_head_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int n_tok, int heads, int d) {
  extern __shared__ __align__(16) float smem[];
  float* kp_s = smem;
  float* v_s = kp_s + kTK * DP;
  float* m_s = v_s + kTK * DP;
  float* s_s = m_s + DP;
  float* red_m = s_s + DP;
  float* red_s = red_m + kThreads;
  float* ctx_s = red_s + kThreads;
  float* q_s = ctx_s + DP * DP;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const size_t ld = (size_t)heads * d;
  const size_t base = (size_t)b * n_tok * ld + (size_t)h * d;
  col_max_sum<T, DP>(k + base, ld, n_tok, d, m_s, s_s, red_m, red_s);
  float acc[DP * DP / kThreads] = {};
  ctx_sweep<T, float, DP, true>(k + base, v + base, ld, 0, n_tok, d, m_s, s_s, kp_s, v_s, acc);
  store_ctx<float, DP>(acc, ctx_s, DP);  // zeros past d: kp and v are zero there
  __syncthreads();
  for (int n0 = 0; n0 < n_tok; n0 += kTN)
    out_tile<T, float, DP>(q + base, out + base, ld, n0, n_tok, d, ctx_s, q_s);
}

// #7 on the CUDA cores, launch 1: per (chunk, head, batch), the partial a
// [d][d] and s [d] of the chunk's tokens, into a_part [B, NC, H, d, d] and
// s_part [B, NC, F].
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
ctx_part_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ m,
                float* __restrict__ a_part, float* __restrict__ s_part, int n_tok, int heads,
                int d, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* kp_s = smem;
  float* v_s = kp_s + kTK * DP;
  float* m_s = v_s + kTK * DP;
  float* red_s = m_s + 2 * DP;
  constexpr int kRows = kThreads / DP;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int f = heads * d;
  for (int i = threadIdx.x; i < DP; i += kThreads)
    m_s[i] = i < d ? m[(size_t)b * f + h * d + i] : 0.f;
  __syncthreads();
  const size_t ld = (size_t)f;
  const size_t base = (size_t)b * n_tok * ld + (size_t)h * d;
  const int n0 = j * chunk;
  const int n1 = min(n_tok, n0 + chunk);
  float acc[DP * DP / kThreads] = {};
  red_s[threadIdx.x] = ctx_sweep<T, T, DP, false>(k + base, v + base, ld, n0, n1, d, m_s,
                                                  nullptr, kp_s, v_s, acc);
  const size_t cell = (size_t)b * nc + j;
  store_ctx<float, DP>(acc, a_part + (cell * heads + h) * d * d, d);
  __syncthreads();
  if (threadIdx.x < d) {
    float ss = 0.f;
    for (int r = 0; r < kRows; ++r) ss += red_s[r * DP + threadIdx.x];
    s_part[cell * f + h * d + threadIdx.x] = ss;
  }
}

// The last launch of #7 (both routes) and the third of #6 and #9: the
// partials a_part [B][nc][per_a] and s_part [B][nc][f] (f 0: none, as for
// #6 and #9) summed over the nc splits in their order into a [B][per_a]
// (rounded to U) and s [B][f], an element a thread.
template <typename U>
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ a_part, const float* __restrict__ s_part,
                  U* __restrict__ a, float* __restrict__ s, int batch, int nc, int per_a, int f) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long na = (long long)batch * per_a;
  if (i < na) {
    const long long b = i / per_a;
    const long long r = i % per_a;
    float sum = 0.f;
    for (int j = 0; j < nc; ++j) sum += a_part[(b * nc + j) * per_a + r];
    a[i] = from_f32<U>(sum);
  } else if (i < na + (long long)batch * f) {
    const long long i2 = i - na;
    const long long b = i2 / f;
    const long long c = i2 % f;
    float sum = 0.f;
    for (int j = 0; j < nc; ++j) sum += s_part[(b * nc + j) * f + c];
    s[i2] = sum;
  }
}

// ------------------------------------------------- bf16: tensor cores
// #6, #7 and #8 in bf16 at D % 16 == 0 (the plans' "tensor" route), and
// #9's whole-row f32 route beside them. A block takes whole token rows of a
// group of heads: every head at H D <= kGroupW (all the shapes of the
// checks and of the UNet's levels), else kGroupW / D heads a group. Rows
// are copied 16 bytes a thread, the bf16 products run on mma.sync m16n8k16
// from ldmatrix, and every sum across blocks is a record merged in a fixed
// order: no atomics, the same bits on every run.

typedef __nv_bfloat16 bf16;

constexpr int kCardSMs = 132;       // the SMs of an H100 SXM
constexpr int kGroupW = 128;        // the most channels of a block's group of heads
constexpr int kLG = kGroupW + 8;    // bf16 per row of a [tokens][group] tile (272 bytes)
constexpr int kCT = 64;             // tokens per tile of the statistics and context launches
constexpr int kOT = 16;             // rows of a warp's tile in the out pass
constexpr int kOB = kWarps * kOT;   // tokens per step of an out-pass block
constexpr int kStages = 3;          // tiles of the statistics and context launches' rings
constexpr int kStatBlocks = 3;      // statistics blocks an SM (its shared memory fits 3)

// Blocks an SM the context and out launches are bounded for (their
// registers grow with D), which sizes the plan's wave.
__host__ __device__ constexpr int tc_blocks_per_sm(int d) { return d > 64 ? 1 : 2; }

// The heads [h0, h0 + heads) of group g and their channels [c0, c0 + wc).
struct HeadGroup {
  int heads, c0, wc;
  __host__ __device__ static int per_group(int d) { return d < kGroupW ? kGroupW / d : 1; }
  __device__ HeadGroup(int g, int heads_total, int d) {
    const int h0 = g * per_group(d);
    heads = min(per_group(d), heads_total - h0);
    c0 = h0 * d;
    wc = heads * d;
  }
};

// The tiles [t0, t1) of split z of `tiles`: at least one each when splits <= tiles.
struct Span {
  int t0, t1;
  __device__ Span(int z, int splits, int tiles)
      : t0((int)((long long)z * tiles / splits)), t1((int)((long long)(z + 1) * tiles / splits)) {}
};

// Sixteen bytes from shared memory src to device memory dst (vec), or eight stores.
__device__ __forceinline__ void store16(bf16* dst, const bf16* src, int vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = src[e];
  }
}

// The running max m and sum s = sum exp(x - m) of one channel, taking the
// values x (-inf for none): one rescale for all of them, no branch on the data.
template <int U>
__device__ __forceinline__ void online(float& m, float& s, const float (&x)[U]) {
  float mx = m;
#pragma unroll
  for (int u = 0; u < U; ++u) mx = fmaxf(mx, x[u]);
  if (mx == -INFINITY) return;
  float sum = s * __expf(m - mx);
#pragma unroll
  for (int u = 0; u < U; ++u) sum += __expf(x[u] - mx);
  m = mx;
  s = sum;
}

// Tile `tile` of a batch row (T rows of a group's wc channels, row stride f,
// from src) into dst [T][kLG], rows past N zeros; all the block's threads
// take part, the caller commits.
template <int T = kCT>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int tile, int n_tok, int f,
                                          int wc, int vec) {
  copy_rows(dst, kLG, src + (size_t)tile * T * f, f, T, min(T, n_tok - tile * T), wc, vec,
            threadIdx.x, kThreads);
}

// acc += the warp's 16 rows d0 of k'^T v over the kCT tokens of a tile in
// shared memory, k' at kc and v at vc ([token][channel], row stride kLG):
// A = k'^T through ldmatrix .trans, B = v through ldmatrix .trans, the D
// columns e0 of its head, D / 8 accumulator tiles.
template <int D>
__device__ __forceinline__ void ctx_tile_mma(float (&acc)[D / 8][4], const bf16* kc,
                                             const bf16* vc, int d0, int e0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kCT; kk += 16) {
    uint32_t a[4];
    a_km(a, kc + kk * kLG + d0, kLG, lane);
#pragma unroll
    for (int nj = 0; nj < D / 16; ++nj) {
      uint32_t bq[4];
      b_kn16(bq, vc + kk * kLG + e0 + nj * 16, kLG, lane);
      const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
      mma_16816(acc[2 * nj], a, b0);
      mma_16816(acc[2 * nj + 1], a, b1);
    }
  }
}

// #6 launch 1: block (z, g, b) walks the kCT-token tiles of split z of batch
// row b in group g's channels through a ring of kStages tiles (cp.async,
// kStages - 1 tiles ahead), each thread folding 8 channels of every
// rows-th row of a tile (at most kCT / 16 rows: a row has at most 16
// chunks) into its running max and sum (online), and writes the column max
// and sum of exp(k - max) of those tokens to rec_m and rec_s [B][splits][F]
// (f32); the threads' partials of a channel are merged in their order.
__global__ void __launch_bounds__(kThreads, kStatBlocks)
la_stats_kernel(const bf16* __restrict__ k, float* __restrict__ rec_m, float* __restrict__ rec_s,
                int n_tok, int heads, int d, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kStages][kCT][kLG]
  float* red_m = reinterpret_cast<float*>(k_s + kStages * kCT * kLG);  // [kThreads][8]
  float* red_s = red_m + kThreads * 8;
  const HeadGroup gr(blockIdx.y, heads, d);
  const int b = blockIdx.z, f = heads * d;
  const int cpr = gr.wc / 8, rows = kThreads / cpr;  // chunks a row, rows a pass
  const int r0 = threadIdx.x / cpr, ch = threadIdx.x % cpr;
  const Span sp(blockIdx.x, splits, (n_tok + kCT - 1) / kCT);
  const bf16* kb = k + (size_t)b * n_tok * f + gr.c0;
  // tile `tile` into its slot of the ring as one commit group (an empty one past t1)
  auto prefetch = [&](int tile) {
    if (tile < sp.t1)
      copy_tile(k_s + (tile - sp.t0) % kStages * kCT * kLG, kb, tile, n_tok, f, gr.wc, vec);
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) prefetch(sp.t0 + i);
  float m[8], s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = -INFINITY;
    s[j] = 0.f;
  }
  for (int tile = sp.t0; tile < sp.t1; ++tile) {
    prefetch(tile + kStages - 1);
    cp_async_wait<kStages - 1>();  // this tile has landed
    __syncthreads();
    const bf16* cur = k_s + (tile - sp.t0) % kStages * kCT * kLG;
    const int valid = r0 < rows ? min(kCT, n_tok - tile * kCT) : 0;
    constexpr int U = kCT / 16;
    float x[8][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * rows;
      float row[8];
      if (r < valid) {
        unpack8(*reinterpret_cast<const uint4*>(cur + r * kLG + ch * 8), row);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j][u] = row[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) online(m[j], s[j], x[j]);
    __syncthreads();  // every thread is done with this slot before it loads again
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red_m[threadIdx.x * 8 + j] = m[j];
    red_s[threadIdx.x * 8 + j] = s[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < gr.wc; c += kThreads) {  // channel c: thread r cpr + c / 8
    float mm = -INFINITY, ss = 0.f;
    for (int r = 0; r < rows; ++r) mm = fmaxf(mm, red_m[r * cpr * 8 + c]);
    for (int r = 0; r < rows; ++r) {
      const float mr = red_m[r * cpr * 8 + c];
      if (mr != -INFINITY) ss = fmaf(red_s[r * cpr * 8 + c], __expf(mr - mm), ss);
    }
    const size_t i = ((size_t)b * splits + blockIdx.x) * f + gr.c0 + c;
    rec_m[i] = mm;
    rec_s[i] = ss;
  }
}

// The exact column max and the reciprocal of the sum of exp(k - max) of
// batch row b's channels [c0, c0 + wc), merged from its `splits` records in
// their order, to m_s and inv_s (every block of the row merges the same
// records the same way).
__device__ void merge_stats(const float* __restrict__ rec_m, const float* __restrict__ rec_s,
                            int b, int splits, int f, int c0, int wc, float* m_s,
                            float* inv_s) {
  for (int c = threadIdx.x; c < wc; c += kThreads) {
    const float* rm = rec_m + (size_t)b * splits * f + c0 + c;
    const float* rs = rec_s + (size_t)b * splits * f + c0 + c;
    float mm = -INFINITY, ss = 0.f;
    for (int r = 0; r < splits; ++r) mm = fmaxf(mm, rm[(size_t)r * f]);
    for (int r = 0; r < splits; ++r) {
      const float mr = rm[(size_t)r * f];
      if (mr != -INFINITY) ss = fmaf(rs[(size_t)r * f], __expf(mr - mm), ss);
    }
    m_s[c] = mm;
    inv_s[c] = 1.f / ss;
  }
}

// #6 launch 2: block (z, g, b) merges row b's stat_splits records, then
// walks the kCT-token tiles of split z through a ring of kStages tiles of k
// and v (cp.async, kStages - 1 tiles ahead): k' = bf16(exp(k - m) / s) in
// place (zeros past N; / s as a product with 1 / s), then each warp w <
// wc / 16 adds to its 16 rows d (channels 16 w of the group, within head
// 16 w / D) of k'^T v over the tile's tokens: A = k'^T through ldmatrix
// .trans, B = v [token][channel] through ldmatrix .trans, D / 8
// accumulator tiles. The warp's partial [16][D] goes to parts
// [B][splits][F][D] (f32), or with one split to ctx [B][F][D] in bf16.
template <int D>
__global__ void __launch_bounds__(kThreads, tc_blocks_per_sm(D))
la_ctx_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ rec_m, const float* __restrict__ rec_s,
              float* __restrict__ parts, bf16* __restrict__ ctx, int n_tok, int heads,
              int stat_splits, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kStages][kCT][kLG]
  bf16* v_s = k_s + kStages * kCT * kLG;       // [kStages][kCT][kLG]
  float* m_s = reinterpret_cast<float*>(v_s + kStages * kCT * kLG);
  float* inv_s = m_s + kGroupW;
  const HeadGroup gr(blockIdx.y, heads, D);
  const int b = blockIdx.z, f = heads * D, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cpr = gr.wc / 8;
  const Span sp(blockIdx.x, splits, (n_tok + kCT - 1) / kCT);
  const bf16* kb = k + (size_t)b * n_tok * f + gr.c0;
  const bf16* vb = v + (size_t)b * n_tok * f + gr.c0;
  // tile `tile` into its slots of the rings as one commit group (an empty one past t1)
  auto prefetch = [&](int tile) {
    if (tile < sp.t1) {
      const int slot = (tile - sp.t0) % kStages * kCT * kLG;
      copy_tile(k_s + slot, kb, tile, n_tok, f, gr.wc, vec);
      copy_tile(v_s + slot, vb, tile, n_tok, f, gr.wc, vec);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) prefetch(sp.t0 + i);
  merge_stats(rec_m, rec_s, b, stat_splits, f, gr.c0, gr.wc, m_s, inv_s);
  const bool mine = w < gr.wc / 16;
  const int d0 = w * 16, e0 = (d0 / D) * D;  // the warp's rows of k'^T; its head's v columns
  float acc[D / 8][4] = {};
  for (int tile = sp.t0; tile < sp.t1; ++tile) {
    bf16* kc = k_s + (tile - sp.t0) % kStages * kCT * kLG;
    const bf16* vc = v_s + (tile - sp.t0) % kStages * kCT * kLG;
    prefetch(tile + kStages - 1);
    cp_async_wait<kStages - 1>();  // this tile has landed
    __syncthreads();               // (and m_s, inv_s are written)
    const int valid = min(kCT, n_tok - tile * kCT);
    for (int i = threadIdx.x; i < kCT * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 8;
      uint4* p = reinterpret_cast<uint4*>(kc + r * kLG + c);
      uint4 o{0u, 0u, 0u, 0u};
      if (r < valid) {
        float x[8];
        unpack8(*p, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = __expf(x[e] - m_s[c + e]) * inv_s[c + e];
        o = uint4{pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                  pack_bf16(x[6], x[7])};
      }
      *p = o;
    }
    __syncthreads();
    if (mine) ctx_tile_mma<D>(acc, kc, vc, d0, e0, lane);
    __syncthreads();  // every warp is done with this slot before it loads again
  }
  cp_async_wait<0>();
  if (mine) {
    const int g = lane >> 2, t = lane & 3;
    const size_t row0 = ((size_t)b * splits + blockIdx.x) * f + gr.c0 + d0;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t at = (row0 + g + 8 * hh) * D + nt * 8 + 2 * t;
        if (splits == 1)
          *reinterpret_cast<uint32_t*>(ctx + at) = pack_bf16(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
        else
          *reinterpret_cast<float2*>(parts + at) = float2{acc[nt][2 * hh], acc[nt][2 * hh + 1]};
      }
  }
}

// In place, for the warp's 16 rows of one head (A fragments of KS k16
// steps: registers 0 and 2 row g, 1 and 3 row g + 8): q' = bf16(softmax(q)
// * scale), shifted by the row's own max over the head, the sum guarded by
// 1e-30; each row's D values lie in the four lanes of its quad.
template <int KS>
__device__ __forceinline__ void q_softmax(uint32_t (&a)[KS][4], float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x[KS][4];
    float mx = -INFINITY;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      x[ks][0] = __uint_as_float(a[ks][hh] << 16);
      x[ks][1] = __uint_as_float(a[ks][hh] & 0xffff0000u);
      x[ks][2] = __uint_as_float(a[ks][hh + 2] << 16);
      x[ks][3] = __uint_as_float(a[ks][hh + 2] & 0xffff0000u);
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, x[ks][e]);
    }
    mx = quad_max(mx);
    float s = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[ks][e] = __expf(x[ks][e] - mx);
        s += x[ks][e];
      }
    const float f = scale / fmaxf(quad_sum(s), 1e-30f);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][hh] = pack_bf16(x[ks][0] * f, x[ks][1] * f);
      a[ks][hh + 2] = pack_bf16(x[ks][2] * f, x[ks][3] * f);
    }
  }
}

// #6 launch 4 and #8: block (z, g, b) holds group g's ctx [wc][D] (bf16,
// row stride D + 8) and walks the kOB-token steps of split z of batch row
// b; warp w takes rows 16 w of each step, with no block barrier: its q
// rows load (cp.async, two buffers a warp) while it works on the last;
// per head, q' in registers (q_softmax on the A fragments), out = q' ctx_h
// (B through ldmatrix .trans), rounded to bf16 into the head's columns of
// the warp's q rows, then the rows stored 16 bytes a lane.
template <int D>
__global__ void __launch_bounds__(kThreads, tc_blocks_per_sm(D))
la_out_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ctx, bf16* __restrict__ out,
                 int n_tok, int heads, int splits, int vec) {
  constexpr int LC = D + 8;
  extern __shared__ __align__(16) float smem[];
  bf16* ctx_s = reinterpret_cast<bf16*>(smem);  // [kGroupW][LC]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  bf16* q_w = ctx_s + kGroupW * LC + w * 2 * kOT * kLG;  // the warp's [2][kOT][kLG]
  const HeadGroup gr(blockIdx.y, heads, D);
  const int b = blockIdx.z, f = heads * D, cpr = gr.wc / 8;
  copy_rows(ctx_s, LC, ctx + ((size_t)b * f + gr.c0) * D, D, gr.wc, gr.wc, D, vec, threadIdx.x,
            kThreads);
  cp_async_commit();
  const Span sp(blockIdx.x, splits, (n_tok + kOB - 1) / kOB);
  const bf16* qb = q + (size_t)b * n_tok * f + gr.c0;
  bf16* ob = out + (size_t)b * n_tok * f + gr.c0;
  // the warp's rows of step `step` into buffer `buf` as one commit group
  auto prefetch = [&](int step, int buf) {
    const int n0 = step * kOB + w * kOT;
    if (step < sp.t1 && n0 < n_tok)
      copy_rows(q_w + buf * kOT * kLG, kLG, qb + (size_t)n0 * f, f, kOT, min(kOT, n_tok - n0),
                gr.wc, vec, lane, 32);
    cp_async_commit();
  };
  prefetch(sp.t0, 0);
  cp_async_wait<1>();  // ctx has landed
  __syncthreads();
  const float scale = rsqrtf((float)D);
  for (int step = sp.t0; step < sp.t1; ++step) {
    const int buf = (step - sp.t0) & 1, n0 = step * kOB + w * kOT;
    bf16* cur = q_w + buf * kOT * kLG;
    prefetch(step + 1, buf ^ 1);
    cp_async_wait<1>();
    __syncwarp();
    if (n0 >= n_tok) continue;  // uniform across the warp
    for (int h = 0; h < gr.heads; ++h) {
      uint32_t a[D / 16][4];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) a_mk(a[ks], cur + h * D + ks * 16, kLG, lane);
      q_softmax<D / 16>(a, scale);
      float o[D / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int nj = 0; nj < D / 16; ++nj) {
          uint32_t bq[4];
          b_kn16(bq, ctx_s + (h * D + ks * 16) * LC + nj * 16, LC, lane);
          const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
          mma_16816(o[2 * nj], a[ks], b0);
          mma_16816(o[2 * nj + 1], a[ks], b1);
        }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(cur + (g + 8 * hh) * kLG + h * D + nt * 8 + 2 * t) =
              pack_bf16(o[nt][2 * hh], o[nt][2 * hh + 1]);
    }
    __syncwarp();
    const int valid = min(kOT, n_tok - n0);
    for (int i = lane; i < kOT * cpr; i += 32) {
      const int r = i / cpr, c = (i % cpr) * 8;
      if (r < valid) store16(ob + (size_t)(n0 + r) * f + c, cur + r * kLG + c, vec);
    }
    __syncwarp();  // the rows are stored before the buffer loads again
  }
  cp_async_wait<0>();
}

// #7 on the tensor route: la_ctx_kernel's walk with the caller's m [B][F]
// (used as given) in place of merged statistics, and no division: k' =
// bf16(exp(k - m)) in place, then the warps' k'^T v on mma.sync. Each
// thread converts one chunk of 8 channels (ch) in rows r0, r0 + rows, ...
// of every tile (threads past rows x cpr idle there, as at F 96), so it
// holds those channels' m in registers and sums their unrounded exp(k - m)
// before the rounding; at the end the threads' sums of a channel are
// merged in their order. Split z's a [F][D] and s [F] of batch row b go to
// a_out [B][splits][F][D] and s_out [B][splits][F] (f32; with one split,
// a and s themselves).
template <int D>
__global__ void __launch_bounds__(kThreads, tc_blocks_per_sm(D))
la_ctx_given_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ m, float* __restrict__ a_out,
                    float* __restrict__ s_out, int n_tok, int heads, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kStages][kCT][kLG]
  bf16* v_s = k_s + kStages * kCT * kLG;       // [kStages][kCT][kLG]
  const HeadGroup gr(blockIdx.y, heads, D);
  const int b = blockIdx.z, f = heads * D, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cpr = gr.wc / 8, rows = kThreads / cpr;  // chunks a row, rows a pass
  const int r0 = threadIdx.x / cpr, ch = threadIdx.x % cpr;
  const Span sp(blockIdx.x, splits, (n_tok + kCT - 1) / kCT);
  const bf16* kb = k + (size_t)b * n_tok * f + gr.c0;
  const bf16* vb = v + (size_t)b * n_tok * f + gr.c0;
  // tile `tile` into its slots of the rings as one commit group (an empty one past t1)
  auto prefetch = [&](int tile) {
    if (tile < sp.t1) {
      const int slot = (tile - sp.t0) % kStages * kCT * kLG;
      copy_tile(k_s + slot, kb, tile, n_tok, f, gr.wc, vec);
      copy_tile(v_s + slot, vb, tile, n_tok, f, gr.wc, vec);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) prefetch(sp.t0 + i);
  float mc[8], sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mc[e] = r0 < rows ? m[(size_t)b * f + gr.c0 + ch * 8 + e] : 0.f;
    sc[e] = 0.f;
  }
  const bool mine = w < gr.wc / 16;
  const int d0 = w * 16, e0 = (d0 / D) * D;  // the warp's rows of k'^T; its head's v columns
  float acc[D / 8][4] = {};
  for (int tile = sp.t0; tile < sp.t1; ++tile) {
    bf16* kc = k_s + (tile - sp.t0) % kStages * kCT * kLG;
    const bf16* vc = v_s + (tile - sp.t0) % kStages * kCT * kLG;
    prefetch(tile + kStages - 1);
    cp_async_wait<kStages - 1>();  // this tile has landed
    __syncthreads();
    const int valid = min(kCT, n_tok - tile * kCT);
    if (r0 < rows) {
      for (int r = r0; r < kCT; r += rows) {
        uint4* p = reinterpret_cast<uint4*>(kc + r * kLG + ch * 8);
        uint4 o{0u, 0u, 0u, 0u};
        if (r < valid) {
          float x[8];
          unpack8(*p, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            x[e] = __expf(x[e] - mc[e]);
            sc[e] += x[e];  // before the rounding
          }
          o = uint4{pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                    pack_bf16(x[6], x[7])};
        }
        *p = o;
      }
    }
    __syncthreads();
    if (mine) ctx_tile_mma<D>(acc, kc, vc, d0, e0, lane);
    __syncthreads();  // every warp is done with this slot before it loads again
  }
  cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(k_s);  // [kThreads][8], where the ring was
  if (r0 < rows) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = sc[e];
  }
  __syncthreads();
  const size_t rec = ((size_t)b * splits + blockIdx.x) * f + gr.c0;
  for (int c = threadIdx.x; c < gr.wc; c += kThreads) {  // channel c: thread r cpr + c / 8
    float ss = 0.f;
    for (int r = 0; r < rows; ++r) ss += red[r * cpr * 8 + c];
    s_out[rec + c] = ss;
  }
  if (mine) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(a_out + (rec + d0 + g + 8 * hh) * D + nt * 8 + 2 * t) =
            float2{acc[nt][2 * hh], acc[nt][2 * hh + 1]};
  }
}

// ------------------------------------------------ #9: whole rows in f32
// #9 computes in f32 and rounds only its output, so its products stay on
// the CUDA cores (TF32 would break its f32 checks, bf16 mma.sync would move
// its rounding points). Its launches take whole rows of a group of heads
// as the tensor route does; each thread keeps a register block of outputs
// and loads one segment of each operand a step, instead of one shared
// load an FMA.

constexpr int kFT = 32;      // tokens per tile of #9's context launch
constexpr int kFStages = 3;  // tiles of its rings
constexpr int kFO = 64;      // tokens per step of #9's out pass
constexpr int kFN = 8;       // tokens of an out-pass thread's block

// Four consecutive floats from shared memory (p 16-byte aligned) to r[0..3].
__device__ __forceinline__ void lds4(float* r, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x;
  r[1] = t.y;
  r[2] = t.z;
  r[3] = t.w;
}

// Shared memory (bytes) of #9's context and out launches, and the blocks an
// SM each is bounded for: two where two fit in the SM's 228 KB (1 KB of
// it reserved a block).
constexpr int kRowsCtxSmem = 2 * kFStages * kFT * kLG * 2 + kFT * kGroupW * 4 + 2 * kGroupW * 4;
__host__ __device__ constexpr int rows_out_smem(int d) {
  return kGroupW * d * 4 + kGroupW * kFO * 4 + kGroupW / 16 * kFO * 4 + 2 * kFO * kLG * 2;
}
__host__ __device__ constexpr int blocks_fitting(int smem) {
  return 2 * (smem + 1024) <= 228 * 1024 ? 2 : 1;
}
__host__ __device__ constexpr int rows_out_blocks(int d) { return blocks_fitting(rows_out_smem(d)); }

// #9's context launch gives each thread an 8 x 8 block of one head's k'^T
// v: k' rows ct 4 .. + 4 and D / 2 + ct 4 .. + 4 (so that the 16-byte
// loads of a quarter warp lie side by side), v columns et 8 .. + 8; per
// token two 16-byte loads of f32 k' and one of bf16 v for 64 FMAs. A full
// group has rows_blocks(D) such blocks; rows_token_groups(D) groups of
// threads (the most that 256 threads hold, a power of two) each take every
// G-th token of a tile, and their blocks are summed in order at the end.
__host__ __device__ constexpr int rows_blocks(int d) {
  return (d < kGroupW ? kGroupW / d : 1) * (d / 8) * (d / 8);
}
__host__ __device__ constexpr int rows_token_groups(int d) {
  return kThreads / rows_blocks(d) >= 8 ? 8 : kThreads / rows_blocks(d) >= 4 ? 4
         : kThreads / rows_blocks(d) >= 2 ? 2 : 1;
}

// #9 launch 2: block (z, g, b) merges row b's stat_splits records, then
// walks the kFT-token tiles of split z through rings of kFStages tiles of
// k and v (cp.async). Each thread converts one chunk of 8 channels (ch) in
// rows r0, r0 + rows, ... of a tile, with those channels' m and 1 / s in
// registers: k' = exp(k - m) / s (a product with 1 / s) into f32 [kFT]
// [kGroupW], never rounded. Thread (tg, h, ct, et) adds, for the tokens
// tg, tg + G, ... of the tile, the outer product of its k' segment and its
// v segment (bf16, exact in f32, read from the ring) to its 8 x 8 block of
// head h's k'^T v in registers. At the end the token groups' blocks meet
// in shared memory and are summed in their order into parts
// [B][splits][F][D] (f32; with one split, ctx [B][F][D] itself).
template <int D>
__global__ void __launch_bounds__(kThreads, blocks_fitting(kRowsCtxSmem))
la_ctx_rows_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ rec_m, const float* __restrict__ rec_s,
                   float* __restrict__ parts, int n_tok, int heads, int stat_splits, int splits,
                   int vec) {
  constexpr int NB = rows_blocks(D), G = rows_token_groups(D), HD = D / 2;
  static_assert(G == 1 || G * (NB * 64 / D) * D * 4 <= kRowsCtxSmem,
                "the token groups' blocks fit where the rings were");
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);                           // [kFStages][kFT][kLG]
  bf16* v_s = k_s + kFStages * kFT * kLG;                              // [kFStages][kFT][kLG]
  float* kp_f = reinterpret_cast<float*>(v_s + kFStages * kFT * kLG);  // [kFT][kGroupW]
  float* m_s = kp_f + kFT * kGroupW;
  float* inv_s = m_s + kGroupW;
  const HeadGroup gr(blockIdx.y, heads, D);
  const int b = blockIdx.z, f = heads * D;
  const int cpr = gr.wc / 8, rows = kThreads / cpr;  // chunks a row, rows a pass
  const int cr0 = threadIdx.x / cpr, ch = threadIdx.x % cpr;
  const Span sp(blockIdx.x, splits, (n_tok + kFT - 1) / kFT);
  const bf16* kb = k + (size_t)b * n_tok * f + gr.c0;
  const bf16* vb = v + (size_t)b * n_tok * f + gr.c0;
  auto prefetch = [&](int tile) {
    if (tile < sp.t1) {
      const int slot = (tile - sp.t0) % kFStages * kFT * kLG;
      copy_tile<kFT>(k_s + slot, kb, tile, n_tok, f, gr.wc, vec);
      copy_tile<kFT>(v_s + slot, vb, tile, n_tok, f, gr.wc, vec);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kFStages - 1; ++i) prefetch(sp.t0 + i);
  merge_stats(rec_m, rec_s, b, stat_splits, f, gr.c0, gr.wc, m_s, inv_s);
  __syncthreads();
  float mc[8], ic[8];
  if (cr0 < rows) {
    lds4(mc, m_s + ch * 8);
    lds4(mc + 4, m_s + ch * 8 + 4);
    lds4(ic, inv_s + ch * 8);
    lds4(ic + 4, inv_s + ch * 8 + 4);
  }
  // et fastest, then ct, then h, then the token group tg
  const int blk = threadIdx.x % NB, tg = threadIdx.x / NB;
  const int et = blk % (D / 8), ct = blk / (D / 8) % (D / 8), h = blk / (D / 8 * (D / 8));
  const bool mine = tg < G && h < gr.heads;
  const int r0 = h * D + ct * 4, c0 = h * D + et * 8;  // first rows of k'^T, first v column
  float acc[8][8] = {};
  for (int tile = sp.t0; tile < sp.t1; ++tile) {
    const bf16* kc = k_s + (tile - sp.t0) % kFStages * kFT * kLG;
    const bf16* vc = v_s + (tile - sp.t0) % kFStages * kFT * kLG;
    cp_async_wait<kFStages - 2>();  // this tile has landed
    __syncthreads();  // (and the last tile's products are done: its slot and kp_f are free)
    prefetch(tile + kFStages - 1);
    const int valid = min(kFT, n_tok - tile * kFT);
    if (cr0 < rows) {
      for (int r = cr0; r < kFT; r += rows) {
        float x[8];
        if (r < valid) {
          unpack8(*reinterpret_cast<const uint4*>(kc + r * kLG + ch * 8), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = __expf(x[e] - mc[e]) * ic[e];
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        }
        float4* kd = reinterpret_cast<float4*>(kp_f + r * kGroupW + ch * 8);
        kd[0] = float4{x[0], x[1], x[2], x[3]};
        kd[1] = float4{x[4], x[5], x[6], x[7]};
      }
    }
    __syncthreads();
    if (mine) {
#pragma unroll 2
      for (int t = tg; t < kFT; t += G) {
        float kr[8], vr[8];
        lds4(kr, kp_f + t * kGroupW + r0);
        lds4(kr + 4, kp_f + t * kGroupW + r0 + HD);
        unpack8(*reinterpret_cast<const uint4*>(vc + t * kLG + c0), vr);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(kr[i], vr[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  // row i of the block: k'^T row r0 + i % 4 + (i / 4) HD; columns c0 .. + 8
  float* dst = parts + (((size_t)b * splits + blockIdx.x) * f + gr.c0) * D;
  if (G == 1) {
    if (mine)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jh = 0; jh < 2; ++jh)
          *reinterpret_cast<float4*>(dst + (r0 + i % 4 + i / 4 * HD) * D + c0 - h * D + 4 * jh) =
              float4{acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2], acc[i][4 * jh + 3]};
    return;
  }
  __syncthreads();  // the rings and tiles are free
  float* red = smem;  // [G][wc][D]
  if (mine)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
        *reinterpret_cast<float4*>(red + ((size_t)tg * gr.wc + r0 + i % 4 + i / 4 * HD) * D +
                                   c0 - h * D + 4 * jh) =
            float4{acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2], acc[i][4 * jh + 3]};
  __syncthreads();
  for (int i = threadIdx.x; i < gr.wc * D; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) sum += red[g * gr.wc * D + i];
    dst[i] = sum;
  }
}

// #9 launch 4: block (z, g, b) holds group g's f32 ctx [wc][D] and walks
// the kFO-token steps of split z of batch row b, the q rows loading
// (cp.async, two buffers) a step ahead. Per (token, head), in f32: e =
// exp(q - the head's own max) into e^T [wc][kFO] and f = D^-1/2 / sum e
// (the sum guarded by 1e-30), so q' = e f. Thread (h, tn, et) keeps tokens
// tn kFN .. + kFN by columns et 4 .. + 4 of e ctx_h in registers, adding
// for each channel c the outer product of e^T's segment and ctx row c's,
// and scales each token's row by its f at the end (out = q' ctx_h with one
// exp an element); the block is rounded to bf16 once into the step's q
// buffer (free by then), and the rows are stored 16 bytes a thread.
template <int D>
__global__ void __launch_bounds__(kThreads, rows_out_blocks(D))
la_out_rows_kernel(const bf16* __restrict__ q, const float* __restrict__ ctx,
                   bf16* __restrict__ out, int n_tok, int heads, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ctx_s = smem;                                          // [kGroupW][D]
  float* qt = ctx_s + kGroupW * D;                              // e^T [kGroupW][kFO]
  float* fs = qt + kGroupW * kFO;                               // f [kGroupW / 16][kFO]
  bf16* q_s = reinterpret_cast<bf16*>(fs + kGroupW / 16 * kFO);  // [2][kFO][kLG]
  const HeadGroup gr(blockIdx.y, heads, D);
  const int b = blockIdx.z, f = heads * D, cpr = gr.wc / 8;
  const Span sp(blockIdx.x, splits, (n_tok + kFO - 1) / kFO);
  const bf16* qb = q + (size_t)b * n_tok * f + gr.c0;
  bf16* ob = out + (size_t)b * n_tok * f + gr.c0;
  auto prefetch = [&](int step, int buf) {
    if (step < sp.t1) copy_tile<kFO>(q_s + buf * kFO * kLG, qb, step, n_tok, f, gr.wc, vec);
    cp_async_commit();
  };
  prefetch(sp.t0, 0);
  const float4* cb = reinterpret_cast<const float4*>(ctx + ((size_t)b * f + gr.c0) * D);
  for (int i = threadIdx.x; i < gr.wc * D / 4; i += kThreads) reinterpret_cast<float4*>(ctx_s)[i] = cb[i];
  const float scale = rsqrtf((float)D);
  // a warp holds one head: et fastest, then tn (kFO / kFN = 8 a head), then h
  const int et = threadIdx.x % (D / 4), tn = threadIdx.x / (D / 4) % 8, h = threadIdx.x / (2 * D);
  const bool mine = h < gr.heads;
  for (int step = sp.t0; step < sp.t1; ++step) {
    const int buf = (step - sp.t0) & 1, n0 = step * kFO;
    bf16* cur = q_s + buf * kFO * kLG;
    prefetch(step + 1, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();  // this step's rows (and ctx_s) are in
    const int valid = min(kFO, n_tok - n0);
    for (int p = threadIdx.x; p < kFO * gr.heads; p += kThreads) {  // token r fastest
      const int r = p % kFO, hq = p / kFO;
      const bf16* row = cur + r * kLG + hq * D;
      float* col = qt + hq * D * kFO + r;  // e^T[hq D + c][r] at col[c kFO]
      float mx = -INFINITY, sum = 0.f;
      for (int c = 0; c < D; c += 8) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(row + c), x);
#pragma unroll
        for (int e = 0; e < 8; ++e) mx = fmaxf(mx, x[e]);
      }
      for (int c = 0; c < D; c += 8) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(row + c), x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ex = r < valid ? __expf(x[e] - mx) : 0.f;  // rows past N: zeros
          sum += ex;
          col[(c + e) * kFO] = ex;
        }
      }
      fs[hq * kFO + r] = scale / fmaxf(sum, 1e-30f);
    }
    __syncthreads();  // e^T and f are written
    if (mine) {
      float o[kFN][4] = {};
      const float* qc = qt + h * D * kFO + tn * kFN;
      const float* cc = ctx_s + h * D * D + et * 4;
      const float* fr = fs + h * kFO + tn * kFN;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float qr[kFN], cr[4];
        lds4(qr, qc + c * kFO);
        lds4(qr + 4, qc + c * kFO + 4);
        lds4(cr, cc + c * D);
#pragma unroll
        for (int i = 0; i < kFN; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(qr[i], cr[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kFN; ++i)
        *reinterpret_cast<uint2*>(cur + (tn * kFN + i) * kLG + h * D + et * 4) =
            uint2{pack_bf16(o[i][0] * fr[i], o[i][1] * fr[i]),
                  pack_bf16(o[i][2] * fr[i], o[i][3] * fr[i])};
    }
    __syncthreads();  // the step's outputs are in its buffer
    for (int i = threadIdx.x; i < kFO * cpr; i += kThreads) {
      const int r = i / cpr, c = (i % cpr) * 8;
      if (r < valid) store16(ob + (size_t)(n0 + r) * f + c, cur + r * kLG + c, vec);
    }
    __syncthreads();  // stored before the buffer loads again, and e^T is free
  }
  cp_async_wait<0>();
}

// Shared memory of the context and out launches (bytes).
constexpr int kStatSmem = kStages * kCT * kLG * 2 + 2 * kThreads * 8 * 4;
constexpr int kCtxSmem = 2 * kStages * kCT * kLG * 2 + 2 * kGroupW * 4;
constexpr int kCtxGivenSmem = 2 * kStages * kCT * kLG * 2;
template <int D>
constexpr int la_out_smem() { return kGroupW * (D + 8) * 2 + kWarps * 2 * kOT * kLG * 2; }

// ------------------------------------------------------------------ plan

constexpr int kRouteCores = 0, kRouteTensor = 1, kRouteRows = 1;

// The route, tiles and splits of #6 and #8 for one shape, and #6's
// workspace: ctx [B][H][D][D] in the operand type (both routes), then on
// the tensor route the records rec_m, rec_s [B][stat_splits][F] and, with
// more than one context split, the partials [B][ctx_splits][F][D], f32,
// each from a 256-byte boundary. A function of the shape alone: each
// launch's splits fill one wave of the card's SMs (its blocks an SM each)
// with the batch rows' groups.
struct LaPlan {
  int route, ctx_tile, ctx_splits, out_tile, out_splits, groups, stat_splits;
  long long ctx_bytes, rec_bytes, ws_bytes;
};

long long align256(long long n) { return (n + 255) / 256 * 256; }

int clampi(long long v, int lo, int hi) { return (int)(v < lo ? lo : v > hi ? hi : v); }

// bf16 at D % 16 == 0 (D <= 128): the shapes of the tensor and whole-row routes.
bool whole_rows(int d, int is_bf16) { return is_bf16 && d % 16 == 0 && d <= 128; }

// The groups of heads a batch row splits into on those routes.
int group_count(int heads, int d) {
  return (heads + HeadGroup::per_group(d) - 1) / HeadGroup::per_group(d);
}

// Splits of `tiles` that fill one wave of the card's SMs (blocks_per_sm
// each) with `rows` rows of blocks, at least one tile a split.
int wave_splits(int blocks_per_sm, long long rows, int tiles) {
  return clampi(kCardSMs * blocks_per_sm / rows, 1, tiles);
}

LaPlan make_la_plan(int batch, int n_tok, int heads, int d, int is_bf16) {
  LaPlan p{};
  const int f = heads * d;
  p.ctx_bytes = align256((long long)batch * f * d * (is_bf16 ? 2 : 4));
  if (!whole_rows(d, is_bf16)) {
    p.route = kRouteCores;
    p.ctx_tile = kTK;
    p.ctx_splits = 1;
    p.out_tile = kTN;
    p.out_splits = (n_tok + kTN - 1) / kTN;
    p.groups = heads;
    p.ws_bytes = p.ctx_bytes;
    return p;
  }
  p.route = kRouteTensor;
  p.groups = group_count(heads, d);
  const long long rows = (long long)batch * p.groups;
  const int tiles = (n_tok + kCT - 1) / kCT;
  p.stat_splits = wave_splits(kStatBlocks, rows, tiles);
  p.ctx_tile = kCT;
  p.ctx_splits = wave_splits(tc_blocks_per_sm(d), rows, tiles);
  p.out_tile = kOB;
  p.out_splits = wave_splits(tc_blocks_per_sm(d), rows, (n_tok + kOB - 1) / kOB);
  p.rec_bytes = align256((long long)batch * p.stat_splits * f * 4);
  p.ws_bytes = p.ctx_bytes + 2 * p.rec_bytes +
               (p.ctx_splits > 1 ? (long long)batch * p.ctx_splits * f * d * 4 : 0);
  return p;
}

// #7's route and splits for one shape, and its workspace: the splits'
// partials a [B][splits][F][D] and s [B][splits][F], f32, each from a
// 256-byte boundary (none on the tensor route at one split, where the
// context launch writes a and s). On the CUDA cores a split is a chunk of
// `chunk` tokens; on the tensor route the splits fill one wave as #6's
// context launch's do, whatever the chunk.
struct TwopassPlan {
  int route, splits, groups;
  long long a_bytes, ws_bytes;
};

TwopassPlan make_twopass_plan(int batch, int n_tok, int heads, int d, int chunk, int is_bf16) {
  TwopassPlan p{};
  const int f = heads * d;
  if (whole_rows(d, is_bf16)) {
    p.route = kRouteTensor;
    p.groups = group_count(heads, d);
    p.splits = wave_splits(tc_blocks_per_sm(d), (long long)batch * p.groups,
                           (n_tok + kCT - 1) / kCT);
  } else {
    p.route = kRouteCores;
    p.groups = heads;
    p.splits = (n_tok + chunk - 1) / chunk;
  }
  if (p.route == kRouteCores || p.splits > 1) {
    p.a_bytes = align256((long long)batch * p.splits * f * d * 4);
    p.ws_bytes = p.a_bytes + align256((long long)batch * p.splits * f * 4);
  }
  return p;
}

// #9's route, splits and workspace for one shape. The whole-row route (bf16
// at D % 16 == 0): the statistics, context and out launches' splits, each
// filling one wave; the workspace ctx [B][F][D], the records rec_m, rec_s
// [B][stat_splits][F] and, with more than one context split, the partials
// [B][ctx_splits][F][D], f32, each from a 256-byte boundary. The CUDA
// cores: one block per (batch, head), no workspace.
struct PerHeadPlan {
  int route, stat_splits, ctx_splits, out_splits, groups;
  long long ctx_bytes, rec_bytes, ws_bytes;
};

PerHeadPlan make_per_head_plan(int batch, int n_tok, int heads, int d, int is_bf16) {
  PerHeadPlan p{};
  if (!whole_rows(d, is_bf16)) {
    p.route = kRouteCores;
    p.ctx_splits = p.out_splits = 1;
    p.groups = heads;
    return p;
  }
  const int f = heads * d;
  p.route = kRouteRows;
  p.groups = group_count(heads, d);
  const long long rows = (long long)batch * p.groups;
  p.stat_splits = wave_splits(kStatBlocks, rows, (n_tok + kCT - 1) / kCT);
  p.ctx_splits = wave_splits(blocks_fitting(kRowsCtxSmem), rows, (n_tok + kFT - 1) / kFT);
  p.out_splits = wave_splits(rows_out_blocks(d), rows, (n_tok + kFO - 1) / kFO);
  p.ctx_bytes = align256((long long)batch * f * d * 4);
  p.rec_bytes = align256((long long)batch * p.stat_splits * f * 4);
  p.ws_bytes = p.ctx_bytes + 2 * p.rec_bytes +
               (p.ctx_splits > 1 ? (long long)batch * p.ctx_splits * f * d * 4 : 0);
  return p;
}

// Calls fn with std::integral_constant<int, D> for a head width of the
// tensor route (a multiple of 16 up to 128).
template <typename Fn>
int with_tc_width(int d, Fn&& fn) {
  switch (d) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 48: return fn(std::integral_constant<int, 48>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 80: return fn(std::integral_constant<int, 80>());
    case 96: return fn(std::integral_constant<int, 96>());
    case 112: return fn(std::integral_constant<int, 112>());
    case 128: return fn(std::integral_constant<int, 128>());
  }
  return (int)cudaErrorInvalidValue;
}

// #6's and #9's statistics launch.
int launch_stats(const bf16* k, float* rec_m, float* rec_s, int batch, int n_tok, int heads,
                 int d, int groups, int stat_splits, int vec, cudaStream_t stream) {
  int err = allow_smem<la_stats_kernel>(kStatSmem);
  if (err) return err;
  la_stats_kernel<<<dim3(stat_splits, groups, batch), kThreads, kStatSmem, stream>>>(
      k, rec_m, rec_s, n_tok, heads, d, stat_splits, vec);
  return (int)cudaGetLastError();
}

// sum_splits_kernel over a [B][per_a] and s [B][f].
template <typename U>
int launch_sum_splits(const float* a_part, const float* s_part, U* a, float* s, int batch,
                      int nc, int per_a, int f, cudaStream_t stream) {
  const long long total = (long long)batch * (per_a + f);
  sum_splits_kernel<U><<<dim3((unsigned)((total + kThreads - 1) / kThreads)), kThreads, 0,
                         stream>>>(a_part, s_part, a, s, batch, nc, per_a, f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_twopass_tc(const bf16* k, const bf16* v, const float* m, float* a, float* s, char* ws,
                      int batch, int n_tok, int heads, const TwopassPlan& p, int vec,
                      cudaStream_t stream) {
  const int f = heads * D;
  float* a_part = p.splits > 1 ? reinterpret_cast<float*>(ws) : a;
  float* s_part = p.splits > 1 ? reinterpret_cast<float*>(ws + p.a_bytes) : s;
  int err = allow_smem<la_ctx_given_kernel<D>>(kCtxGivenSmem);
  if (err) return err;
  la_ctx_given_kernel<D><<<dim3(p.splits, p.groups, batch), kThreads, kCtxGivenSmem, stream>>>(
      k, v, m, a_part, s_part, n_tok, heads, p.splits, vec);
  err = (int)cudaGetLastError();
  if (err || p.splits == 1) return err;  // with one split the context launch wrote a and s
  return launch_sum_splits(a_part, s_part, a, s, batch, p.splits, f * D, f, stream);
}

template <int D>
int launch_per_head_rows(const bf16* q, const bf16* k, const bf16* v, bf16* out, char* ws,
                         int batch, int n_tok, int heads, const PerHeadPlan& p, int vec,
                         cudaStream_t stream) {
  const int f = heads * D;
  float* ctx = reinterpret_cast<float*>(ws);
  float* rec_m = reinterpret_cast<float*>(ws + p.ctx_bytes);
  float* rec_s = reinterpret_cast<float*>(ws + p.ctx_bytes + p.rec_bytes);
  float* parts = reinterpret_cast<float*>(ws + p.ctx_bytes + 2 * p.rec_bytes);
  int err = launch_stats(k, rec_m, rec_s, batch, n_tok, heads, D, p.groups, p.stat_splits, vec,
                         stream);
  if (err) return err;
  err = allow_smem<la_ctx_rows_kernel<D>>(kRowsCtxSmem);
  if (err) return err;
  la_ctx_rows_kernel<D><<<dim3(p.ctx_splits, p.groups, batch), kThreads, kRowsCtxSmem, stream>>>(
      k, v, rec_m, rec_s, p.ctx_splits > 1 ? parts : ctx, n_tok, heads, p.stat_splits,
      p.ctx_splits, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (p.ctx_splits > 1) {  // with one split the context launch wrote ctx
    err = launch_sum_splits(parts, nullptr, ctx, nullptr, batch, p.ctx_splits, f * D, 0, stream);
    if (err) return err;
  }
  err = allow_smem<la_out_rows_kernel<D>>(rows_out_smem(D));
  if (err) return err;
  la_out_rows_kernel<D><<<dim3(p.out_splits, p.groups, batch), kThreads, rows_out_smem(D),
                          stream>>>(q, ctx, out, n_tok, heads, p.out_splits, vec);
  return (int)cudaGetLastError();
}

template <int D>
int launch_out_tc(const bf16* q, const bf16* ctx, bf16* out, int batch, int n_tok, int heads,
                  const LaPlan& p, int vec, cudaStream_t stream) {
  int err = allow_smem<la_out_tc_kernel<D>>(la_out_smem<D>());
  if (err) return err;
  la_out_tc_kernel<D><<<dim3(p.out_splits, p.groups, batch), kThreads, la_out_smem<D>(),
                        stream>>>(q, ctx, out, n_tok, heads, p.out_splits, vec);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fulllane_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out, char* ws,
                       int batch, int n_tok, int heads, const LaPlan& p, int vec,
                       cudaStream_t stream) {
  bf16* ctx = reinterpret_cast<bf16*>(ws);
  float* rec_m = reinterpret_cast<float*>(ws + p.ctx_bytes);
  float* rec_s = reinterpret_cast<float*>(ws + p.ctx_bytes + p.rec_bytes);
  float* parts = reinterpret_cast<float*>(ws + p.ctx_bytes + 2 * p.rec_bytes);
  int err = launch_stats(k, rec_m, rec_s, batch, n_tok, heads, D, p.groups, p.stat_splits, vec,
                         stream);
  if (err) return err;
  err = allow_smem<la_ctx_kernel<D>>(kCtxSmem);
  if (err) return err;
  la_ctx_kernel<D><<<dim3(p.ctx_splits, p.groups, batch), kThreads, kCtxSmem, stream>>>(
      k, v, rec_m, rec_s, parts, ctx, n_tok, heads, p.stat_splits, p.ctx_splits, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (p.ctx_splits > 1) {  // with one split the context launch wrote ctx
    err = launch_sum_splits(parts, nullptr, ctx, nullptr, batch, p.ctx_splits, heads * D * D, 0,
                            stream);
    if (err) return err;
  }
  return launch_out_tc<D>(q, ctx, out, batch, n_tok, heads, p, vec, stream);
}

// Calls fn with std::integral_constant<int, DP> for the padded width of d.
template <typename Fn>
int with_width(int d, Fn&& fn) {
  if (d <= 16) return fn(std::integral_constant<int, 16>());
  if (d <= 32) return fn(std::integral_constant<int, 32>());
  if (d <= 64) return fn(std::integral_constant<int, 64>());
  return fn(std::integral_constant<int, 128>());
}

template <typename T, int DP>
int launch_out(const void* q, const void* ctx, void* out, int batch, int n_tok, int heads,
               int d, cudaStream_t stream) {
  const size_t smem = out_smem_floats<DP>() * sizeof(float);
  int err = allow_smem<out_kernel<T, DP>>(smem);
  if (err) return err;
  out_kernel<T, DP><<<dim3((n_tok + kTN - 1) / kTN, heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ctx), static_cast<T*>(out), n_tok,
      heads, d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_fulllane(const void* q, const void* k, const void* v, void* ctx, void* out,
                    int batch, int n_tok, int heads, int d, cudaStream_t stream) {
  const size_t smem = ctx_smem_floats<DP>() * sizeof(float);
  int err = allow_smem<fulllane_ctx_kernel<T, DP>>(smem);
  if (err) return err;
  fulllane_ctx_kernel<T, DP><<<dim3(heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(ctx), n_tok, heads,
      d);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_out<T, DP>(q, ctx, out, batch, n_tok, heads, d, stream);
}

template <typename T, int DP>
int launch_per_head(const void* q, const void* k, const void* v, void* out, int batch,
                    int n_tok, int heads, int d, cudaStream_t stream) {
  const size_t smem = (ctx_smem_floats<DP>() + out_smem_floats<DP>()) * sizeof(float);
  int err = allow_smem<per_head_kernel<T, DP>>(smem);
  if (err) return err;
  per_head_kernel<T, DP><<<dim3(batch * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n_tok, heads, d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_ctx_twopass(const void* k, const void* v, const float* m, char* ws, float* a,
                       float* s, int batch, int n_tok, int heads, int d, int chunk,
                       const TwopassPlan& p, cudaStream_t stream) {
  float* a_part = reinterpret_cast<float*>(ws);
  float* s_part = reinterpret_cast<float*>(ws + p.a_bytes);
  const size_t smem = ctx_smem_floats<DP>() * sizeof(float);
  int err = allow_smem<ctx_part_kernel<T, DP>>(smem);
  if (err) return err;
  ctx_part_kernel<T, DP><<<dim3(p.splits, heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), m, a_part, s_part, n_tok, heads, d,
      chunk);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_sum_splits(a_part, s_part, a, s, batch, p.splits, heads * d * d, heads * d,
                           stream);
}

bool bad_shape(int batch, int n_tok, int heads, int d) {
  return batch < 1 || n_tok < 1 || heads < 1 || d < 1 || d > 128;
}

}  // namespace

// The plan of #6 and #8 for q [batch, n_tok, heads, d] (bf16 if is_bf16,
// else f32): out[0] the route (0 CUDA cores, 1 tensor cores), out[1] and
// out[2] the tile (tokens) and splits of #6's context launch, out[3] and
// out[4] those of the out pass (#6's last launch and #8), out[5] the
// splits of #6's statistics launch (tensor route; 0 on the CUDA cores).
// Returns the workspace bytes #6 needs, or -1 for a shape no kernel takes.
extern "C" long long ccdm_la_plan(int batch, int n_tok, int heads, int d, int is_bf16,
                                  int* out) {
  if (bad_shape(batch, n_tok, heads, d)) return -1;
  const LaPlan p = make_la_plan(batch, n_tok, heads, d, is_bf16);
  out[0] = p.route;
  out[1] = p.ctx_tile;
  out[2] = p.ctx_splits;
  out[3] = p.out_tile;
  out[4] = p.out_splits;
  out[5] = p.stat_splits;
  return p.ws_bytes;
}

// The plan of #7 for k [batch, n_tok, heads, d] and chunk: out[0] the route
// (0 CUDA cores, 1 tensor cores), out[1] the splits of N. Returns the
// workspace bytes, or -1 for a shape no kernel takes.
extern "C" long long ccdm_la_twopass_plan(int batch, int n_tok, int heads, int d, int chunk,
                                          int is_bf16, int* out) {
  if (bad_shape(batch, n_tok, heads, d) || chunk < 1) return -1;
  const TwopassPlan p = make_twopass_plan(batch, n_tok, heads, d, chunk, is_bf16);
  out[0] = p.route;
  out[1] = p.splits;
  return p.ws_bytes;
}

// The plan of #9 for q [batch, n_tok, heads, d]: out[0] the route (0 CUDA
// cores, 1 whole rows in f32), out[1], out[2] and out[3] the splits of its
// statistics, context and out launches (0, 1, 1 on the CUDA cores). Returns
// the workspace bytes, or -1 for a shape no kernel takes.
extern "C" long long ccdm_la_per_head_plan(int batch, int n_tok, int heads, int d, int is_bf16,
                                           int* out) {
  if (bad_shape(batch, n_tok, heads, d)) return -1;
  const PerHeadPlan p = make_per_head_plan(batch, n_tok, heads, d, is_bf16);
  out[0] = p.route;
  out[1] = p.stat_splits;
  out[2] = p.ctx_splits;
  out[3] = p.out_splits;
  return p.ws_bytes;
}

// #6: q, k, v, out [B, N, H, d], all bf16 if is_bf16, else f32; ws a
// 16-byte aligned workspace of ws_bytes >= what ccdm_la_plan returns. Every
// entry point launches on `stream` and returns the cudaError_t of its last
// launch check.
extern "C" int ccdm_la_fulllane(const void* q, const void* k, const void* v, void* out, void* ws,
                                int batch, int n_tok, int heads, int d, int is_bf16,
                                long long ws_bytes, void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  const LaPlan p = make_la_plan(batch, n_tok, heads, d, is_bf16);
  if (ws_bytes < p.ws_bytes || !aligned16(ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.route == kRouteTensor) {
    const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
    return with_tc_width(d, [&](auto w) {
      return launch_fulllane_tc<decltype(w)::value>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(out), static_cast<char*>(ws), batch, n_tok, heads, p, vec, st);
    });
  }
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_fulllane<__nv_bfloat16, DP>(q, k, v, ws, out, batch, n_tok, heads,
                                                        d, st)
                   : launch_fulllane<float, DP>(q, k, v, ws, out, batch, n_tok, heads, d, st);
  });
}

// #9: q, k, v, out [B, N, H, d], bf16 if is_bf16, else f32; ws a 16-byte
// aligned workspace of ws_bytes >= what ccdm_la_per_head_plan returns.
extern "C" int ccdm_la_per_head(const void* q, const void* k, const void* v, void* out, void* ws,
                                int batch, int n_tok, int heads, int d, int is_bf16,
                                long long ws_bytes, void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  const PerHeadPlan p = make_per_head_plan(batch, n_tok, heads, d, is_bf16);
  if (ws_bytes < p.ws_bytes || !aligned16(ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.route == kRouteRows) {
    const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
    return with_tc_width(d, [&](auto w) {
      return launch_per_head_rows<decltype(w)::value>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(out), static_cast<char*>(ws), batch, n_tok, heads, p, vec, st);
    });
  }
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_per_head<__nv_bfloat16, DP>(q, k, v, out, batch, n_tok, heads, d, st)
                   : launch_per_head<float, DP>(q, k, v, out, batch, n_tok, heads, d, st);
  });
}

// #7: k, v [B, N, H, d] (bf16 if is_bf16, else f32), m [B, F] f32; out a
// [B, H, d, d] and s [B, F] f32; ws a 16-byte aligned workspace of ws_bytes
// >= what ccdm_la_twopass_plan returns for the same chunk.
extern "C" int ccdm_la_ctx_twopass(const void* k, const void* v, const void* m, void* a, void* s,
                                   void* ws, int batch, int n_tok, int heads, int d, int chunk,
                                   int is_bf16, long long ws_bytes, void* stream) {
  if (bad_shape(batch, n_tok, heads, d) || chunk < 1) return (int)cudaErrorInvalidValue;
  const TwopassPlan p = make_twopass_plan(batch, n_tok, heads, d, chunk, is_bf16);
  if (ws_bytes < p.ws_bytes || !aligned16(ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  float* af = static_cast<float*>(a);
  float* sf = static_cast<float*>(s);
  char* wb = static_cast<char*>(ws);
  if (p.route == kRouteTensor) {
    const int vec = aligned16(k) && aligned16(v);
    return with_tc_width(d, [&](auto w) {
      return launch_twopass_tc<decltype(w)::value>(static_cast<const bf16*>(k),
                                                   static_cast<const bf16*>(v), mf, af, sf, wb,
                                                   batch, n_tok, heads, p, vec, st);
    });
  }
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_ctx_twopass<__nv_bfloat16, DP>(k, v, mf, wb, af, sf, batch, n_tok,
                                                           heads, d, chunk, p, st)
                   : launch_ctx_twopass<float, DP>(k, v, mf, wb, af, sf, batch, n_tok, heads,
                                                   d, chunk, p, st);
  });
}

// #8: q, out [B, N, H, d] and the finalised ctx [B, H, d, d], all bf16 if
// is_bf16, else f32; on #6's route for the shape (ccdm_la_plan).
extern "C" int ccdm_la_out_twopass(const void* q, const void* ctx, void* out, int batch,
                                   int n_tok, int heads, int d, int is_bf16, void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LaPlan p = make_la_plan(batch, n_tok, heads, d, is_bf16);
  if (p.route == kRouteTensor) {
    const int vec = aligned16(q) && aligned16(ctx) && aligned16(out);
    return with_tc_width(d, [&](auto w) {
      return launch_out_tc<decltype(w)::value>(static_cast<const bf16*>(q),
                                               static_cast<const bf16*>(ctx),
                                               static_cast<bf16*>(out), batch, n_tok, heads, p,
                                               vec, st);
    });
  }
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_out<__nv_bfloat16, DP>(q, ctx, out, batch, n_tok, heads, d, st)
                   : launch_out<float, DP>(q, ctx, out, batch, n_tok, heads, d, st);
  });
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

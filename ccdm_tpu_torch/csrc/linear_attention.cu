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
//   ccdm_la_ctx_twopass (#7, _kernel_ctx_twopass): given m = colmax(k) [B, F]
//     f32, per (chunk of tokens, head, batch) the partial a = exp(k - m)^T v
//     and s = sum exp(k - m); a second launch sums the partials over the
//     chunks in their order (no atomics) into a [B, H, D, D] and s [B, F], f32.
//   ccdm_la_out_twopass (#8, _kernel_out_twopass): #6's out pass on a context
//     the caller finalised (a / s, in the operand type), on #6's route.
//   ccdm_la_per_head (#9, _kernel): one block per (batch, head) does all of it
//     in f32, sweeping N three times (column max and sum, ctx, out).
// Rounding points on the bf16 path follow each TPU kernel: #6 rounds k', v, ctx
// and q' to bf16 for its products; #7 rounds exp(k - m) and v (s sums the
// unrounded values); #8 rounds q'; #9 rounds only the output. Products
// accumulate in f32. k' needs the exact max and sum over all N before any
// product (an online rescale would move its rounding point), so #6 reads k
// twice.
//
// What bounds them on this card: at B 64, N 4096, F 128 in bf16, #6 and #9
// must read q, k, v and write out (268 MB, 80 us at 3.35 TB/s) and do 4 B N F D
// products (4.3 GFLOP, 4.3 us at the bf16 tensor-core rate): bytes. #7 and #8
// each move half of that. The tensor route streams whole rows (every head of
// a token, 16 bytes a thread) with the products on the tensor cores, and
// moves 5/4 of #6's bound (k twice). The CUDA-core kernels (#7, #9, and #6
// and #8 off the tensor route) run the products as f32 FMAs from shared
// memory, a head a block.
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

// #7 launch 1: per (chunk, head, batch), the partial a [d][d] and s [d] of the
// chunk's tokens, into a_part [B, NC, H, d, d] and s_part [B, NC, F].
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

// #7 launch 2: a and s summed over the NC chunks in their order.
__global__ void __launch_bounds__(kThreads)
ctx_reduce_kernel(const float* __restrict__ a_part, const float* __restrict__ s_part,
                  float* __restrict__ a, float* __restrict__ s, int batch, int nc, int per_a,
                  int f) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long na = (long long)batch * per_a;
  if (i < na) {
    const long long b = i / per_a;
    const long long r = i % per_a;
    float sum = 0.f;
    for (int j = 0; j < nc; ++j) sum += a_part[(b * nc + j) * per_a + r];
    a[i] = sum;
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
// #6 and #8 in bf16 at D % 16 == 0 (make_la_plan's "tensor" route). A block
// takes whole token rows of a group of heads: every head at H D <= kGroupW
// (all the shapes of the checks and of the UNet's levels), else
// kGroupW / D heads a group. Rows are copied 16 bytes a thread, the
// products run on mma.sync m16n8k16 from ldmatrix, and every sum across
// blocks is a record merged in a fixed order: no atomics, the same bits on
// every run.

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

// Tile `tile` of a batch row (kCT rows of a group's wc channels, row stride
// f, from src) into dst [kCT][kLG], rows past N zeros; all the block's
// threads take part, the caller commits.
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int tile, int n_tok, int f,
                                          int wc, int vec) {
  copy_rows(dst, kLG, src + (size_t)tile * kCT * f, f, kCT, min(kCT, n_tok - tile * kCT), wc,
            vec, threadIdx.x, kThreads);
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
    if (mine) {
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

// #6 launch 3: ctx [B][F][D] = bf16 of the sum of the splits' partials, in
// their order, an element a thread.
__global__ void __launch_bounds__(kThreads)
la_ctx_sum_kernel(const float* __restrict__ parts, bf16* __restrict__ ctx, int splits,
                  long long per_b, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float* p = parts + (i / per_b) * splits * per_b + i % per_b;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += p[z * per_b];
  ctx[i] = __float2bfloat16(sum);
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

// Shared memory of the context and out launches (bytes).
constexpr int kStatSmem = kStages * kCT * kLG * 2 + 2 * kThreads * 8 * 4;
constexpr int kCtxSmem = 2 * kStages * kCT * kLG * 2 + 2 * kGroupW * 4;
template <int D>
constexpr int la_out_smem() { return kGroupW * (D + 8) * 2 + kWarps * 2 * kOT * kLG * 2; }

// ------------------------------------------------------------------ plan

constexpr int kRouteCores = 0, kRouteTensor = 1;

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

LaPlan make_la_plan(int batch, int n_tok, int heads, int d, int is_bf16) {
  LaPlan p{};
  const int f = heads * d;
  p.ctx_bytes = align256((long long)batch * f * d * (is_bf16 ? 2 : 4));
  if (!(is_bf16 && d % 16 == 0 && d <= 128)) {
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
  p.groups = (heads + HeadGroup::per_group(d) - 1) / HeadGroup::per_group(d);
  const long long rows = (long long)batch * p.groups;
  const int tiles = (n_tok + kCT - 1) / kCT;
  p.stat_splits = clampi(kCardSMs * kStatBlocks / rows, 1, tiles);
  p.ctx_tile = kCT;
  p.ctx_splits = clampi(kCardSMs * tc_blocks_per_sm(d) / rows, 1, tiles);
  p.out_tile = kOB;
  p.out_splits = clampi(kCardSMs * tc_blocks_per_sm(d) / rows, 1, (n_tok + kOB - 1) / kOB);
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
  int err = allow_smem<la_stats_kernel>(kStatSmem);
  if (err) return err;
  la_stats_kernel<<<dim3(p.stat_splits, p.groups, batch), kThreads, kStatSmem, stream>>>(
      k, rec_m, rec_s, n_tok, heads, D, p.stat_splits, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = allow_smem<la_ctx_kernel<D>>(kCtxSmem);
  if (err) return err;
  la_ctx_kernel<D><<<dim3(p.ctx_splits, p.groups, batch), kThreads, kCtxSmem, stream>>>(
      k, v, rec_m, rec_s, parts, ctx, n_tok, heads, p.stat_splits, p.ctx_splits, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (p.ctx_splits > 1) {  // with one split the context launch wrote ctx
    const long long per_b = (long long)heads * D * D, total = batch * per_b;
    la_ctx_sum_kernel<<<dim3((unsigned)((total + kThreads - 1) / kThreads)), kThreads, 0,
                        stream>>>(parts, ctx, p.ctx_splits, per_b, total);
    err = (int)cudaGetLastError();
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
int launch_ctx_twopass(const void* k, const void* v, const float* m, float* a_part,
                       float* s_part, float* a, float* s, int batch, int n_tok, int heads,
                       int d, int chunk, cudaStream_t stream) {
  const int nc = (n_tok + chunk - 1) / chunk;
  const size_t smem = ctx_smem_floats<DP>() * sizeof(float);
  int err = allow_smem<ctx_part_kernel<T, DP>>(smem);
  if (err) return err;
  ctx_part_kernel<T, DP><<<dim3(nc, heads, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), m, a_part, s_part, n_tok, heads, d,
      chunk);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int per_a = heads * d * d;
  const long long total = (long long)batch * (per_a + heads * d);
  ctx_reduce_kernel<<<dim3((unsigned)((total + kThreads - 1) / kThreads)), kThreads, 0,
                      stream>>>(a_part, s_part, a, s, batch, nc, per_a, heads * d);
  return (int)cudaGetLastError();
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

// #9: q, k, v, out [B, N, H, d], bf16 if is_bf16, else f32.
extern "C" int ccdm_la_per_head(const void* q, const void* k, const void* v, void* out,
                                int batch, int n_tok, int heads, int d, int is_bf16,
                                void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_per_head<__nv_bfloat16, DP>(q, k, v, out, batch, n_tok, heads, d, st)
                   : launch_per_head<float, DP>(q, k, v, out, batch, n_tok, heads, d, st);
  });
}

// #7: k, v [B, N, H, d] (bf16 if is_bf16, else f32), m [B, F] f32; scratch
// a_part [B, NC, H, d, d] and s_part [B, NC, F] f32 with NC = ceil(N / chunk);
// out a [B, H, d, d] and s [B, F] f32.
extern "C" int ccdm_la_ctx_twopass(const void* k, const void* v, const void* m, void* a_part,
                                   void* s_part, void* a, void* s, int batch, int n_tok,
                                   int heads, int d, int chunk, int is_bf16, void* stream) {
  if (bad_shape(batch, n_tok, heads, d) || chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  float* ap = static_cast<float*>(a_part);
  float* sp = static_cast<float*>(s_part);
  float* af = static_cast<float*>(a);
  float* sf = static_cast<float*>(s);
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_ctx_twopass<__nv_bfloat16, DP>(k, v, mf, ap, sp, af, sf, batch,
                                                           n_tok, heads, d, chunk, st)
                   : launch_ctx_twopass<float, DP>(k, v, mf, ap, sp, af, sf, batch, n_tok,
                                                   heads, d, chunk, st);
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

// Fused linear-attention block for Hopper (sm_90a): kernel #1.
//
// Replaces the TPU kernel ccdm_tpu/ops/attn_block.py:_kernel (launched by
// _forward_pallas). For x [B, N, C] and H heads of D channels (F = H * D):
//
//   y = x + RMSNorm_gout(Wout . LA(Wqkv . RMSNorm_gpre(x)) + bout)
//
// LA is the linear attention: q is softmaxed over each head's D channels
// (with the head's own max) and scaled by D^-1/2; k is softmaxed over the N
// tokens, per channel; ctx_h = k'_h^T v_h is D x D per head; out = q'_h .
// ctx_h. Norms, softmaxes, the sums over tokens and the epilogue run in f32;
// every product takes its operands in the activation type and accumulates in
// f32, which is the contract of the TPU kernel's bf16 MXU products.
//
// What bounds it on this card (NVIDIA H100 SXM, 700 W, data-sheet peaks of
// 989 TFLOP/s bf16 and 3.35 TB/s): one launch at B 64 in bf16 (F 128) does
// 128 N (512 C + 8192) operations and moves 256 N C bytes:
//
//   (N, C)                    operations bound    bytes bound
//   (4096, 64), twice a UNet  21.7 us             20.0 us
//   (1024, 128)                9.8 us             10.0 us
//   (1024, 64)                 5.4 us              5.0 us
//   the six with N <= 256     under 2.5 us each
//
// The N-4096 launches sit on the ridge: only the tensor cores with no
// intermediate in device memory come near the bound. The six small launches
// carry almost no work: there the number of launches and the host decide.
//
// Routes, chosen by a plan that is a function of the shape alone (make_plan,
// exported as ccdm_attn_block_plan), never on failure:
// - CUDA cores, for f32 and for the bf16 shapes the tensor-core routes do
//   not take (H != 4, D != 32, C > 512, and C > 416 past 77 to 108 tokens,
//   where neither route's shared memory fits; at D 32 none on the path of
//   the 64x64, 128x128 or 192x192 UNet at dim 64, but UK64's dim 72 gives
//   its N 16 level C 576), at any D:
//   the design of the first port, three launches per call: qkv_kernel writes
//   the qkv projection [B, N, 3F] in f32 to the workspace, ctx_kernel the
//   per-head context, out_kernel the rest. In f32 it serves the checks whose
//   bounds TF32 would break.
// - bf16 (H = 4, D = 32, C <= 512), on the tensor cores: mma.sync m16n8k16 (bf16 in,
//   f32 accumulate) with both operands from shared memory through ldmatrix
//   (.trans for the weights), 8 warps in a 2 x 4 grid: a warp owns 32 tokens
//   of a 64-token tile and the 32 channels of one head, so that each head's
//   softmaxes and context stay inside one warp. No [B, N, 3F] tensor reaches
//   device memory.
//   * split (N > 128): pass 1, per (split of the tokens, batch row): the
//     pre-norm, k and v of each 64-token tile (xn . Wqkv[:, F:3F]), and an
//     online softmax over the tokens: a running max m per channel,
//     s = sum exp(k - m) and the per-head context a = exp(k - m)^T v (a
//     32 x 32 product per warp), rescaled when m grows. It writes only f32
//     partials (m, s, a), one record per warp row. The reduce, per batch row,
//     merges the records in a fixed order (deterministic, no atomics) into
//     ctx = a / s in bf16. Pass 2, per split: for each tile the pre-norm and
//     q again (x is C wide; q in f32 was 512 bytes a token), the per-head
//     softmax of q, q' . ctx_h with q' taken from the accumulators straight
//     into A fragments, . Wout + bout, then the out-norm and the residual in
//     f32 as the epilogue, y staged in bf16 and stored 16 bytes a thread.
//     The splits fill one wave of two blocks an SM; each block walks its
//     tiles with the next tile's x loading (cp.async) while it works on the
//     current one, and at C <= 128 keeps its weights resident in shared
//     memory (above, they stream through a 3-stage ring of 32-row K slices).
//   * fused (N <= 128, where the row fits): one launch, a block per batch
//     row that keeps the row's x in shared memory and runs pass 1, the merge
//     and pass 2 itself, the weights streaming through the ring (Wqkv at
//     C 512 is 393 KB in bf16): k's and v's K slices side by side, or, at
//     C > 256 where the row leaves no room for that (C 512 past N 53, as
//     the 128x128 UNet's 8x8 level), one after the other through a ring of
//     one chunk.
//   The sizes (fused up to N 128, two blocks an SM, splits filling one wave)
//   won a timed comparison of variants on the card (scripts/attn_variants.py,
//   PERF.md). The
//   norms and the softmaxes, not the products, take most of a tile's time.
//   The bf16 rounding points are where the TPU kernel fed its MXU: xn, v, q',
//   ctx and the attention output; and exp(k - m), which stands where the TPU
//   kernel rounded its normalised k' (the division by s moved after the
//   product: a rounding point moved, not a new one). s sums exp(k - m)
//   unrounded. Channels not a multiple of 8, or a base not 16-byte aligned,
//   take element loads and stores into the same layouts.
// One C call issues every launch of its route. The caller allocates the
// workspace that the plan sizes. Each kernel's shared-memory limit is set
// once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "common.cuh"
#include "attn_common.cuh"

namespace {

// ------------------------------------------- CUDA cores: f32, other shapes
// A head has dh channels (dim_head): any, where the tensor-core routes take
// kD. One warp works on a (token, head) pair with its lanes striding the
// head's channels.

constexpr int kTN = 32;        // tokens per block in launches 1 and 3
constexpr int kTNP = kTN + 4;  // padded row of a transposed [*, kTN] tile (float4-aligned)
constexpr int kTK = 64;        // tokens per shared-memory tile in launch 2
constexpr int kCtxPer = 4;     // entries of ctx a thread sums in one pass over the tokens
static_assert(kTN % kTG == 0 && kTG == 8, "fma8 reads a tile of 8 tokens");

// Launch 1: qkv[b, n, :] = RMSNorm_gpre(x[b, n, :]) . Wqkv, for 32 tokens.
// Dynamic shared memory: the normalised tile, transposed, [C][kTNP] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_kernel(const T* __restrict__ x, const T* __restrict__ g_pre,
           const T* __restrict__ wqkv, float* __restrict__ qkv,
           int n_tok, int c_dim, int f3) {
  extern __shared__ __align__(16) float smem[];
  float* xn_t = smem;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xb = x + (size_t)b * n_tok * c_dim;

  for (int i = warp; i < kTN; i += kWarps) {
    const int n = n0 + i;
    if (n < n_tok) {  // uniform across the warp
      const T* row = xb + (size_t)n * c_dim;
      float ss = 0.f;
      for (int c = lane; c < c_dim; c += 32) {
        const float v = to_f32(row[c]);
        ss = fmaf(v, v, ss);
      }
      const float inv = rsqrtf(warp_sum(ss) / (float)c_dim + 1e-12f);
      for (int c = lane; c < c_dim; c += 32)
        xn_t[c * kTNP + i] = as_operand<T>(to_f32(row[c]) * inv * to_f32(g_pre[c]));
    } else {
      for (int c = lane; c < c_dim; c += 32) xn_t[c * kTNP + i] = 0.f;
    }
  }
  __syncthreads();

  constexpr int kGroups = kTN / kTG;
  for (int task = threadIdx.x; task < f3 * kGroups; task += kThreads) {
    const int j = task % f3;
    const int g = task / f3;
    float acc[kTG] = {};
    const T* wcol = wqkv + j;
    for (int c = 0; c < c_dim; ++c)
      fma8(acc, xn_t + c * kTNP + g * kTG, to_f32(wcol[(size_t)c * f3]));
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      const int n = n0 + g * kTG + t;
      if (n < n_tok) qkv[((size_t)b * n_tok + n) * f3 + j] = acc[t];
    }
  }
}

// Shared-memory floats of launch 2 for a head of dh channels.
inline int ctx_smem_floats(int dh) { return 2 * kTK * dh + 2 * dh + kWarps * dh; }

// Launch 2: per (head, batch), ctx[d][e] = sum_n softmax_N(k)[n][d] v[n][e].
// Each pass over the tokens sums kCtxPer entries of ctx a thread (entry
// first + kCtxPer threadIdx.x + j, row-major); a head of 32 takes one pass.
// Dynamic shared memory, f32: exp(k - kmax) and v of kTK tokens [kTK][dh]
// each, the column max and the column sums [dh], the warps' maxima
// [kWarps][dh].
__global__ void __launch_bounds__(kThreads)
ctx_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, int n_tok, int f, int dh) {
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem;
  float* v_s = e_s + kTK * dh;
  float* kmax = v_s + kTK * dh;
  float* s_s = kmax + dh;
  float* red = s_s + dh;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int heads = gridDim.x;
  const int f3 = 3 * f;
  const int kcol = f + h * dh;
  const int vcol = 2 * f + h * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* base = qkv + (size_t)b * n_tok * f3;

  // exact column max of k over all tokens
  for (int cc = lane; cc < dh; cc += 32) {
    float m = -INFINITY;
    for (int n = warp; n < n_tok; n += kWarps) m = fmaxf(m, base[(size_t)n * f3 + kcol + cc]);
    red[warp * dh + cc] = m;
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < dh; cc += kThreads) {
    float m = red[cc];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * dh + cc]);
    kmax[cc] = m;
    s_s[cc] = 0.f;
  }
  __syncthreads();

  float* out = ctx + ((size_t)b * heads + h) * dh * dh;
  for (int first = 0; first < dh * dh; first += kThreads * kCtxPer) {
    int row[kCtxPer], col[kCtxPer];
#pragma unroll
    for (int j = 0; j < kCtxPer; ++j) {
      const int i = first + threadIdx.x * kCtxPer + j;
      row[j] = i < dh * dh ? i / dh : -1;  // -1: past the last entry
      col[j] = i % dh;
    }
    float acc[kCtxPer] = {};
    for (int n0 = 0; n0 < n_tok; n0 += kTK) {
      const int rows = min(kTK, n_tok - n0);
      for (int idx = threadIdx.x; idx < rows * dh; idx += kThreads) {
        const int r = idx / dh;
        const int cc = idx % dh;
        const float* tok = base + (size_t)(n0 + r) * f3;
        e_s[idx] = expf(tok[kcol + cc] - kmax[cc]);
        v_s[idx] = tok[vcol + cc];
      }
      __syncthreads();
      if (first == 0)  // the column sums, once
        for (int d = threadIdx.x; d < dh; d += kThreads) {
          float s = s_s[d];
          for (int r = 0; r < rows; ++r) s += e_s[r * dh + d];
          s_s[d] = s;
        }
      for (int r = 0; r < rows; ++r)
#pragma unroll
        for (int j = 0; j < kCtxPer; ++j)
          if (row[j] >= 0) acc[j] = fmaf(e_s[r * dh + row[j]], v_s[r * dh + col[j]], acc[j]);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kCtxPer; ++j)
      if (row[j] >= 0) out[row[j] * dh + col[j]] = acc[j] / s_s[row[j]];
  }
}

// Launch 3: per 32 tokens, y = x + RMSNorm_gout((q' . ctx) . Wout + bout).
// Dynamic shared memory, f32: q' transposed [F][kTNP], ctx [H][dh][dh], the
// attention output transposed [F][kTNP], the out projection [kTN][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
out_kernel(const T* __restrict__ x, const float* __restrict__ qkv,
           const float* __restrict__ ctx, const T* __restrict__ wout,
           const T* __restrict__ bout, const T* __restrict__ g_out,
           T* __restrict__ y, int n_tok, int c_dim, int f, int dh) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;
  float* ctx_s = q_t + f * kTNP;
  float* a_t = ctx_s + f * dh;
  float* o_s = a_t + f * kTNP;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTN;
  const int heads = f / dh;
  const int f3 = 3 * f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)dh);

  // q': one warp per (token, head), its lanes striding the head's channels
  for (int task = warp; task < kTN * heads; task += kWarps) {
    const int i = task / heads;
    const int h = task % heads;
    const int n = n0 + i;
    float* col = q_t + h * dh * kTNP + i;  // channel cc at col[cc * kTNP]
    if (n < n_tok) {  // uniform across the warp
      const float* q = qkv + ((size_t)b * n_tok + n) * f3 + h * dh;
      float m = -INFINITY;
      for (int cc = lane; cc < dh; cc += 32) m = fmaxf(m, q[cc]);
      m = warp_max(m);
      float sum = 0.f;
      for (int cc = lane; cc < dh; cc += 32) {
        const float e = expf(q[cc] - m);
        col[cc * kTNP] = e;
        sum += e;
      }
      sum = fmaxf(warp_sum(sum), 1e-30f);
      for (int cc = lane; cc < dh; cc += 32)
        col[cc * kTNP] = as_operand<T>(col[cc * kTNP] / sum * scale);
    } else {
      for (int cc = lane; cc < dh; cc += 32) col[cc * kTNP] = 0.f;
    }
  }
  const float* cb = ctx + (size_t)b * heads * dh * dh;
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) ctx_s[idx] = as_operand<T>(cb[idx]);
  __syncthreads();

  constexpr int kGroups = kTN / kTG;
  // a[i][h*dh + e] = sum_d q'[i][h*dh + d] ctx[h][d][e]
  for (int task = threadIdx.x; task < f * kGroups; task += kThreads) {
    const int col = task % f;
    const int g = task / f;
    const int h = col / dh;
    const int e = col % dh;
    float acc[kTG] = {};
    const float* ch = ctx_s + h * dh * dh + e;
    const float* qh = q_t + h * dh * kTNP + g * kTG;
    for (int dd = 0; dd < dh; ++dd) fma8(acc, qh + dd * kTNP, ch[dd * dh]);
#pragma unroll
    for (int t = 0; t < kTG; ++t) a_t[col * kTNP + g * kTG + t] = as_operand<T>(acc[t]);
  }
  __syncthreads();

  // o[i][c] = sum_f a[i][f] wout[f][c] + bout[c]
  for (int task = threadIdx.x; task < c_dim * kGroups; task += kThreads) {
    const int c = task % c_dim;
    const int g = task / c_dim;
    float acc[kTG] = {};
    for (int ff = 0; ff < f; ++ff)
      fma8(acc, a_t + ff * kTNP + g * kTG, to_f32(wout[(size_t)ff * c_dim + c]));
    const float bias = to_f32(bout[c]);
#pragma unroll
    for (int t = 0; t < kTG; ++t) o_s[(g * kTG + t) * c_dim + c] = acc[t] + bias;
  }
  __syncthreads();

  // out-norm and residual: one warp per token
  for (int i = warp; i < kTN; i += kWarps) {
    const int n = n0 + i;
    if (n >= n_tok) break;  // uniform across the warp; later i are past N too
    const float* orow = o_s + i * c_dim;
    float ss = 0.f;
    for (int c = lane; c < c_dim; c += 32) ss = fmaf(orow[c], orow[c], ss);
    const float inv = rsqrtf(warp_sum(ss) / (float)c_dim + 1e-12f);
    const size_t off = ((size_t)b * n_tok + n) * c_dim;
    for (int c = lane; c < c_dim; c += 32)
      y[off + c] = from_f32<T>(to_f32(x[off + c]) + orow[c] * inv * to_f32(g_out[c]));
  }
}

// ------------------------------------------------- bf16: tensor cores

constexpr int kBM = 64;            // tokens per tile: 2 warp rows of 32
constexpr int kStages = 3;         // cp.async ring depth of a streamed weight
constexpr int kMaxC = 512;         // widest C of the bf16 route (4 column chunks of Wout)
constexpr int kSplitOcc = 2;       // blocks per SM that the split route's passes fill
constexpr int kSplitMinBlocks = 2; // the split passes' __launch_bounds__ minimum blocks per SM
constexpr int kFusedMaxN = 128;    // the longest row the fused route takes
constexpr int kCS = kD + 8;        // bf16 per row of ctx in shared memory
constexpr int kAO = kBN + 8;       // bf16 per row of the attention output or a staged y chunk
static_assert(kThreads == 256 && kBM == 64 && kBN == 128 && kF == kBN,
              "8 warps in 2 x 4 tiles of 32 x 32; a head per warp column");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Bytes of the shared-memory regions (each a multiple of 16).
constexpr int kRing1 = kStages * kBK * (kBN + 8) * 2;      // the ring for one weight chunk
constexpr int kRing2 = kStages * kBK * (2 * kBN + 8) * 2;  // ... for two (k and v together)
constexpr int kScratch1 = kWarps * kWarpScratch;
constexpr int kRecords = 2 * kPart * 4;                    // the fused route's two records
constexpr int kAOBytes = kBM * kAO * 2;
constexpr int kCtxBytes = kF * kCS * 2;
constexpr int kRedBytes = kBM * 4 * 4 + kBM * 4;           // per-warp sums of squares, 1/rms
constexpr int kVecBytes = 3 * kMaxC * 4;                   // g_pre, bout, g_out in f32

// C rounded up to whole K slices, plus 8 bf16: the row of an x or xn tile.
__host__ __device__ inline int row_ld(int c) { return (c + kBK - 1) / kBK * kBK + 8; }
__host__ __device__ inline int chunks_of(int c) { return c <= kBN ? 1 : c <= 2 * kBN ? 2 : 4; }
__host__ __device__ inline int tile_bytes(int c) { return kBM * row_ld(c) * 2; }

// Byte offsets of a kernel's shared memory: vec: g_pre, bout and g_out in
// f32 ([3][kMaxC], zero past C); w (split, resident): Wkv, or Wq then Wout;
// x: the x tiles (split: two, the next one loading while the block works on
// the other) or the whole row (fused); xn: the normalised tile; ring: a
// streamed weight's ring; scratch: pass 1's per-warp tiles (fused: then the
// records); ao: the attention output, then the staged y chunks; ctx; red.
struct Layout {
  int vec, w, x, xn, ring, scratch, ao, ctx, red, total;
};

__host__ __device__ inline Layout pass1_layout(int c, bool resident) {
  Layout l{};
  const int c_pad = row_ld(c) - 8;
  l.w = kVecBytes;
  l.x = l.w + (resident ? c_pad * (2 * kBN + 8) * 2 : 0);
  l.ring = l.x + 2 * tile_bytes(c);
  l.scratch = l.ring + (resident ? 0 : kRing2);
  l.total = l.scratch + kScratch1;
  return l;
}

__host__ __device__ inline Layout pass2_layout(int c, bool resident) {
  Layout l{};
  const int c_pad = row_ld(c) - 8;
  l.w = kVecBytes;
  l.x = l.w + (resident ? (c_pad + kF) * (kBN + 8) * 2 : 0);
  l.xn = l.x + 2 * tile_bytes(c);
  l.ring = l.xn + tile_bytes(c);
  l.ao = l.ring + (resident ? 0 : kRing1);
  l.ctx = l.ao + kAOBytes;
  l.red = l.ctx + kCtxBytes;
  l.total = l.red + kRedBytes;
  return l;
}

// The fused route's ring holds k's and v's K slices side by side (kRing2),
// or, where the row leaves no room for that (narrow), one chunk's: k and v
// then stream one after the other.
__host__ __device__ inline Layout fused_layout(int n, int c, bool narrow) {
  Layout l{};
  l.x = kVecBytes;
  l.xn = l.x + n * row_ld(c) * 2;
  l.ring = l.xn + tile_bytes(c);
  l.scratch = l.ao = l.ring + (narrow ? kRing1 : kRing2);
  l.ctx = l.scratch + cmax(cmax(kScratch1, kRecords), kAOBytes);
  l.red = l.ctx + kCtxBytes;
  l.total = l.red + kRedBytes;
  return l;
}

// Whether the fused route at (n, c) takes the narrow ring: only at C > 256,
// where the wide one does not fit beside the row (C 512 from N 54 to 77).
__host__ __device__ inline bool fused_narrow(int n, int c) {
  return chunks_of(c) == 4 && fused_layout(n, c, false).total > kMaxSmem;
}

// Copies rows [0, rows) of src [*, c] to dst [rows][ld], zero past rows_valid
// and past column c (up to the whole K slice). Issues cp.async copies (vec)
// or element loads; the caller commits, waits and synchronises.
__device__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src, int rows,
                          int rows_valid, int c, int vec) {
  const int per_row = (ld - 8) / 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, col = (i % per_row) * 8;
    const bool ok = r < rows_valid && col < c;
    const bf16* s = ok ? src + (size_t)r * c + col : src;
    bf16* d = dst + r * ld + col;
    if (vec) {
      cp_async_16(d, s, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok && col + e < c ? s[e] : zero;
    }
  }
}

// The vectors of the block in f32, zero past C: vs[0] g_pre, vs[1] bout,
// vs[2] g_out ([3][kMaxC]). Visible after the caller's next barrier.
__device__ void load_vectors(float* vs, const bf16* g_pre, const bf16* bout, const bf16* g_out,
                             int c) {
  for (int i = threadIdx.x; i < kMaxC; i += kThreads) {
    vs[i] = i < c ? bf(g_pre[i]) : 0.f;
    vs[kMaxC + i] = i < c ? bf(bout[i]) : 0.f;
    vs[2 * kMaxC + i] = i < c ? bf(g_out[i]) : 0.f;
  }
}

// dst[r] = bf16(RMSNorm_g(src[r])) for the kBM rows of a tile (zero past
// rows_valid; past column c src is zero and g, f32 in shared memory, is
// zero); src and dst may be the same rows. A row's 16-byte chunks are spread
// over a group of lanes (a power of two), so a warp takes 32 / group rows at
// once and reduces their sums of squares side by side.
__device__ void norm_rows(bf16* dst, const bf16* src, int ld, const float* g, int rows_valid,
                          int c) {
  const int lane = threadIdx.x & 31, chunks = (ld - 8) / 8;
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  const int per_warp = 32 / group, sub = lane % group;
  for (int r0 = (threadIdx.x >> 5) * per_warp; r0 < kBM; r0 += kWarps * per_warp) {
    const int r = r0 + lane / group;
    const bool ok = r < rows_valid;
    float ss = 0.f;
    if (ok) {
      for (int k = sub; k < chunks; k += group) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(src + r * ld + k * 8), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
      }
    }
    for (int o = group / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / (float)c + 1e-12f);
    for (int k = sub; k < chunks; k += group) {
      uint4 out{0u, 0u, 0u, 0u};
      if (ok) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(src + r * ld + k * 8), v);
        const float4 g0 = *reinterpret_cast<const float4*>(g + k * 8);
        const float4 g1 = *reinterpret_cast<const float4*>(g + k * 8 + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        out.x = pack_bf16(v[0] * inv * gv[0], v[1] * inv * gv[1]);
        out.y = pack_bf16(v[2] * inv * gv[2], v[3] * inv * gv[3]);
        out.z = pack_bf16(v[4] * inv * gv[4], v[5] * inv * gv[5]);
        out.w = pack_bf16(v[6] * inv * gv[6], v[7] * inv * gv[7]);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + k * 8) = out;
    }
  }
}

// acc += A . W over K = k_total, W streamed from device memory through the
// ring in K slices. Ends with the ring drained and the block synchronised.
// Every thread calls it.
template <int NB>
__device__ __forceinline__ void mma_stream(float (&acc)[NB][2][4][4], const bf16* a_s, int lda,
                                           const WSlab& ws, int k_total, bf16* ring, int vec) {
  constexpr int stage = kBK * (NB * kBN + 8);
  const int n_kt = (k_total + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_slab<NB>(ring + s * stage, ws, s * kBK, kBK, k_total, vec);
    cp_async_commit();
  }
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<kStages - 2>();  // slice i has landed
    __syncthreads();               // ... for every thread; and slot (i - 1) is free
    if (i + kStages - 1 < n_kt)
      load_slab<NB>(ring + ((i + kStages - 1) % kStages) * stage, ws, (i + kStages - 1) * kBK,
                    kBK, k_total, vec);
    cp_async_commit();
    mma_slice<NB>(acc, a_s, lda, i * kBK, ring + (i % kStages) * stage);
  }
  cp_async_wait<0>();
  __syncthreads();
}

struct Weights {
  const bf16 *g_pre, *wqkv, *wout, *bout, *g_out;
};

// Pass 1 of one tile: k and v of xn (normalised rows, [kBM][row_ld(c)]),
// folded into st. The weights: resident Wkv (w_s) or streamed (ring), Wk and
// Wv side by side or (NARROW) one after the other.
template <bool RES, bool NARROW = false>
__device__ void pass1_tile(WarpCtx& st, const bf16* xn, int rows, const Weights& wt, int c,
                           const bf16* w_s, bf16* ring, char* scratch, int vec) {
  const Lane q;
  char* warp_scratch = scratch + (threadIdx.x >> 5) * kWarpScratch;
  if constexpr (NARROW) {
    float k[1][2][4][4] = {}, v[1][2][4][4] = {};
    mma_stream<1>(k, xn, row_ld(c), WSlab{wt.wqkv, 3 * kF, kF, kBN, 3 * kF}, c, ring, vec);
    mma_stream<1>(v, xn, row_ld(c), WSlab{wt.wqkv, 3 * kF, 2 * kF, kBN, 3 * kF}, c, ring, vec);
    online_update(st, k[0], v[0], rows - q.wm * 32, warp_scratch);
    return;
  }
  float kv[2][2][4][4] = {};
  if constexpr (RES) {
    mma_resident<2>(kv, xn, row_ld(c), w_s, c);
  } else {
    mma_stream<2>(kv, xn, row_ld(c), WSlab{wt.wqkv, 3 * kF, kF, kF, 3 * kF}, c, ring, vec);
  }
  online_update(st, kv[0], kv[1], rows - q.wm * 32, warp_scratch);
}

// Pass 2 of one tile: x_s its x rows, xn its normalised rows (both
// [kBM][row_ld(c)]), ctx_s the context [F][kCS] in bf16, vs the vectors
// (load_vectors); y0 the tile's first row of y. The weights: resident Wq
// (wq_s) and Wout (wo_s) (NC 1), or streamed through the ring. Ends with the
// block synchronised.
template <int NC, bool RES>
__device__ void pass2_tile(const bf16* x_s, const bf16* xn, const Weights& wt, const bf16* ctx_s,
                           const float* vs, bf16* y0, int rows, int c, const bf16* wq_s,
                           const bf16* wo_s, bf16* ring, bf16* ao, float* red, int vec) {
  static_assert(!RES || NC == 1, "resident weights take C <= 128");
  const Lane q;
  const int ld = row_ld(c);
  float qa[1][2][4][4] = {};
  if constexpr (RES) {
    mma_resident<1>(qa, xn, ld, wq_s, c);
  } else {
    mma_stream<1>(qa, xn, ld, WSlab{wt.wqkv, 3 * kF, 0, kBN, kF}, c, ring, vec);
  }
  // softmax of q over the head's channels (the quad of a row holds them all),
  // times D^-1/2, rounded to bf16 into the A fragments of q' . ctx_h
  uint32_t aq[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mx = fmaxf(mx, fmaxf(qa[0][mi][ni][h * 2], qa[0][mi][ni][h * 2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = qa[0][mi][ni][h * 2 + e];
          v = __expf(v - mx);
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float f = rsqrtf((float)kD) / fmaxf(sum, 1e-30f);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        qa[0][mi][ni][h * 2] *= f;
        qa[0][mi][ni][h * 2 + 1] *= f;
      }
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      aq[mi][kk][0] = pack_bf16(qa[0][mi][2 * kk][0], qa[0][mi][2 * kk][1]);
      aq[mi][kk][1] = pack_bf16(qa[0][mi][2 * kk][2], qa[0][mi][2 * kk][3]);
      aq[mi][kk][2] = pack_bf16(qa[0][mi][2 * kk + 1][0], qa[0][mi][2 * kk + 1][1]);
      aq[mi][kk][3] = pack_bf16(qa[0][mi][2 * kk + 1][2], qa[0][mi][2 * kk + 1][3]);
    }
  // out_h = q'_h . ctx_h, rounded to bf16 into the attention output tile
  float o[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t bfr[2][4];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(bfr[nj], ctx_s + (q.wn * kD + kk * 16 + (q.lane & 15)) * kCS + nj * 16 +
                                     (q.lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b[2] = {bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]};
        mma_16816(o[mi][ni], aq[mi][kk], b);
      }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<uint32_t*>(ao + (q.wm * 32 + mi * 16 + q.g + 8 * h) * kAO + q.wn * kD +
                                     ni * 8 + 2 * q.t) =
            pack_bf16(o[mi][ni][h * 2], o[mi][ni][h * 2 + 1]);
  __syncthreads();
  // o = out . Wout + bout, NC chunks of 128 columns
  float acc[NC][2][4][4] = {};
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float(&aj)[1][2][4][4] = *reinterpret_cast<float(*)[1][2][4][4]>(&acc[j]);
    if constexpr (RES) {
      mma_resident<1>(aj, ao, kAO, wo_s, kF);
    } else {
      mma_stream<1>(aj, ao, kAO, WSlab{wt.wout, c, j * kBN, kBN, c}, kF, ring, vec);
    }
  }
  // the out-norm's sum of squares per row: over the quad, then the warp columns
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * kBN + q.wn * kD + ni * 8 + 2 * q.t + e;
            float& v = acc[j][mi][ni][h * 2 + e];
            v = col < c ? v + vs[kMaxC + col] : 0.f;
            ss = fmaf(v, v, ss);
          }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (q.t == 0) red[(q.wm * 32 + mi * 16 + q.g + 8 * h) * 4 + q.wn] = ss;
    }
  __syncthreads();  // red is complete; every warp has read ao
  float* inv = red + kBM * 4;
  if (threadIdx.x < kBM) {
    const float* r4 = red + threadIdx.x * 4;
    inv[threadIdx.x] = rsqrtf((r4[0] + r4[1] + r4[2] + r4[3]) / (float)c + 1e-12f);
  }
  __syncthreads();
  // y = x + o * inv * g_out, rounded to bf16 into ao (a chunk at a time), then
  // stored 8 channels (16 bytes) a thread
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q.wm * 32 + mi * 16 + q.g + 8 * h;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int cc = q.wn * kD + ni * 8 + 2 * q.t, col = j * kBN + cc;
          float y2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = col + e < c && r < rows ? col + e : 0;  // past C or N: not stored
            y2[e] = bf(x_s[r * ld + cl]) + acc[j][mi][ni][h * 2 + e] * inv[r] * vs[2 * kMaxC + cl];
          }
          *reinterpret_cast<uint32_t*>(ao + r * kAO + cc) = pack_bf16(y2[0], y2[1]);
        }
      }
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), cc = (i % (kBN / 8)) * 8, col = j * kBN + cc;
      if (r >= rows || col >= c) continue;
      const bf16* src = ao + r * kAO + cc;
      bf16* dst = y0 + (size_t)r * c + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < c; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();
  }
}

// Loads tile `tile` of the row at xb into buffer `buf` (cp.async where vec)
// and commits the copies as one group, or commits an empty group past t1.
__device__ __forceinline__ void prefetch_tile(bf16* buf, const bf16* xb, int tile, int t1, int n,
                                              int c, int vec) {
  if (tile < t1)
    load_rows(buf, row_ld(c), xb + (size_t)tile * kBM * c, kBM, min(kBM, n - tile * kBM), c,
              vec);
  cp_async_commit();
}

// Split route, pass 1: block (z, b) folds the tiles of split z of row b and
// writes one record per warp row to parts [B][splits][2][kPart]. The next
// tile's x loads while the block works on the current one.
template <bool RES>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks)
split_pass1_kernel(const bf16* __restrict__ x, Weights wt, float* __restrict__ parts, int n,
                   int c, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Layout l = pass1_layout(c, RES);
  const int b = blockIdx.y, tb = tile_bytes(c) / 2;
  const TileRange tr(blockIdx.x, splits, (n + kBM - 1) / kBM);
  const bf16* xb = x + (size_t)b * n * c;
  float* vs = reinterpret_cast<float*>(base + l.vec);
  bf16* w_s = reinterpret_cast<bf16*>(base + l.w);
  bf16* xbuf = reinterpret_cast<bf16*>(base + l.x);
  load_vectors(vs, wt.g_pre, wt.bout, wt.g_out, c);
  if (RES) load_slab<2>(w_s, WSlab{wt.wqkv, 3 * kF, kF, kF, 3 * kF}, 0, row_ld(c) - 8, c, vec);
  prefetch_tile(xbuf, xb, tr.t0, tr.t1, n, c, vec);
  WarpCtx st;
  st.init();
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    bf16* cur = xbuf + ((tile - tr.t0) & 1) * tb;
    prefetch_tile(xbuf + ((tile - tr.t0 + 1) & 1) * tb, xb, tile + 1, tr.t1, n, c, vec);
    cp_async_wait<1>();  // this tile (and the weights) have landed
    __syncthreads();
    const int rows = min(kBM, n - tile * kBM);
    norm_rows(cur, cur, row_ld(c), vs, rows, c);
    __syncthreads();
    pass1_tile<RES>(st, cur, rows, wt, c, w_s, reinterpret_cast<bf16*>(base + l.ring),
                    base + l.scratch, vec);
    __syncthreads();  // every warp is done with this buffer before it loads again
  }
  cp_async_wait<0>();
  write_record(st, parts + ((size_t)(b * splits + blockIdx.x) * 2 + Lane().wm) * kPart);
}

// Split route, the reduce: block (b, y) merges row b's 2 * splits records for
// its kThreads elements of ctx [B][F][D] bf16, one a thread.
__global__ void __launch_bounds__(kThreads)
split_reduce_kernel(const float* __restrict__ parts, bf16* __restrict__ ctx, int count) {
  const int b = blockIdx.x;
  bf16* cb = ctx + (size_t)b * kF * kD;
  merge_records(parts + (size_t)b * count * kPart, count, blockIdx.y * kThreads + threadIdx.x,
                kF * kD, [&](int i, float, float s, float a) {
                  cb[i] = __float2bfloat16(a / fmaxf(s, 1e-30f));
                });
}

// Split route, pass 2: block (z, b) writes y for the tiles of split z of row b.
template <int NC, bool RES>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks)
split_pass2_kernel(const bf16* __restrict__ x, Weights wt, const bf16* __restrict__ ctx,
                   bf16* __restrict__ y, int n, int c, int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Layout l = pass2_layout(c, RES);
  const int b = blockIdx.y, ld = row_ld(c), tb = tile_bytes(c) / 2;
  const TileRange tr(blockIdx.x, splits, (n + kBM - 1) / kBM);
  const bf16* xb = x + (size_t)b * n * c;
  bf16* wq_s = reinterpret_cast<bf16*>(base + l.w);
  bf16* wo_s = wq_s + (ld - 8) * (kBN + 8);
  bf16* xbuf = reinterpret_cast<bf16*>(base + l.x);
  bf16* xn = reinterpret_cast<bf16*>(base + l.xn);
  bf16* ctx_s = reinterpret_cast<bf16*>(base + l.ctx);
  float* vs = reinterpret_cast<float*>(base + l.vec);
  load_vectors(vs, wt.g_pre, wt.bout, wt.g_out, c);
  if (RES) {
    load_slab<1>(wq_s, WSlab{wt.wqkv, 3 * kF, 0, kBN, kF}, 0, ld - 8, c, vec);
    load_slab<1>(wo_s, WSlab{wt.wout, c, 0, kBN, c}, 0, kF, kF, vec);
  }
  prefetch_tile(xbuf, xb, tr.t0, tr.t1, n, c, vec);
  const bf16* cb = ctx + (size_t)b * kF * kD;
  for (int i = threadIdx.x; i < kF * kD; i += kThreads) ctx_s[(i / kD) * kCS + i % kD] = cb[i];
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    bf16* cur = xbuf + ((tile - tr.t0) & 1) * tb;
    prefetch_tile(xbuf + ((tile - tr.t0 + 1) & 1) * tb, xb, tile + 1, tr.t1, n, c, vec);
    cp_async_wait<1>();
    __syncthreads();
    const int rows = min(kBM, n - tile * kBM);
    norm_rows(xn, cur, ld, vs, rows, c);
    __syncthreads();
    pass2_tile<NC, RES>(cur, xn, wt, ctx_s, vs, y + ((size_t)b * n + tile * kBM) * c, rows, c, wq_s,
                        wo_s, reinterpret_cast<bf16*>(base + l.ring),
                        reinterpret_cast<bf16*>(base + l.ao),
                        reinterpret_cast<float*>(base + l.red), vec);
  }
  cp_async_wait<0>();
}

// Fused route: block b keeps row b's x in shared memory, folds all its tiles,
// merges its two records, then writes y tile by tile. The weights stream
// (NARROW: through the narrow ring, fused_layout).
template <int NC, bool NARROW>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const bf16* __restrict__ x, Weights wt, bf16* __restrict__ y, int n, int c,
             int vec) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Layout l = fused_layout(n, c, NARROW);
  const int b = blockIdx.x, tiles = (n + kBM - 1) / kBM, ld = row_ld(c);
  bf16* x_row = reinterpret_cast<bf16*>(base + l.x);
  bf16* xn = reinterpret_cast<bf16*>(base + l.xn);
  bf16* ring = reinterpret_cast<bf16*>(base + l.ring);
  bf16* ctx_s = reinterpret_cast<bf16*>(base + l.ctx);
  float* recs = reinterpret_cast<float*>(base + l.scratch);
  float* vs = reinterpret_cast<float*>(base + l.vec);
  load_vectors(vs, wt.g_pre, wt.bout, wt.g_out, c);
  load_rows(x_row, ld, x + (size_t)b * n * c, n, n, c, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  WarpCtx st;
  st.init();
  for (int tile = 0; tile < tiles; ++tile) {
    const int rows = min(kBM, n - tile * kBM);
    norm_rows(xn, x_row + tile * kBM * ld, ld, vs, rows, c);
    __syncthreads();
    pass1_tile<false, NARROW>(st, xn, rows, wt, c, nullptr, ring, base + l.scratch, vec);
  }
  __syncthreads();  // every warp's scratch is read: the records take its place
  write_record(st, recs + Lane().wm * kPart);
  __syncthreads();
  merge_records(recs, 2, threadIdx.x, kThreads, [&](int i, float, float s, float a) {
    ctx_s[(i / kD) * kCS + i % kD] = __float2bfloat16(a / fmaxf(s, 1e-30f));
  });
  __syncthreads();
  for (int tile = 0; tile < tiles; ++tile) {
    const int rows = min(kBM, n - tile * kBM);
    norm_rows(xn, x_row + tile * kBM * ld, ld, vs, rows, c);
    __syncthreads();
    pass2_tile<NC, false>(x_row + tile * kBM * ld, xn, wt, ctx_s, vs,
                          y + ((size_t)b * n + tile * kBM) * c, rows, c, nullptr, nullptr, ring,
                          reinterpret_cast<bf16*>(base + l.ao),
                          reinterpret_cast<float*>(base + l.red), vec);
  }
}

// ------------------------------------------------------------- the plan

constexpr int kRouteCores = 0, kRouteFused = 1, kRouteSplit = 2, kRouteNone = -1;

struct Plan {
  int route, splits;
  long long ws_bytes;
};

// The route of one call and its workspace, a function of its shape alone:
// the CUDA cores for f32 and for bf16 shapes the tensor-core routes do not
// take (H != 4, dim_head != 32, C > 512, or a shape whose blocks' shared
// memory would not fit, as C 512 past N 77; none on the path of the 64x64,
// 128x128 or 192x192 UNet at dim 64 and their dim_head, but UK64's N 16
// level at C 576), through an f32 qkv workspace.
Plan make_plan(int batch, int n, int c, int heads, int dim_head, int is_bf16) {
  Plan p{kRouteCores, 1, 0};
  if (batch < 1 || n < 1 || c < 1 || heads < 1 || dim_head < 1) return Plan{kRouteNone, 0, 0};
  const bool resident = c <= kBN;  // the split passes' weights (launch_bf16)
  const bool fused =
      n <= kFusedMaxN && fused_layout(n, c, fused_narrow(n, c)).total <= kMaxSmem;
  const bool split = pass1_layout(c, resident).total <= kMaxSmem &&
                     pass2_layout(c, resident).total <= kMaxSmem;
  if (!is_bf16 || heads != kHeads || dim_head != kD || c > kMaxC || !(fused || split)) {
    const long long f = (long long)heads * dim_head;
    p.ws_bytes = ((long long)batch * n * 3 * f + (long long)batch * f * dim_head) * 4;
    return p;
  }
  if (fused) {
    p.route = kRouteFused;
    return p;
  }
  // splits a row: as many as fill kSplitOcc blocks on each SM without a
  // second, part wave, at most one a tile
  const int tiles = (n + kBM - 1) / kBM;
  const long long want = (long long)kSplitOcc * kWave / batch;
  p.route = kRouteSplit;
  p.splits = (int)(want < 1 ? 1 : want > tiles ? tiles : want);
  p.ws_bytes = (long long)batch * p.splits * 2 * kPart * 4 + (long long)batch * kF * kD * 2;
  return p;
}

template <int NC, bool RES>
int launch_split(const Plan& p, const bf16* x, const Weights& wt, bf16* y, void* ws, int batch,
                 int n, int c, int vec, cudaStream_t stream) {
  float* parts = static_cast<float*>(ws);
  bf16* ctx = reinterpret_cast<bf16*>(parts + (size_t)batch * p.splits * 2 * kPart);
  int err = allow_smem<split_pass1_kernel<RES>>(kMaxSmem);
  if (!err) err = allow_smem<split_pass2_kernel<NC, RES>>(kMaxSmem);
  if (err) return err;
  const dim3 grid(p.splits, batch);
  split_pass1_kernel<RES><<<grid, kThreads, pass1_layout(c, RES).total, stream>>>(
      x, wt, parts, n, c, p.splits, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  split_reduce_kernel<<<dim3(batch, kF * kD / kThreads), kThreads, 0, stream>>>(
      parts, ctx, 2 * p.splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  split_pass2_kernel<NC, RES><<<grid, kThreads, pass2_layout(c, RES).total, stream>>>(
      x, wt, ctx, y, n, c, p.splits, vec);
  return (int)cudaGetLastError();
}

template <int NC, bool NARROW>
int launch_fused(const bf16* x, const Weights& wt, bf16* y, int batch, int n, int c, int vec,
                 cudaStream_t stream) {
  const int err = allow_smem<fused_kernel<NC, NARROW>>(kMaxSmem);
  if (err) return err;
  fused_kernel<NC, NARROW><<<batch, kThreads, fused_layout(n, c, NARROW).total, stream>>>(
      x, wt, y, n, c, vec);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bf16(const Plan& p, const bf16* x, const Weights& wt, bf16* y, void* ws, int batch,
                int n, int c, int vec, cudaStream_t stream) {
  if (p.route == kRouteFused) {
    if constexpr (NC == 4)
      if (fused_narrow(n, c)) return launch_fused<4, true>(x, wt, y, batch, n, c, vec, stream);
    return launch_fused<NC, false>(x, wt, y, batch, n, c, vec, stream);
  }
  // C <= 128 (one chunk): the split passes keep their weights resident
  return launch_split<NC, NC == 1>(p, x, wt, y, ws, batch, n, c, vec, stream);
}

// The CUDA-core route: three launches through the workspace.
template <typename T>
int launch_cores(const void* x, const void* g_pre, const void* wqkv, const void* wout,
                 const void* bout, const void* g_out, void* y, void* ws, int batch, int n_tok,
                 int c_dim, int heads, int dh, cudaStream_t stream) {
  const int f = heads * dh;
  float* qkv = static_cast<float*>(ws);
  float* ctx = qkv + (size_t)batch * n_tok * 3 * f;
  const dim3 tok_grid((n_tok + kTN - 1) / kTN, batch);
  const size_t smem_qkv = (size_t)c_dim * kTNP * sizeof(float);
  const size_t smem_ctx = (size_t)ctx_smem_floats(dh) * sizeof(float);
  const size_t smem_out =
      ((size_t)2 * f * kTNP + (size_t)f * dh + (size_t)kTN * c_dim) * sizeof(float);
  if (smem_qkv > (size_t)kMaxSmem || smem_ctx > (size_t)kMaxSmem || smem_out > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int err = allow_smem<qkv_kernel<T>>(kMaxSmem);
  if (!err) err = allow_smem<ctx_kernel>(kMaxSmem);
  if (!err) err = allow_smem<out_kernel<T>>(kMaxSmem);
  if (err) return err;
  qkv_kernel<T><<<tok_grid, kThreads, smem_qkv, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_pre), static_cast<const T*>(wqkv), qkv,
      n_tok, c_dim, 3 * f);
  err = (int)cudaGetLastError();
  if (err) return err;
  ctx_kernel<<<dim3(heads, batch), kThreads, smem_ctx, stream>>>(qkv, ctx, n_tok, f, dh);
  err = (int)cudaGetLastError();
  if (err) return err;
  out_kernel<T><<<tok_grid, kThreads, smem_out, stream>>>(
      static_cast<const T*>(x), qkv, ctx, static_cast<const T*>(wout),
      static_cast<const T*>(bout), static_cast<const T*>(g_out), static_cast<T*>(y), n_tok, c_dim,
      f, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of one call: writes the route (0 CUDA cores, 1 fused, 2 split,
// -1 an empty shape), the tokens of a tile and the splits per batch row to
// out[0..2] (if out is not null); returns the workspace bytes the call needs.
extern "C" long long ccdm_attn_block_plan(int batch, int n_tok, int c_dim, int heads, int dim_head,
                                          int is_bf16, int* out) {
  const Plan p = make_plan(batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (out) {
    out[0] = p.route;
    out[1] = p.route == kRouteCores ? kTN : kBM;
    out[2] = p.splits;
  }
  return p.ws_bytes;
}

// x, y [B, N, C] and the weights (g_pre [C], wqkv [C, 3F], wout [F, C],
// bout [C], g_out [C], F = heads dim_head) in one type, bf16 if is_bf16,
// else f32; ws the
// workspace of ws_bytes >= what ccdm_attn_block_plan returns. Launches on
// `stream` and returns the cudaError_t of the last launch check.
extern "C" int ccdm_attn_block_forward(const void* x, const void* g_pre, const void* wqkv,
                                       const void* wout, const void* bout, const void* g_out,
                                       void* y, void* ws, int batch, int n_tok, int c_dim,
                                       int heads, int dim_head, int is_bf16, long long ws_bytes,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (p.route == kRouteNone || ws_bytes < p.ws_bytes || (p.ws_bytes && !ws))
    return (int)cudaErrorInvalidValue;
  if (p.route == kRouteCores)
    return is_bf16 ? launch_cores<__nv_bfloat16>(x, g_pre, wqkv, wout, bout, g_out, y, ws, batch,
                                                 n_tok, c_dim, heads, dim_head, s)
                   : launch_cores<float>(x, g_pre, wqkv, wout, bout, g_out, y, ws, batch, n_tok,
                                         c_dim, heads, dim_head, s);
  const bf16* xb = static_cast<const bf16*>(x);
  const Weights wt{static_cast<const bf16*>(g_pre), static_cast<const bf16*>(wqkv),
                   static_cast<const bf16*>(wout), static_cast<const bf16*>(bout),
                   static_cast<const bf16*>(g_out)};
  bf16* yb = static_cast<bf16*>(y);
  const int vec = c_dim % 8 == 0 && aligned16(x) && aligned16(wqkv) && aligned16(wout) &&
                  aligned16(y);
  switch (chunks_of(c_dim)) {
    case 1: return launch_bf16<1>(p, xb, wt, yb, ws, batch, n_tok, c_dim, vec, s);
    case 2: return launch_bf16<2>(p, xb, wt, yb, ws, batch, n_tok, c_dim, vec, s);
    default: return launch_bf16<4>(p, xb, wt, yb, ws, batch, n_tok, c_dim, vec, s);
  }
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Two-pass attention block and its fused backward, for Hopper (sm_90a).
//
// Replaces four TPU kernels of ccdm_tpu/ops/attn_block.py, the training
// path of the block y = x + RMSNorm_gout(Wout . LA(Wqkv . RMSNorm_gpre(x)) + bout)
// at large N (N % 2048 == 0):
//   #2 _kernel_ctx_large  -> ccdm_attn_ctx_large: per batch, the k column
//      max kmax, s = colsum exp(k - kmax) and the per-head context
//      a_h = exp(k_h - kmax_h)^T v_h (D x D);
//   #3 _kernel_out_large  -> ccdm_attn_out_large: q softmax per head, . ctx,
//      . Wout + bout, out-norm, + x;
//   #4 _kernel_bwd_a      -> ccdm_attn_bwd_a: out-norm backward (do), d_ctx
//      per batch, dWout, dbout, dg_out;
//   #5 _kernel_bwd_b      -> ccdm_attn_bwd_b: q-softmax and column-softmax
//      backward, dWqkv, dg_pre, dx (+ dy).
// H heads of D channels (dim_head, F = H D). Norms, softmaxes and their
// backward run in f32; every product takes its
// operands rounded to the activation type (bf16 or f32) and accumulates in
// f32, where the TPU kernels feed their MXU (d_a of #5 is f32 there, and
// stays so here). Per-head sums are reduced per head directly (the TPU
// kernels' block-diagonal ones matmul was a Mosaic workaround); only the
// diagonal D x D blocks of ctx exist here.
//
// A TPU grid runs in order and carried its sums over N (a, s, d_ctx) and
// over the whole grid (the weight grads) in VMEM. Hopper blocks run in no
// order, so every sum across blocks is written as per-block partials and
// reduced by a second launch, in a fixed order (deterministic, no atomics):
//   - pass A: each block keeps a running column max of k and rescales its
//     a and s when it grows (as an online softmax does); a reduce (ctx_reduce
//     or ctx_merge) merges the blocks' (max, s, a) into the exact kmax and
//     a, s relative to it;
//   - the backward: per-block partials of d_ctx, dWout (tensor cores) and
//     the vectors, summed by sum_parts; dWqkv from xn and d_qkv written by
//     #5, through a split-K product (wgrad_tc_kernel, or wgrad_kernel on the
//     CUDA cores).
//
// What bounds them on this card (NVIDIA H100 SXM, 700 W, data-sheet peaks
// of 989 TFLOP/s bf16 and 3.35 TB/s): at the 64x64 training shape (B 128,
// N 4096, C 64, F 128) #2 moves ~69 MB and does ~21 GFLOP, #3 moves
// ~135 MB and does ~21 GFLOP, #4 ~270 MB and ~43 GFLOP, #5 ~340 MB and
// ~99 GFLOP: 0.02, 0.04, 0.08 and 0.10 ms by bytes, 0.02, 0.02, 0.04 and
// 0.10 ms by operations (chip_smoke.large_bound_parts). Only products on
// the tensor cores with few intermediates in device memory come near that.
// Routes of #2-#5 (make_large_plan, exported as ccdm_attn_large_plan; a
// function of the shape alone, never of a failure):
//   - tensor cores, for bf16 at 4 heads of 32 and C a multiple of 8 up to
//     128, padded to whole 32-column blocks in shared memory (every
//     two-pass shape of the 64x64, 128x128 and 192x192 UNets at dim 64, and
//     UK64's C 72 at dim 72, padded to 96): the sections "bf16 forward:
//     tensor cores" and "bf16 backward: tensor cores" below;
//   - CUDA cores, for f32 (the checks whose bounds TF32 would break) and
//     every other shape, at any D: the first design, every product as f32 FMAs from
//     shared memory in register tiles of 8 tokens, the weight products
//     through [B, N, *] operands in device memory and wgrad_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"
#include "common.cuh"
#include "attn_common.cuh"

namespace {

constexpr int kSmemTwoBlocks = 115712;  // per block, with two blocks on an SM

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Tokens [begin, end) of split `split` of N: a multiple of 32 each, so
// that every token tile (8, 16 or 32) but the last of N is full.
__device__ __forceinline__ void split_range(int split, int nsplit, int n_tok, int* begin,
                                            int* end) {
  int per = (n_tok + nsplit - 1) / nsplit;
  per = (per + 31) / 32 * 32;
  *begin = split * per;
  *end = *begin + per < n_tok ? *begin + per : n_tok;
}

// ---------------------------------------------------------------- tile steps
// A tile holds `tn` tokens (8, 16 or 32) from n0; `valid` of them are < N.
// Transposed tiles are [rows][tnp] with tnp = tn + 4 (float4-aligned rows).

// xn_t[c][i] = operand(RMSNorm_gpre(x[n0 + i])); optionally x in f32
// [tn][C] and the inverse norms. Tokens past N are zeros.
template <typename T>
__device__ void norm_tile(const T* __restrict__ xb, const float* __restrict__ g_pre, int n0,
                          int valid, int tn, int tnp, int c_dim, float* xn_t, float* xf_s,
                          float* inv_s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < tn; i += kWarps) {
    if (i < valid) {  // uniform across the warp
      const T* row = xb + (size_t)(n0 + i) * c_dim;
      float ss = 0.f;
      for (int c = lane; c < c_dim; c += 32) {
        const float v = to_f32(row[c]);
        ss = fmaf(v, v, ss);
      }
      const float inv = rsqrtf(warp_sum(ss) / (float)c_dim + 1e-12f);
      for (int c = lane; c < c_dim; c += 32) {
        const float v = to_f32(row[c]);
        xn_t[c * tnp + i] = as_operand<T>(v * inv * g_pre[c]);
        if (xf_s) xf_s[i * c_dim + c] = v;
      }
      if (inv_s && lane == 0) inv_s[i] = inv;
    } else {
      for (int c = lane; c < c_dim; c += 32) {
        xn_t[c * tnp + i] = 0.f;
        if (xf_s) xf_s[i * c_dim + c] = 0.f;
      }
      if (inv_s && lane == 0) inv_s[i] = 0.f;
    }
  }
}

// out_t[j][t] = sum_k in_t[k][t] * w[k * ld + col0 + j] for j < ncols
// (a token tile times a weight matrix read from device memory).
template <typename T>
__device__ void tile_times_w(const float* in_t, int k_dim, int tn, int tnp,
                             const T* __restrict__ w, int ld, int col0, int ncols,
                             float* out_t) {
  const int groups = tn / kTG;
  for (int task = threadIdx.x; task < ncols * groups; task += kThreads) {
    const int j = task % ncols;
    const int g = task / ncols;
    float acc[kTG] = {};
    const T* wcol = w + col0 + j;
    for (int k = 0; k < k_dim; ++k) fma8(acc, in_t + k * tnp + g * kTG, to_f32(wcol[(size_t)k * ld]));
#pragma unroll
    for (int t = 0; t < kTG; ++t) out_t[j * tnp + g * kTG + t] = acc[t];
  }
}

// out_t[j][t] = operand(sum_k in_t[k][t] * w[j * ld + k]): a token tile
// times the transpose of a weight matrix, rounded for the next product.
template <typename T>
__device__ void tile_times_wt(const float* in_t, int k_dim, int tn, int tnp,
                              const T* __restrict__ w, int ld, int ncols, float* out_t) {
  const int groups = tn / kTG;
  for (int task = threadIdx.x; task < ncols * groups; task += kThreads) {
    const int j = task % ncols;
    const int g = task / ncols;
    float acc[kTG] = {};
    const T* wrow = w + (size_t)j * ld;
    for (int k = 0; k < k_dim; ++k) fma8(acc, in_t + k * tnp + g * kTG, to_f32(wrow[k]));
#pragma unroll
    for (int t = 0; t < kTG; ++t) out_t[j * tnp + g * kTG + t] = as_operand<T>(acc[t]);
  }
}

// In place: q_t[h*D + d][i] <- operand(softmax_d(q[i, head h]) * D^-1/2),
// one warp per (token, head), its lanes striding the head's dh channels;
// tokens past N become zeros.
template <typename T>
__device__ void q_softmax_tile(float* q_t, int tn, int tnp, int valid, int heads, int dh) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)dh);
  for (int task = warp; task < tn * heads; task += kWarps) {
    const int i = task / heads;
    const int h = task % heads;
    float* col = q_t + h * dh * tnp + i;  // channel d at col[d * tnp]
    if (i < valid) {  // uniform across the warp
      float m = -INFINITY;
      for (int d = lane; d < dh; d += 32) m = fmaxf(m, col[d * tnp]);
      m = warp_max(m);
      float sum = 0.f;
      for (int d = lane; d < dh; d += 32) {
        const float e = expf(col[d * tnp] - m);
        col[d * tnp] = e;
        sum += e;
      }
      sum = fmaxf(warp_sum(sum), 1e-30f);
      for (int d = lane; d < dh; d += 32) col[d * tnp] = as_operand<T>(col[d * tnp] / sum * scale);
    } else {
      for (int d = lane; d < dh; d += 32) col[d * tnp] = 0.f;
    }
  }
}

// Per head h, a tile of F rows times a D x D matrix m ([F][D + 1], row
// h*D + r of head h; D = dh): out_t[h*D + o][t] = sum_i in_t[h*D + i][t] *
// M[i][o], with M[i][o] = m[(h*D + i) * (D + 1) + o], or its transpose if
// `transpose`; rounded to the operand type if `round_out`.
template <typename T>
__device__ void head_product(const float* in_t, const float* m, bool transpose, bool round_out,
                             int tn, int tnp, int f, int dh, float* out_t) {
  const int groups = tn / kTG;
  const int dp = dh + 1;
  for (int task = threadIdx.x; task < f * groups; task += kThreads) {
    const int col = task % f;
    const int g = task / f;
    const int h = col / dh;
    const int o = col % dh;
    float acc[kTG] = {};
    const float* mh = m + h * dh * dp;
    const float* ih = in_t + h * dh * tnp + g * kTG;
    for (int i = 0; i < dh; ++i)
      fma8(acc, ih + i * tnp, transpose ? mh[o * dp + i] : mh[i * dp + o]);
#pragma unroll
    for (int t = 0; t < kTG; ++t)
      out_t[col * tnp + g * kTG + t] = round_out ? as_operand<T>(acc[t]) : acc[t];
  }
}

// a_t[h*D + e][t] = operand(sum_d qs_t[h*D + d][t] * ctx[h][d][e]).
template <typename T>
__device__ void attn_out_tile(const float* qs_t, const float* ctx_s, int tn, int tnp, int f,
                              int dh, float* a_t) {
  head_product<T>(qs_t, ctx_s, false, true, tn, tnp, f, dh, a_t);
}

// o_s[t][c] = sum_f a_t[f][t] * wout[f][c] + bout[c], f32.
template <typename T>
__device__ void out_proj_tile(const float* a_t, const T* __restrict__ wout,
                              const float* __restrict__ bout, int tn, int tnp, int f, int c_dim,
                              float* o_s) {
  const int groups = tn / kTG;
  for (int task = threadIdx.x; task < c_dim * groups; task += kThreads) {
    const int c = task % c_dim;
    const int g = task / c_dim;
    float acc[kTG] = {};
    for (int ff = 0; ff < f; ++ff) fma8(acc, a_t + ff * tnp + g * kTG, to_f32(wout[(size_t)ff * c_dim + c]));
    const float bias = bout[c];
#pragma unroll
    for (int t = 0; t < kTG; ++t) o_s[(g * kTG + t) * c_dim + c] = acc[t] + bias;
  }
}

// ctx_s[f * (dh + 1) + e] = ctx[b][f][e] in f32 (ctx is already in operand type).
template <typename T>
__device__ void load_ctx(const T* __restrict__ ctxb, int f, int dh, float* ctx_s) {
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads)
    ctx_s[(idx / dh) * (dh + 1) + idx % dh] = to_f32(ctxb[idx]);
}

// ------------------------------------------------------------ #2: pass A
// Per (split, batch): over the split's tokens, a running column max m of k,
// s = sum exp(k - m) and a_h = exp(k_h - m_h)^T v_h, rescaled whenever m
// grows. Shared: xn_t [C][tnp], kv_t [2F][tnp], m_s, scale_s, s_s [F],
// a_s [F][D].
template <typename T>
__global__ void __launch_bounds__(kThreads)
ctx_partial_kernel(const T* __restrict__ x, const float* __restrict__ g_pre,
                   const T* __restrict__ wqkv, float* __restrict__ m_part,
                   float* __restrict__ s_part, float* __restrict__ a_part, int n_tok, int c_dim,
                   int f, int dh, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  float* xn_t = smem;
  float* kv_t = xn_t + align4(c_dim * tnp);
  float* m_s = kv_t + 2 * f * tnp;
  float* scale_s = m_s + f;
  float* s_s = scale_s + f;
  float* a_s = s_s + f;
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int part = b * gridDim.x + split;
  const T* xb = x + (size_t)b * n_tok * c_dim;
  int begin, end;
  split_range(split, gridDim.x, n_tok, &begin, &end);

  for (int j = threadIdx.x; j < f; j += kThreads) {
    m_s[j] = -INFINITY;
    s_s[j] = 0.f;
  }
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) a_s[idx] = 0.f;
  __syncthreads();

  for (int n0 = begin; n0 < end; n0 += tn) {
    const int valid = end - n0 < tn ? end - n0 : tn;
    norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, nullptr, nullptr);
    __syncthreads();
    tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, 3 * f, f, 2 * f, kv_t);  // k and v
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * f; j += kThreads) {
      float* row = kv_t + j * tnp;
      if (j < f) {  // k column: new max, rescale factor, exp and column sum
        float mx = -INFINITY;
        for (int t = 0; t < valid; ++t) mx = fmaxf(mx, row[t]);
        const float m_old = m_s[j];
        const float m_new = fmaxf(m_old, mx);
        const float sc = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        float s = 0.f;
        for (int t = 0; t < tn; ++t) {
          const float e = t < valid ? expf(row[t] - m_new) : 0.f;
          s += e;
          row[t] = as_operand<T>(e);
        }
        m_s[j] = m_new;
        scale_s[j] = sc;
        s_s[j] = s_s[j] * sc + s;
      } else {  // v column: operand rounding, zeros past N
        for (int t = 0; t < tn; ++t) row[t] = t < valid ? as_operand<T>(row[t]) : 0.f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) {
      const int r = idx / dh;  // k channel h*D + d
      const int e = idx % dh;
      const float* ek = kv_t + r * tnp;
      const float* vv = kv_t + (f + (r / dh) * dh + e) * tnp;
      float acc = a_s[idx] * scale_s[r];
      for (int t = 0; t < tn; ++t) acc = fmaf(ek[t], vv[t], acc);
      a_s[idx] = acc;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < f; j += kThreads) {
    m_part[(size_t)part * f + j] = m_s[j];
    s_part[(size_t)part * f + j] = s_s[j];
  }
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads)
    a_part[(size_t)part * f * dh + idx] = a_s[idx];
}

// Per batch: kmax = max of the splits' maxima; s and a summed in split
// order, each split's share rescaled to kmax. Shared: kmax [F].
__global__ void __launch_bounds__(kThreads)
ctx_reduce_kernel(const float* __restrict__ m_part, const float* __restrict__ s_part,
                  const float* __restrict__ a_part, float* __restrict__ kmax,
                  float* __restrict__ s, float* __restrict__ a, int nsplit, int f, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const float* mb = m_part + (size_t)b * nsplit * f;
  const float* sb = s_part + (size_t)b * nsplit * f;
  const float* ab = a_part + (size_t)b * nsplit * f * dh;
  for (int j = threadIdx.x; j < f; j += kThreads) {
    float m = -INFINITY;
    for (int p = 0; p < nsplit; ++p) m = fmaxf(m, mb[p * f + j]);
    float acc = 0.f;
    for (int p = 0; p < nsplit; ++p)
      if (mb[p * f + j] > -INFINITY) acc += sb[p * f + j] * expf(mb[p * f + j] - m);
    smem[j] = m;
    kmax[(size_t)b * f + j] = m;
    s[(size_t)b * f + j] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) {
    const int r = idx / dh;
    float acc = 0.f;
    for (int p = 0; p < nsplit; ++p) {
      const float mp = mb[p * f + r];
      if (mp > -INFINITY) acc += ab[(size_t)p * f * dh + idx] * expf(mp - smem[r]);
    }
    a[(size_t)b * f * dh + idx] = acc;
  }
}

// ------------------------------------------------------------ #3: pass B
// Per (token tile, batch): q projection, q softmax, . ctx, . Wout + bout,
// out-norm and the residual. Shared: xn_t [C][tnp], q_t [F][tnp],
// ctx_s [F][D + 1], a_t [F][tnp], o_s [tn][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
out_large_kernel(const T* __restrict__ x, const float* __restrict__ g_pre,
                 const T* __restrict__ wqkv, const T* __restrict__ ctx,
                 const T* __restrict__ wout, const float* __restrict__ bout,
                 const float* __restrict__ g_out, T* __restrict__ y, int n_tok, int c_dim, int f,
                 int dh, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  float* xn_t = smem;
  float* q_t = xn_t + align4(c_dim * tnp);
  float* ctx_s = q_t + f * tnp;
  float* a_t = ctx_s + f * (dh + 1);
  float* o_s = a_t + f * tnp;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tn;
  const int valid = n_tok - n0 < tn ? n_tok - n0 : tn;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xb = x + (size_t)b * n_tok * c_dim;

  norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, nullptr, nullptr);
  load_ctx<T>(ctx + (size_t)b * f * dh, f, dh, ctx_s);
  __syncthreads();
  tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, 3 * f, 0, f, q_t);
  __syncthreads();
  q_softmax_tile<T>(q_t, tn, tnp, valid, f / dh, dh);
  __syncthreads();
  attn_out_tile<T>(q_t, ctx_s, tn, tnp, f, dh, a_t);
  __syncthreads();
  out_proj_tile<T>(a_t, wout, bout, tn, tnp, f, c_dim, o_s);
  __syncthreads();
  for (int i = warp; i < valid; i += kWarps) {
    const float* orow = o_s + i * c_dim;
    float ss = 0.f;
    for (int c = lane; c < c_dim; c += 32) ss = fmaf(orow[c], orow[c], ss);
    const float inv = rsqrtf(warp_sum(ss) / (float)c_dim + 1e-12f);
    const size_t off = ((size_t)b * n_tok + n0 + i) * c_dim;
    for (int c = lane; c < c_dim; c += 32)
      y[off + c] = from_f32<T>(to_f32(x[off + c]) + orow[c] * inv * g_out[c]);
  }
}

// ---------------------------------------------------------- #4: backward A
// Per (split, batch), over the split's tokens: recompute q', out and o;
// do = out-norm backward of dy (written in f32); out (operand) written for
// the dWout product; d_ctx, dbout and dg_out summed per block.
// Shared: xn_t [C][tnp] (then do, operand), q_t [F][tnp], ctx_s [F][D + 1],
// a_t [F][tnp], o_s [tn][C] (then do, f32), dyon_s [tn][C],
// dout_t [F][tnp], dctx_s [F][D], db_s, dg_s [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_a_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ g_pre,
             const T* __restrict__ wqkv, const T* __restrict__ ctx, const T* __restrict__ wout,
             const float* __restrict__ bout, const float* __restrict__ g_out,
             float* __restrict__ do_g, T* __restrict__ out_g, float* __restrict__ dctx_part,
             float* __restrict__ db_part, float* __restrict__ dg_part, int n_tok, int c_dim,
             int f, int dh, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  float* xn_t = smem;
  float* q_t = xn_t + align4(c_dim * tnp);
  float* ctx_s = q_t + f * tnp;
  float* a_t = ctx_s + f * (dh + 1);
  float* o_s = a_t + f * tnp;
  float* dyon_s = o_s + align4(tn * c_dim);
  float* dout_t = dyon_s + align4(tn * c_dim);
  float* dctx_s = dout_t + f * tnp;
  float* db_s = dctx_s + f * dh;
  float* dg_s = db_s + align4(c_dim);
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int part = b * gridDim.x + split;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xb = x + (size_t)b * n_tok * c_dim;
  int begin, end;
  split_range(split, gridDim.x, n_tok, &begin, &end);

  load_ctx<T>(ctx + (size_t)b * f * dh, f, dh, ctx_s);
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) dctx_s[idx] = 0.f;
  for (int c = threadIdx.x; c < c_dim; c += kThreads) db_s[c] = dg_s[c] = 0.f;
  __syncthreads();

  for (int n0 = begin; n0 < end; n0 += tn) {
    const int valid = end - n0 < tn ? end - n0 : tn;
    norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, nullptr, nullptr);
    __syncthreads();
    tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, 3 * f, 0, f, q_t);
    __syncthreads();
    q_softmax_tile<T>(q_t, tn, tnp, valid, f / dh, dh);
    __syncthreads();
    attn_out_tile<T>(q_t, ctx_s, tn, tnp, f, dh, a_t);
    __syncthreads();
    out_proj_tile<T>(a_t, wout, bout, tn, tnp, f, c_dim, o_s);
    for (int idx = threadIdx.x; idx < f * valid; idx += kThreads) {
      const int t = idx / f;
      const int col = idx % f;
      out_g[((size_t)b * n_tok + n0 + t) * f + col] = from_f32<T>(a_t[col * tnp + t]);
    }
    __syncthreads();
    // out-norm backward, one warp per token
    for (int i = warp; i < tn; i += kWarps) {
      float* orow = o_s + i * c_dim;
      float* yrow = dyon_s + i * c_dim;
      if (i < valid) {  // uniform across the warp
        const size_t off = ((size_t)b * n_tok + n0 + i) * c_dim;
        float ss = 0.f;
        float dot = 0.f;
        for (int c = lane; c < c_dim; c += 32) {
          const float o = orow[c];
          ss = fmaf(o, o, ss);
          dot = fmaf(o, to_f32(dy[off + c]) * g_out[c], dot);
        }
        const float r2 = rsqrtf(warp_sum(ss) / (float)c_dim + 1e-12f);
        dot = warp_sum(dot) / (float)c_dim;
        for (int c = lane; c < c_dim; c += 32) {
          const float o = orow[c];
          const float dyv = to_f32(dy[off + c]);
          const float d = r2 * dyv * g_out[c] - o * (r2 * r2 * r2) * dot;
          do_g[off + c] = d;
          xn_t[c * tnp + i] = as_operand<T>(d);
          yrow[c] = dyv * o * r2;
          orow[c] = d;
        }
      } else {
        for (int c = lane; c < c_dim; c += 32) {
          xn_t[c * tnp + i] = 0.f;
          yrow[c] = 0.f;
          orow[c] = 0.f;
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < c_dim; c += kThreads) {
      float db = 0.f, dg = 0.f;
      for (int t = 0; t < tn; ++t) {
        db += o_s[t * c_dim + c];
        dg += dyon_s[t * c_dim + c];
      }
      db_s[c] += db;
      dg_s[c] += dg;
    }
    tile_times_wt<T>(xn_t, c_dim, tn, tnp, wout, c_dim, f, dout_t);  // d_out = do . Wout^T
    __syncthreads();
    // d_ctx[h][d][e] += sum_t q'[t][h*D + d] * d_out[t][h*D + e] (operands)
    for (int idx = threadIdx.x; idx < f * dh; idx += kThreads) {
      const int r = idx / dh;
      const float* qr = q_t + r * tnp;
      const float* dr = dout_t + ((r / dh) * dh + idx % dh) * tnp;
      float acc = dctx_s[idx];
      for (int t = 0; t < tn; ++t) acc = fmaf(qr[t], dr[t], acc);
      dctx_s[idx] = acc;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads)
    dctx_part[(size_t)part * f * dh + idx] = dctx_s[idx];
  for (int c = threadIdx.x; c < c_dim; c += kThreads) {
    db_part[(size_t)part * c_dim + c] = db_s[c];
    dg_part[(size_t)part * c_dim + c] = dg_s[c];
  }
}

// ---------------------------------------------------------- #5: backward B
// Per (split, batch), over the split's tokens: recompute qkv; d_out from
// do; q-softmax backward d_q = p (d_p - sum_h d_p p); column-softmax
// backward d_k = e (v . d_a^T + d_s), d_v = e . d_a with e = exp(k - kmax);
// d_xn = d_qkv . Wqkv^T, prenorm backward, dx = dy + ...; xn and d_qkv
// (operands) written for the dWqkv product; dg_pre summed per block.
// The per-head products (d_qs, d_e, d_v) run as token-tile products like
// the projections; only the softmax backward is per (token, head).
// Shared: xn_t [C][tnp] (then do, operand), xf_s [tn][C], inv_s [tn],
// qkv_t [3F][tnp] (then d_qkv in place), dout_t [F][tnp] (then e, operand),
// x_t (d_qs) and y_t (d_e, then d_k) [F][tnp], ctx_s and da_s [F][D + 1],
// kmax_s and ds_s [F], dxn_s [tn][C], dg_s [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_b_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ do_g,
             const float* __restrict__ g_pre, const T* __restrict__ wqkv,
             const T* __restrict__ ctx, const T* __restrict__ wout,
             const float* __restrict__ kmax, const float* __restrict__ d_a,
             const float* __restrict__ d_s, T* __restrict__ dx, T* __restrict__ xn_g,
             T* __restrict__ dqkv_g, float* __restrict__ dg_part, int n_tok, int c_dim, int f,
             int dh, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  const int f3 = 3 * f;
  const int heads = f / dh;
  const int dp = dh + 1;
  float* xn_t = smem;
  float* xf_s = xn_t + align4(c_dim * tnp);
  float* inv_s = xf_s + align4(tn * c_dim);
  float* qkv_t = inv_s + tn;
  float* dout_t = qkv_t + f3 * tnp;
  float* x_t = dout_t + f * tnp;
  float* y_t = x_t + f * tnp;
  float* ctx_s = y_t + f * tnp;
  float* da_s = ctx_s + f * dp;
  float* kmax_s = da_s + f * dp;
  float* ds_s = kmax_s + f;
  float* dxn_s = ds_s + f;
  float* dg_s = dxn_s + align4(tn * c_dim);
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int part = b * gridDim.x + split;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)dh);
  const T* xb = x + (size_t)b * n_tok * c_dim;
  int begin, end;
  split_range(split, gridDim.x, n_tok, &begin, &end);

  load_ctx<T>(ctx + (size_t)b * f * dh, f, dh, ctx_s);
  for (int idx = threadIdx.x; idx < f * dh; idx += kThreads)
    da_s[(idx / dh) * dp + idx % dh] = d_a[(size_t)b * f * dh + idx];
  for (int j = threadIdx.x; j < f; j += kThreads) {
    kmax_s[j] = kmax[(size_t)b * f + j];
    ds_s[j] = d_s[(size_t)b * f + j];
  }
  for (int c = threadIdx.x; c < c_dim; c += kThreads) dg_s[c] = 0.f;
  __syncthreads();

  for (int n0 = begin; n0 < end; n0 += tn) {
    const int valid = end - n0 < tn ? end - n0 : tn;
    norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, xf_s, inv_s);
    __syncthreads();
    for (int idx = threadIdx.x; idx < c_dim * valid; idx += kThreads) {
      const int t = idx / c_dim;
      const int c = idx % c_dim;
      xn_g[((size_t)b * n_tok + n0 + t) * c_dim + c] = from_f32<T>(xn_t[c * tnp + t]);
    }
    tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, f3, 0, f3, qkv_t);
    __syncthreads();
    for (int idx = threadIdx.x; idx < c_dim * tn; idx += kThreads) {
      const int t = idx / c_dim;
      const int c = idx % c_dim;
      xn_t[c * tnp + t] =
          t < valid ? as_operand<T>(do_g[((size_t)b * n_tok + n0 + t) * c_dim + c]) : 0.f;
    }
    __syncthreads();
    tile_times_wt<T>(xn_t, c_dim, tn, tnp, wout, c_dim, f, dout_t);  // d_out = do . Wout^T
    // k rows <- e = exp(k - kmax) (f32), v rows <- operand(v); zeros past N
    for (int idx = threadIdx.x; idx < f * tn; idx += kThreads) {
      const int j = idx / tn;
      const int t = idx % tn;
      float* kc = qkv_t + (f + j) * tnp + t;
      float* vc = qkv_t + (2 * f + j) * tnp + t;
      *kc = t < valid ? expf(*kc - kmax_s[j]) : 0.f;
      *vc = t < valid ? as_operand<T>(*vc) : 0.f;
    }
    __syncthreads();
    // x_t = d_qs = d_out . ctx_h^T; y_t = v . d_a_h^T (d_e without d_s)
    head_product<T>(dout_t, ctx_s, true, false, tn, tnp, f, dh, x_t);
    head_product<T>(qkv_t + 2 * f * tnp, da_s, true, false, tn, tnp, f, dh, y_t);
    __syncthreads();
    // q rows <- operand(d_q), d_q = p (d_p - sum_h d_p p), d_p = d_qs D^-1/2,
    // p = softmax of the head's q: one thread per (token, head)
    for (int task = threadIdx.x; task < tn * heads; task += kThreads) {
      const int t = task % tn;
      float* q = qkv_t + (task / tn) * dh * tnp + t;
      const float* dqs = x_t + (task / tn) * dh * tnp + t;
      if (t < valid) {
        float mx = -INFINITY;
        for (int d = 0; d < dh; ++d) mx = fmaxf(mx, q[d * tnp]);
        float sum = 0.f;
        for (int d = 0; d < dh; ++d) {
          q[d * tnp] = expf(q[d * tnp] - mx);
          sum += q[d * tnp];
        }
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        float pg = 0.f;
        for (int d = 0; d < dh; ++d) {
          q[d * tnp] *= inv;
          pg = fmaf(dqs[d * tnp] * scale, q[d * tnp], pg);
        }
        for (int d = 0; d < dh; ++d)
          q[d * tnp] = as_operand<T>(q[d * tnp] * (dqs[d * tnp] * scale - pg));
      } else {
        for (int d = 0; d < dh; ++d) q[d * tnp] = 0.f;
      }
    }
    // y_t <- operand(d_k), d_k = e (d_e + d_s); dout_t <- operand(e)
    for (int idx = threadIdx.x; idx < f * tn; idx += kThreads) {
      const int j = idx / tn;
      const int t = idx % tn;
      const float e = qkv_t[(f + j) * tnp + t];
      y_t[j * tnp + t] = as_operand<T>(e * (y_t[j * tnp + t] + ds_s[j]));
      dout_t[j * tnp + t] = as_operand<T>(e);
    }
    __syncthreads();
    // v rows <- operand(d_v), d_v = e . d_a_h; k rows <- d_k
    head_product<T>(dout_t, da_s, false, true, tn, tnp, f, dh, qkv_t + 2 * f * tnp);
    for (int idx = threadIdx.x; idx < f * tn; idx += kThreads) {
      const int j = idx / tn;
      const int t = idx % tn;
      qkv_t[(f + j) * tnp + t] = y_t[j * tnp + t];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < f3 * valid; idx += kThreads) {
      const int t = idx / f3;
      const int j = idx % f3;
      dqkv_g[((size_t)b * n_tok + n0 + t) * f3 + j] = from_f32<T>(qkv_t[j * tnp + t]);
    }
    // d_xn[t][c] = sum_j d_qkv[t][j] wqkv[c][j]
    {
      const int groups = tn / kTG;
      for (int task = threadIdx.x; task < c_dim * groups; task += kThreads) {
        const int c = task % c_dim;
        const int g = task / c_dim;
        float acc[kTG] = {};
        const T* wrow = wqkv + (size_t)c * f3;
        for (int j = 0; j < f3; ++j) fma8(acc, qkv_t + j * tnp + g * kTG, to_f32(wrow[j]));
#pragma unroll
        for (int t = 0; t < kTG; ++t) dxn_s[(g * kTG + t) * c_dim + c] = acc[t];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < c_dim; c += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < valid; ++t)
        acc = fmaf(dxn_s[t * c_dim + c], xf_s[t * c_dim + c] * inv_s[t], acc);
      dg_s[c] += acc;
    }
    // prenorm backward and the residual, one warp per token
    for (int i = warp; i < valid; i += kWarps) {
      const float inv = inv_s[i];
      const float* xr = xf_s + i * c_dim;
      const float* dr = dxn_s + i * c_dim;
      float dot = 0.f;
      for (int c = lane; c < c_dim; c += 32) dot = fmaf(xr[c], dr[c] * g_pre[c], dot);
      dot = warp_sum(dot) / (float)c_dim;
      const size_t off = ((size_t)b * n_tok + n0 + i) * c_dim;
      for (int c = lane; c < c_dim; c += 32) {
        const float d = inv * dr[c] * g_pre[c] - xr[c] * (inv * inv * inv) * dot;
        dx[off + c] = from_f32<T>(to_f32(dy[off + c]) + d);
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < c_dim; c += kThreads) dg_part[(size_t)part * c_dim + c] = dg_s[c];
}

// ------------------------------ the weight products (CUDA-core route)
// part[p][i][j] = sum over tokens t of split p of op(A[t][i]) op(B[t][j]),
// A [M, I] and B [M, J] in device memory, op = rounding to T. Per block a
// 64 x 64 tile of the output, 4 x 4 per thread, 32 tokens per step.
constexpr int kWT = 64;
constexpr int kWK = 32;

template <typename T, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ part,
             int m, int i_dim, int j_dim) {
  __shared__ __align__(16) float a_s[kWK][kWT];
  __shared__ __align__(16) float b_s[kWK][kWT];
  const int i0 = blockIdx.x * kWT;
  const int j0 = blockIdx.y * kWT;
  const int p = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  int per = (m + gridDim.z - 1) / gridDim.z;
  per = (per + kWK - 1) / kWK * kWK;
  const int begin = p * per;
  const int end = begin + per < m ? begin + per : m;
  float acc[4][4] = {};
  for (int t0 = begin; t0 < end; t0 += kWK) {
    for (int idx = threadIdx.x; idx < kWK * kWT; idx += kThreads) {
      const int t = idx / kWT;
      const int c = idx % kWT;
      const bool in_t = t0 + t < end;
      a_s[t][c] = in_t && i0 + c < i_dim
                      ? as_operand<T>(to_f32(A[(size_t)(t0 + t) * i_dim + i0 + c])) : 0.f;
      b_s[t][c] = in_t && j0 + c < j_dim
                      ? as_operand<T>(to_f32(B[(size_t)(t0 + t) * j_dim + j0 + c])) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < kWK; ++t) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[t][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[t][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(ar[r], br[s], acc[r][s]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)p * i_dim * j_dim;
  for (int r = 0; r < 4; ++r)
    for (int s = 0; s < 4; ++s) {
      const int i = i0 + ty * 4 + r;
      const int j = j0 + tx * 4 + s;
      if (i < i_dim && j < j_dim) out[(size_t)i * j_dim + j] = acc[r][s];
    }
}

// out[o][k] = sum_p part[o][p][k], p in order.
__global__ void __launch_bounds__(kThreads)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out, int outer, int nparts,
                 int len) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)outer * len) return;
  const size_t o = idx / len;
  const size_t k = idx % len;
  const float* src = part + o * nparts * len + k;
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p) acc += src[(size_t)p * len];
  out[idx] = acc;
}


// ----------------------------------------- bf16 backward: tensor cores
// #4 and #5 in bf16 at 4 heads and C a multiple of 8 up to 128 (every
// two-pass shape of the 64x64, 128x128 and 192x192 UNets; C 72 of UK64's
// dim 72). Every product runs as mma.sync m16n8k16 (bf16 operands, f32
// sums) from ldmatrix; the norms, softmaxes and their backward run in f32
// on the accumulators. In shared memory C is padded to whole 32-column
// accumulator blocks (pad32: 72 -> 96): the x, xn and do tiles, Wq's and
// Wqkv's rows, Wout's columns and the vectors are zero past C (copy_rows
// zero-fills them), so every product and every sum of squares over the
// padding adds exact zeros; the norms divide by the true C, the products
// over C skip the K slices past it, and nothing past C is stored.
// A block has 8 warps and walks 128-token tiles; a warp owns 16 rows of a
// tile across its whole width, so that every sum over a row (the norms, a
// head's softmax, the out-norm's backward) stays inside a quad of lanes.
// The weights and the batch row's ctx (and d_a) stay in shared memory.
//   - #4: per head, q = xn . Wq, q' = softmax(q) D^-1/2, out = q' . ctx_h;
//     o = out . Wout + bout; do (f32, written) from the out-norm's
//     backward; d_out = do . Wout^T. The sums over the tokens, d_ctx +=
//     q'^T . d_out and dWout += out^T . do, take the tile's q', out, do and
//     d_out from shared memory (ldmatrix .trans: the tokens are the
//     contracted axis) into accumulators that each warp keeps in registers
//     for the whole split (a part of the output each). Each block writes one
//     f32 partial of d_ctx, dWout, dbout and dg_out; sum_parts reduces them
//     in a fixed order. No [B, N, F] tensor reaches device memory.
//   - #5: per head, d_out = do . Wout^T (rounded), d_p = d_out . ctx_h^T,
//     q and its softmax's backward d_q; v and d_e = v . d_a_h^T; k, e =
//     exp(k - kmax), d_k = e (d_e + d_s); d_v = e . d_a_h; each d_q, d_k,
//     d_v rounded and at once folded into d_xn += d_qkv . Wqkv^T; then the
//     pre-norm's backward and dx = dy + ... . d_a is f32 (XLA's finalize):
//     d_e and d_v take it as two bf16 operands, hi = bf16(d_a) and lo =
//     bf16(d_a - hi), two products each, which keeps it to ~2^-17 where one
//     bf16 operand would round it at 2^-9. A warp's x rows load for the next
//     tile while it finishes this one. dWqkv += xn^T . d_qkv is a
//     [C, 3F] sum over all tokens: 96 to 192 f32 a thread, more than the
//     registers or the shared memory hold beside the rest, so #5 writes xn
//     and d_qkv in bf16 and wgrad_tc_kernel, a split-K product on the
//     tensor cores (64 x 128 output tiles, a 3-stage cp.async ring of
//     32-token slices), sums them; sum_parts reduces its splits in order.

constexpr int kTM = kWarps * 16;      // tokens per tile: 16 rows a warp
constexpr int kMaxC = 128;            // widest C of the tensor-core route
constexpr int kWgradBlocks = 264;     // blocks a dWqkv launch aims at
constexpr int kLF = kF + 8;           // bf16 per row of a [tokens][F] tile
constexpr int kLW = 3 * kF + 8;       // bf16 per row of Wqkv [C][3F] in shared memory
constexpr int kLH = kD + 8;           // bf16 per row of ctx and d_a [F][D]
constexpr int kGI = 64, kGJ = 128, kGK = 32, kGStages = 3;  // wgrad_tc_kernel's tiles and ring
constexpr int kGLA = kGI + 8, kGLB = kGJ + 8;
constexpr int kGStage = kGK * (kGLA + kGLB);  // bf16 of one ring stage
static_assert(kThreads == 256 && kTM == 128, "8 warps of 16 rows");

// bf16 per row of a [tokens][C] tile.
__host__ __device__ constexpr int ldc(int c) { return c + 8; }
// C rounded up to whole 32-column accumulator blocks: #4's and #5's width
// in shared memory.
__host__ __device__ constexpr int pad32(int c) { return (c + 31) / 32 * 32; }

// Byte offsets of #4's shared memory: Wq [C][kLF], Wout [F][C + 8], ctx
// [F][kLH], g_pre, bout, g_out [3][C] f32, the x tile (then xn, then do in
// bf16) [kTM][C + 8], q', out and d_out [kTM][kLF], and each warp's sums of
// do and dy o r2 per channel [8][2][C] f32.
struct BwdALayout {
  int wq, wo, ctx, vec, xn, qs, out, dout, red, total;
};
__host__ __device__ inline BwdALayout bwd_a_layout(int c) {
  BwdALayout l{};
  l.wo = c * kLF * 2;
  l.ctx = l.wo + kF * ldc(c) * 2;
  l.vec = l.ctx + kF * kLH * 2;
  l.xn = l.vec + 3 * c * 4;
  l.qs = l.xn + kTM * ldc(c) * 2;
  l.out = l.qs + kTM * kLF * 2;
  l.dout = l.out + kTM * kLF * 2;
  l.red = l.dout + kTM * kLF * 2;
  l.total = l.red + kWarps * 2 * c * 4;
  return l;
}

// #5's: Wqkv [C][kLW], Wout [F][C + 8], ctx, d_a's hi and lo [F][kLH],
// kmax, d_s [F] and g_pre [C] f32, the x tile (then xn) [kTM][C + 8], each
// row's 1 / rms [kTM] and each warp's sums of d_xn x / rms [8][C] f32.
struct BwdBLayout {
  int w, wo, ctx, dah, dal, vec, xn, inv, red, total;
};
__host__ __device__ inline BwdBLayout bwd_b_layout(int c) {
  BwdBLayout l{};
  l.wo = c * kLW * 2;
  l.ctx = l.wo + kF * ldc(c) * 2;
  l.dah = l.ctx + kF * kLH * 2;
  l.dal = l.dah + kF * kLH * 2;
  l.vec = l.dal + kF * kLH * 2;
  l.xn = l.vec + (2 * kF + c) * 4;
  l.inv = l.xn + kTM * ldc(c) * 2;
  l.red = l.inv + kTM * 4;
  l.total = l.red + kWarps * c * 4;
  return l;
}

// Where this thread's elements lie in its warp's 16 x 32 accumulator
// Acc[ni][e]: row g + 8 (e / 2), column 8 ni + 2 t + e % 2.
struct Quad {
  int lane, g, t, w;
  __device__ Quad() {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    w = threadIdx.x >> 5;
  }
};
typedef float Acc[4][4];

// Sum over the 8 lanes of a column of quads (the 16 rows of a warp's block).
__device__ __forceinline__ float column_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// B fragments of a 16 (k) x 32 (n) block at b, n8 tiles 2 nj and 2 nj + 1
// in bfr[nj]: stored [k][n] (b_kn, ldmatrix .trans) or [n][k] (b_nk).
__device__ __forceinline__ void b_kn(uint32_t (&bfr)[2][4], const bf16* b, int ld, int lane) {
  b_kn16(bfr[0], b, ld, lane);
  b_kn16(bfr[1], b + 16, ld, lane);
}
__device__ __forceinline__ void b_nk(uint32_t (&bfr)[2][4], const bf16* b, int ld, int lane) {
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
    ldmatrix_x4(bfr[nj], b + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
}

// acc += A . B for a 16 x 16 A fragment and a 16 x 32 B block.
__device__ __forceinline__ void mma_n32(Acc& acc, const uint32_t (&a)[4],
                                        const uint32_t (&bfr)[2][4]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const uint32_t b[2] = {bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]};
    mma_16816(acc[ni], a, b);
  }
}

// The A fragments (two k16 steps) of a 16 x 32 accumulator, rounded to bf16.
__device__ __forceinline__ void as_a(uint32_t (&a)[2][4], const Acc& c) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc += A . B over k: A the warp's 16 rows at a ([16][k], row stride lda),
// B a 32-column block at b stored [k][n].
__device__ __forceinline__ void mma_rows(Acc& acc, const bf16* a, int lda, const bf16* b, int ldb,
                                         int k, int lane) {
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[4], bfr[2][4];
    a_mk(af, a + k0, lda, lane);
    b_kn(bfr, b + k0 * ldb, ldb, lane);
    mma_n32(acc, af, bfr);
  }
}

// Rows [0, valid) of a warp's 16 x 32 accumulator, rounded to bf16, to dst
// [16][ld] (shared or device memory).
__device__ __forceinline__ void store_rows(bf16* dst, int ld, const Acc& c, const Quad& q,
                                           int valid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (q.g + 8 * h >= valid) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      *reinterpret_cast<uint32_t*>(dst + (q.g + 8 * h) * ld + ni * 8 + 2 * q.t) =
          pack_bf16(c[ni][2 * h], c[ni][2 * h + 1]);
  }
}

// In place, per row of a head's 16 x 32 accumulator: softmax(row) * scale;
// rows at or past valid become zeros.
__device__ __forceinline__ void head_softmax(Acc& a, const Quad& q, int valid, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mx = fmaxf(mx, fmaxf(a[ni][2 * h], a[ni][2 * h + 1]));
    mx = quad_max(mx);
    float s = 0.f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[ni][2 * h + e] = __expf(a[ni][2 * h + e] - mx);
        s += a[ni][2 * h + e];
      }
    s = quad_sum(s);
    const float f = q.g + 8 * h < valid ? scale / fmaxf(s, 1e-30f) : 0.f;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      a[ni][2 * h] *= f;
      a[ni][2 * h + 1] *= f;
    }
  }
}

// The warp's 16 rows at src ([16][ld], cp columns, cp % 32 == 0, zeros from
// column c on, as in g) to dst (the same layout; dst may be src): row <-
// bf16(row / rms(row) * g) with the mean over the c true columns, rows past
// valid zeros; 1 / rms to inv_out[r] where given. Two lanes a row, each
// summing the squares of its half of the padded row (cp / 16 chunks of 8)
// in order, then the two halves; 1 / rms correctly rounded (__frsqrt_rn),
// so that a plain version can form the same xn
// (ops/attn_block.tensor_route_prenorm). #2-#5 take the tensor route at the
// same shapes (C % 8 == 0) and all form xn here, at the same cp: the k
// whose column max #2 writes is the k that #5 exponentiates.
__device__ void warp_norm16(bf16* dst, const bf16* src, int ld, const float* g, int valid, int c,
                            int cp, float* inv_out, int lane) {
  const int r = lane >> 1, off = (lane & 1) * (cp / 2), chunks = cp / 16;
  const bf16* row = src + r * ld + off;
  float ss = 0.f;
  for (int k = 0; k < chunks; ++k) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(row + 8 * k), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  const bool ok = r < valid;
  const float inv = __frsqrt_rn(ss / (float)c + 1e-12f);
  bf16* out_row = dst + r * ld + off;
  for (int k = 0; k < chunks; ++k) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(row + 8 * k), v);
    const float* gk = g + off + 8 * k;
    uint4 out{0u, 0u, 0u, 0u};
    if (ok) {
      out.x = pack_bf16(v[0] * inv * gk[0], v[1] * inv * gk[1]);
      out.y = pack_bf16(v[2] * inv * gk[2], v[3] * inv * gk[3]);
      out.z = pack_bf16(v[4] * inv * gk[4], v[5] * inv * gk[5]);
      out.w = pack_bf16(v[6] * inv * gk[6], v[7] * inv * gk[7]);
    }
    *reinterpret_cast<uint4*>(out_row + 8 * k) = out;
  }
  if (inv_out && (lane & 1) == 0) inv_out[r] = ok ? inv : 0.f;
}

// The attention of a warp's 16 rows of xn at xw (row stride C + 8, C = 32
// NC; the K slices of q = xn . Wq below kc, those that hold a column < the
// true C): per head h, q' = softmax(xn . Wq_h) D^-1/2 (rows at or past valid
// zeros) and out_h = q' . ctx_h, each rounded to bf16, and o[j] += out .
// Wout[:, 32 j, 32 j + 32). q' and out also go to qs_w and out_w ([16][kLF])
// where given (#4's sums over the tokens). #3's forward and #4's recompute of
// it, so that #4 rebuilds exactly the o that #3 normalised.
template <int NC>
__device__ __forceinline__ void attn_rows(Acc (&o)[NC], const bf16* xw, int kc, const bf16* wq_s,
                                          const bf16* ctx_s, const bf16* wo_s, const Quad& q,
                                          int valid, bf16* qs_w, bf16* out_w) {
  constexpr int C = 32 * NC, LC = ldc(C);
  for (int h = 0; h < kHeads; ++h) {
    float qa[4][4] = {};
    mma_rows(qa, xw, LC, wq_s + h * kD, kLF, kc, q.lane);
    head_softmax(qa, q, valid, rsqrtf((float)kD));
    if (qs_w) store_rows(qs_w + h * kD, kLF, qa, q, 16);
    uint32_t aq[2][4];
    as_a(aq, qa);
    float oa[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t bfr[2][4];
      b_kn(bfr, ctx_s + (h * kD + kk * 16) * kLH, kLH, q.lane);
      mma_n32(oa, aq[kk], bfr);
    }
    if (out_w) store_rows(out_w + h * kD, kLF, oa, q, 16);
    uint32_t ao[2][4];
    as_a(ao, oa);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        uint32_t bfr[2][4];
        b_kn(bfr, wo_s + (h * kD + kk * 16) * LC + j * 32, LC, q.lane);
        mma_n32(o[j], ao[kk], bfr);
      }
  }
}

// ------------------------------------------ bf16 forward: tensor cores
// #2 and #3 in bf16 on the domain of #4 and #5's tensor route, C padded
// the same way (pad32, zeros past C: x's columns, Wk's, Wv's and Wq's rows,
// Wout's columns and the vectors; the norms divide by the true C, and
// nothing past C is stored). Both walk the 128-token tiles of a split of a
// batch row, the next tile's x loading (cp.async) while they work on the
// current one, and both form xn with warp_norm16, as #4 and #5 do.
//   - #2 (ctx_tc_kernel): each warp normalises 16 rows of the tile in
//     place; then, for each 64-row half, k and v = xn . Wkv (Wkv resident)
//     in #1's split pass 1 (a 2 x 4 grid of warps, a head a warp column,
//     mma_resident) fold into #1's online softmax (online_update: a running
//     column max m, s = sum exp(k - m) and a_h = bf16(exp(k_h - m_h))^T .
//     bf16(v_h), a sum over the tokens through ldmatrix .trans, rescaled
//     when m grows). Each block writes one f32 record (m, s, a) a warp row;
//     ctx_merge_kernel merges a batch row's records in a fixed order
//     (merge_records) into kmax, s and a, f32.
//   - #3 (out_tc_kernel): each warp loads, normalises and works its own 16
//     rows with no block barrier in the loop: attn_rows (Wq, Wout and ctx
//     resident), then + bout, the out-norm and the residual in f32 on the
//     accumulators, y staged in bf16 in the warp's xn rows and stored 16
//     bytes a lane.

// #2's shared memory at C (pad32 of the true C): Wk and Wv side by side
// [C][2 kBN + 8] (load_slab<2>), g_pre [C] f32, two x tiles [kTM][C + 8] and
// the warps' online_update scratch.
struct CtxLayout {
  int w, g, x, scratch, total;
};
__host__ __device__ inline CtxLayout ctx_layout(int c) {
  CtxLayout l{};
  l.g = c * (2 * kBN + 8) * 2;
  l.x = l.g + c * 4;
  l.scratch = l.x + 2 * kTM * ldc(c) * 2;
  l.total = l.scratch + kWarps * kWarpScratch;
  return l;
}

// #3's, at C padded: Wq [C][kLF], Wout [F][C + 8], ctx [F][kLH], g_pre,
// bout, g_out [3][C] f32, two x tiles and the xn tile [kTM][C + 8].
struct OutLayout {
  int wq, wo, ctx, vec, x, xn, total;
};
__host__ __device__ inline OutLayout out_layout(int c) {
  OutLayout l{};
  l.wo = c * kLF * 2;
  l.ctx = l.wo + kF * ldc(c) * 2;
  l.vec = l.ctx + kF * kLH * 2;
  l.x = l.vec + 3 * c * 4;
  l.xn = l.x + 2 * kTM * ldc(c) * 2;
  l.total = l.xn + kTM * ldc(c) * 2;
  return l;
}

// #2: block (z, b) folds the tiles of split z of batch row b and writes one
// record per warp row to parts [B][splits][2][kPart]. In shared memory C is
// cp = pad32(c) wide; kPad where c < cp (else cp is c, the route's code at
// C % 32 == 0).
template <bool kPad>
__global__ void __launch_bounds__(kThreads, 2)
ctx_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g_pre,
              const bf16* __restrict__ wqkv, float* __restrict__ parts, int n, int c,
              int splits, int vec) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const int cp = kPad ? pad32(c) : c;
  const CtxLayout l = ctx_layout(cp);
  bf16* w_s = reinterpret_cast<bf16*>(base + l.w);
  float* gs = reinterpret_cast<float*>(base + l.g);
  bf16* xbuf = reinterpret_cast<bf16*>(base + l.x);
  const int lc = ldc(cp), w = threadIdx.x >> 5, wm = Lane().wm, b = blockIdx.y;
  const TileRange tr(blockIdx.x, splits, (n + kTM - 1) / kTM);
  const bf16* xb = x + (size_t)b * n * c;
  char* scratch = base + l.scratch + w * kWarpScratch;
  // tile `tile` into its buffer as one commit group (an empty one past t1);
  // columns c to cp zero-filled
  auto prefetch = [&](int tile) {
    if (tile < tr.t1)
      copy_rows(xbuf + ((tile - tr.t0) & 1) * kTM * lc, lc, xb + (size_t)tile * kTM * c, c, kTM,
                min(kTM, n - tile * kTM), cp, vec, threadIdx.x, kThreads, kPad ? c : 1 << 30);
    cp_async_commit();
  };
  for (int i = threadIdx.x; i < cp; i += kThreads) gs[i] = kPad && i >= c ? 0.f : g_pre[i];
  // Wk and Wv's cp rows, zeros from row c on: every K slice mma_resident reads
  load_slab<2>(w_s, WSlab{wqkv, 3 * kF, kF, kF, 3 * kF}, 0, cp, c, vec);
  prefetch(tr.t0);  // with the weights
  WarpCtx st;
  st.init();
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    bf16* cur = xbuf + ((tile - tr.t0) & 1) * kTM * lc;
    prefetch(tile + 1);
    cp_async_wait<1>();  // this tile (and the weights) have landed
    __syncthreads();
    const int rows = min(kTM, n - tile * kTM);
    warp_norm16(cur + w * 16 * lc, cur + w * 16 * lc, lc, gs, max(0, min(16, rows - w * 16)), c,
                cp, nullptr, threadIdx.x & 31);
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      float kv[2][2][4][4] = {};
      mma_resident<2>(kv, cur + half * 64 * lc, lc, w_s, cp);
      online_update(st, kv[0], kv[1], rows - half * 64 - wm * 32, scratch);
    }
    __syncthreads();  // every warp is done with this buffer before it loads again
  }
  cp_async_wait<0>();
  write_record(st, parts + ((size_t)(b * splits + blockIdx.x) * 2 + wm) * kPart);
}

// #2's merge: block (b, y) merges row b's `count` records for its kThreads
// elements of a [B][F][D], one a thread; the thread of each channel's
// element 0 writes the channel's kmax and s.
__global__ void __launch_bounds__(kThreads)
ctx_merge_kernel(const float* __restrict__ parts, float* __restrict__ kmax,
                 float* __restrict__ s, float* __restrict__ a, int count) {
  const int b = blockIdx.x;
  merge_records(parts + (size_t)b * count * kPart, count, blockIdx.y * kThreads + threadIdx.x,
                kF * kD, [&](int i, float m, float sv, float av) {
                  a[(size_t)b * kF * kD + i] = av;
                  if (i % kD == 0) {
                    kmax[b * kF + i / kD] = m;
                    s[b * kF + i / kD] = sv;
                  }
                });
}

// #3: block (z, b) writes y for the tiles of split z of batch row b; each
// warp its 16 rows of each tile, its x rows double-buffered. C = 32 NC =
// pad32(c); kPad as for #4.
template <int NC, bool kPad>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
out_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g_pre,
              const bf16* __restrict__ wqkv, const bf16* __restrict__ ctx,
              const bf16* __restrict__ wout, const float* __restrict__ bout,
              const float* __restrict__ g_out, bf16* __restrict__ y, int n, int c_in, int splits,
              int vec) {
  constexpr int C = 32 * NC, LC = ldc(C);
  const int c = kPad ? c_in : C;
  const int kc = kPad ? (c + 15) / 16 * 16 : C;  // the K slices over C that hold a column < c
  const int c_lim = kPad ? c : 1 << 30;          // copy_rows' zero-fill from column c on
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const OutLayout l = out_layout(C);
  bf16* wq_s = reinterpret_cast<bf16*>(base + l.wq);
  bf16* wo_s = reinterpret_cast<bf16*>(base + l.wo);
  bf16* ctx_s = reinterpret_cast<bf16*>(base + l.ctx);
  float* vs = reinterpret_cast<float*>(base + l.vec);
  const Quad q;
  const int b = blockIdx.y, r0 = q.w * 16;
  const TileRange tr(blockIdx.x, splits, (n + kTM - 1) / kTM);
  const size_t tok0 = (size_t)b * n;  // the batch row's first token
  bf16* xw[2] = {reinterpret_cast<bf16*>(base + l.x) + r0 * LC,
                 reinterpret_cast<bf16*>(base + l.x) + (kTM + r0) * LC};
  bf16* xnw = reinterpret_cast<bf16*>(base + l.xn) + r0 * LC;
  auto rows_of = [&](int tile) { return max(0, min(16, min(kTM, n - tile * kTM) - r0)); };
  // the warp's rows of tile `tile` into its buffer as one commit group
  auto prefetch = [&](int tile) {
    if (tile < tr.t1)
      copy_rows(xw[(tile - tr.t0) & 1], LC, x + (tok0 + (size_t)tile * kTM + r0) * c, c, 16,
                rows_of(tile), C, vec, q.lane, 32, c_lim);
    cp_async_commit();
  };

  copy_rows(wq_s, kLF, wqkv, 3 * kF, C, c, kF, vec, threadIdx.x, kThreads);
  copy_rows(wo_s, LC, wout, c, kF, kF, C, vec, threadIdx.x, kThreads, c_lim);
  copy_rows(ctx_s, kLH, ctx + (size_t)b * kF * kD, kD, kF, kF, kD, vec, threadIdx.x, kThreads);
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const bool in = !kPad || i < c;
    vs[i] = in ? g_pre[i] : 0.f;
    vs[C + i] = in ? bout[i] : 0.f;
    vs[2 * C + i] = in ? g_out[i] : 0.f;
  }
  prefetch(tr.t0);
  cp_async_wait<0>();
  __syncthreads();  // the weights, ctx and vectors, for every warp
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    const bf16* cur = xw[(tile - tr.t0) & 1];
    prefetch(tile + 1);
    cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    const int valid = rows_of(tile);
    warp_norm16(xnw, cur, LC, vs, valid, c, C, nullptr, q.lane);
    __syncwarp();
    float o[NC][4][4] = {};
    attn_rows<NC>(o, xnw, kc, wq_s, ctx_s, wo_s, q, valid, nullptr, nullptr);
    // o += bout; y = x + o r2 g_out with r2 = 1 / rms(o), as #4 recomputes it
    // (o is 0 past c)
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& ov = o[j][ni][e];
          ov += vs[C + j * 32 + ni * 8 + 2 * q.t + (e & 1)];
          ss[e >> 1] = fmaf(ov, ov, ss[e >> 1]);
        }
    float r2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) r2[h] = rsqrtf(quad_sum(ss[h]) / (float)c + 1e-12f);
    __syncwarp();  // every lane has read xn: y takes its place
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = q.g + 8 * h, col = j * 32 + ni * 8 + 2 * q.t;
          float yv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            yv[e] = bf(cur[r * LC + col + e]) + o[j][ni][2 * h + e] * r2[h] * vs[2 * C + col + e];
          *reinterpret_cast<uint32_t*>(xnw + r * LC + col) = pack_bf16(yv[0], yv[1]);
        }
    __syncwarp();
    bf16* yw = y + (tok0 + (size_t)tile * kTM + r0) * c;
    for (int i = q.lane; i < valid * (c / 8); i += 32) {
      const int r = i / (c / 8), ch = (i % (c / 8)) * 8;
      if (vec) {
        *reinterpret_cast<uint4*>(yw + r * c + ch) =
            *reinterpret_cast<const uint4*>(xnw + r * LC + ch);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) yw[r * c + ch + e] = xnw[r * LC + ch + e];
      }
    }
    __syncwarp();  // y has left xn before the next tile's norm writes it
  }
  cp_async_wait<0>();
}

// #4: block (z, b) walks the tiles of split z of batch row b and writes the
// block's partials part = b * splits + z: d_ctx [F][D], dbout [c], dg_out
// [c], dWout [F][c]; do (f32) for its tokens. C = 32 NC = pad32(c); kPad
// where c < C (else c is C at compile time, the route's code at C % 32 == 0).
template <int NC, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
bwd_a_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ g_pre, const bf16* __restrict__ wqkv,
                const bf16* __restrict__ ctx, const bf16* __restrict__ wout,
                const float* __restrict__ bout, const float* __restrict__ g_out,
                float* __restrict__ do_g, float* __restrict__ dctx_part,
                float* __restrict__ db_part, float* __restrict__ dg_part,
                float* __restrict__ dwout_part, int n, int c_in, int splits, int vec) {
  constexpr int C = 32 * NC, LC = ldc(C);
  const int c = kPad ? c_in : C;
  const int kc = kPad ? (c + 15) / 16 * 16 : C;  // the K slices over C that hold a column < c
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const BwdALayout l = bwd_a_layout(C);
  bf16* wq_s = reinterpret_cast<bf16*>(base + l.wq);
  bf16* wo_s = reinterpret_cast<bf16*>(base + l.wo);
  bf16* ctx_s = reinterpret_cast<bf16*>(base + l.ctx);
  float* vs = reinterpret_cast<float*>(base + l.vec);
  bf16* xn_s = reinterpret_cast<bf16*>(base + l.xn);
  bf16* qs_s = reinterpret_cast<bf16*>(base + l.qs);
  bf16* out_s = reinterpret_cast<bf16*>(base + l.out);
  bf16* dout_s = reinterpret_cast<bf16*>(base + l.dout);
  float* red_s = reinterpret_cast<float*>(base + l.red);
  const Quad q;
  const int b = blockIdx.y, part = b * splits + blockIdx.x, r0 = q.w * 16;
  const TileRange tr(blockIdx.x, splits, (n + kTM - 1) / kTM);
  const bf16* xb = x + (size_t)b * n * c;
  const bf16* dyb = dy + (size_t)b * n * c;
  float* dob = do_g + (size_t)b * n * c;

  copy_rows(wq_s, kLF, wqkv, 3 * kF, C, c, kF, vec, threadIdx.x, kThreads);
  copy_rows(wo_s, LC, wout, c, kF, kF, C, vec, threadIdx.x, kThreads, c);
  copy_rows(ctx_s, kLH, ctx + (size_t)b * kF * kD, kD, kF, kF, kD, vec, threadIdx.x, kThreads);
  cp_async_commit();
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const bool in = i < c;
    vs[i] = in ? g_pre[i] : 0.f;
    vs[C + i] = in ? bout[i] : 0.f;
    vs[2 * C + i] = in ? g_out[i] : 0.f;
  }
  for (int i = threadIdx.x; i < kWarps * 2 * C; i += kThreads) red_s[i] = 0.f;

  // this warp's share of the block's sums over its tokens: d_ctx rows
  // [d0, d0 + 16) of head hh; dWout rows [r0, r0 + 16)
  const int hh = q.w >> 1, d0 = (q.w & 1) * 16;
  float dctx[4][4] = {};
  float dwo[NC][4][4] = {};
  bf16* xw = xn_s + r0 * LC;
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    const int t0 = tile * kTM, rows = min(kTM, n - t0);
    const int valid = max(0, min(16, rows - r0));
    copy_rows(xn_s, LC, xb + (size_t)t0 * c, c, kTM, rows, C, vec, threadIdx.x, kThreads, c);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_norm16(xw, xw, LC, vs, valid, c, C, nullptr, q.lane);
    __syncwarp();
    float o[NC][4][4] = {};
    attn_rows<NC>(o, xw, kc, wq_s, ctx_s, wo_s, q, valid, qs_s + r0 * kLF, out_s + r0 * kLF);
    // o += bout; the out-norm's backward: do = r2 dy g_out - o r2^3 mean(o dy g_out)
    // (o, dy and do are 0 past c)
    const bool ok[2] = {q.g < valid, q.g + 8 < valid};
    const size_t row0 = (size_t)(t0 + r0 + q.g) * c, row1 = row0 + 8 * (size_t)c;
    float dyv[NC][4][4];
    float ss[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 32 + ni * 8 + 2 * q.t + (e & 1), h = e >> 1;
          const float ov = o[j][ni][e] + vs[C + col];
          const float dv = ok[h] && col < c ? bf(dyb[(h ? row1 : row0) + col]) : 0.f;
          o[j][ni][e] = ov;
          dyv[j][ni][e] = dv;
          ss[h] = fmaf(ov, ov, ss[h]);
          dot[h] = fmaf(ov, dv * vs[2 * C + col], dot[h]);
        }
    float r2[2], dm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r2[h] = rsqrtf(quad_sum(ss[h]) / (float)c + 1e-12f);
      dm[h] = quad_sum(dot[h]) / (float)c;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 32 + ni * 8 + 2 * q.t + e;
          float db = 0.f, dg = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float ov = o[j][ni][2 * h + e], dv = dyv[j][ni][2 * h + e];
            const float d = r2[h] * dv * vs[2 * C + col] - ov * (r2[h] * r2[h] * r2[h]) * dm[h];
            if (ok[h] && col < c) dob[(h ? row1 : row0) + col] = d;
            db += d;
            dg = fmaf(dv * ov, r2[h], dg);
            o[j][ni][2 * h + e] = d;
          }
          db = column_sum(db);
          dg = column_sum(dg);
          if (q.g == 0) {
            red_s[(q.w * 2) * C + col] += db;
            red_s[(q.w * 2 + 1) * C + col] += dg;
          }
        }
    // do rounded: into this warp's rows of the x tile (its xn is read) and as
    // the A fragments of d_out = do . Wout^T
    __syncwarp();
    uint32_t ado[NC][2][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      store_rows(xw + j * 32, LC, o[j], q, 16);
      as_a(ado[j], o[j]);
    }
    for (int h = 0; h < kHeads; ++h) {
      float da[4][4] = {};
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (j * 32 + kk * 16 >= kc) continue;
          uint32_t bfr[2][4];
          b_nk(bfr, wo_s + h * kD * LC + j * 32 + kk * 16, LC, q.lane);
          mma_n32(da, ado[j][kk], bfr);
        }
      store_rows(dout_s + r0 * kLF + h * kD, kLF, da, q, 16);
    }
    __syncthreads();
    // the sums over the tile's tokens
    for (int k0 = 0; k0 < kTM; k0 += 16) {
      uint32_t af[4], bfr[2][4];
      a_km(af, qs_s + k0 * kLF + hh * kD + d0, kLF, q.lane);
      b_kn(bfr, dout_s + k0 * kLF + hh * kD, kLF, q.lane);
      mma_n32(dctx, af, bfr);
      a_km(af, out_s + k0 * kLF + r0, kLF, q.lane);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        b_kn(bfr, xn_s + k0 * LC + j * 32, LC, q.lane);
        mma_n32(dwo[j], af, bfr);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  float* dcp = dctx_part + (size_t)part * kF * kD;
  float* dwp = dwout_part + (size_t)part * kF * c;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q.g + 8 * (e >> 1), col = ni * 8 + 2 * q.t + (e & 1);
      dcp[(hh * kD + d0 + r) * kD + col] = dctx[ni][e];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (j * 32 + col < c) dwp[(r0 + r) * c + j * 32 + col] = dwo[j][ni][e];
    }
  for (int i = threadIdx.x; i < c; i += kThreads) {
    float db = 0.f, dg = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      db += red_s[(2 * w) * C + i];
      dg += red_s[(2 * w + 1) * C + i];
    }
    db_part[(size_t)part * c + i] = db;
    dg_part[(size_t)part * c + i] = dg;
  }
}

// #5: block (z, b) walks the tiles of split z of batch row b: dx, xn and
// d_qkv (bf16) of its tokens, and the block's partial of dg_pre [c]. C = 32
// NC = pad32(c); kPad as for #4.
template <int NC, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
bwd_b_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ do_g, const float* __restrict__ g_pre,
                const bf16* __restrict__ wqkv, const bf16* __restrict__ ctx,
                const bf16* __restrict__ wout, const float* __restrict__ kmax,
                const float* __restrict__ d_a, const float* __restrict__ d_s,
                bf16* __restrict__ dx, bf16* __restrict__ xn_g, bf16* __restrict__ dqkv_g,
                float* __restrict__ dg_part, int n, int c_in, int splits, int vec) {
  constexpr int C = 32 * NC, LC = ldc(C), F3 = 3 * kF;
  const int c = kPad ? c_in : C;
  const int kc = kPad ? (c + 15) / 16 * 16 : C;  // the K slices over C that hold a column < c
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const BwdBLayout l = bwd_b_layout(C);
  bf16* w_s = reinterpret_cast<bf16*>(base + l.w);
  bf16* wo_s = reinterpret_cast<bf16*>(base + l.wo);
  bf16* ctx_s = reinterpret_cast<bf16*>(base + l.ctx);
  bf16* dah_s = reinterpret_cast<bf16*>(base + l.dah);
  bf16* dal_s = reinterpret_cast<bf16*>(base + l.dal);
  float* kmax_s = reinterpret_cast<float*>(base + l.vec);
  float* ds_s = kmax_s + kF;
  float* gp_s = ds_s + kF;
  bf16* xn_s = reinterpret_cast<bf16*>(base + l.xn);
  float* inv_s = reinterpret_cast<float*>(base + l.inv);
  float* red_s = reinterpret_cast<float*>(base + l.red);
  const Quad q;
  const int b = blockIdx.y, part = b * splits + blockIdx.x, r0 = q.w * 16;
  const TileRange tr(blockIdx.x, splits, (n + kTM - 1) / kTM);
  const size_t tok0 = (size_t)b * n;  // the batch row's first token
  const float scale = rsqrtf((float)kD);

  copy_rows(w_s, kLW, wqkv, F3, C, c, F3, vec, threadIdx.x, kThreads);
  copy_rows(wo_s, LC, wout, c, kF, kF, C, vec, threadIdx.x, kThreads, c);
  copy_rows(ctx_s, kLH, ctx + (size_t)b * kF * kD, kD, kF, kF, kD, vec, threadIdx.x, kThreads);
  cp_async_commit();
  for (int i = threadIdx.x; i < kF * kD; i += kThreads) {
    const float v = d_a[(size_t)b * kF * kD + i];
    const bf16 hi = __float2bfloat16(v);
    dah_s[(i / kD) * kLH + i % kD] = hi;
    dal_s[(i / kD) * kLH + i % kD] = __float2bfloat16(v - bf(hi));
  }
  for (int i = threadIdx.x; i < kF; i += kThreads) {
    kmax_s[i] = kmax[(size_t)b * kF + i];
    ds_s[i] = d_s[(size_t)b * kF + i];
  }
  for (int i = threadIdx.x; i < C; i += kThreads) gp_s[i] = i < c ? g_pre[i] : 0.f;
  for (int i = threadIdx.x; i < kWarps * C; i += kThreads) red_s[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // each warp loads, normalises and reads only its own 16 rows of the tile
  bf16* xw = xn_s + r0 * LC;
  auto rows_of = [&](int tile) { return max(0, min(16, min(kTM, n - tile * kTM) - r0)); };
  if (tr.t0 < tr.t1)
    copy_rows(xw, LC, x + (tok0 + tr.t0 * kTM + r0) * c, c, 16, rows_of(tr.t0), C, vec, q.lane,
              32, c);
  cp_async_commit();
  for (int tile = tr.t0; tile < tr.t1; ++tile) {
    const int valid = rows_of(tile);
    const size_t trow = tok0 + (size_t)tile * kTM + r0;  // token of the warp's row 0
    cp_async_wait<0>();
    __syncwarp();
    warp_norm16(xw, xw, LC, gp_s, valid, c, C, inv_s + r0, q.lane);
    __syncwarp();
    for (int i = q.lane; i < valid * (c / 8); i += 32) {  // xn [B N, c]: 16-byte rows
      const int r = i / (c / 8), ch = (i % (c / 8)) * 8;
      *reinterpret_cast<uint4*>(xn_g + (trow + r) * c + ch) =
          *reinterpret_cast<const uint4*>(xw + r * LC + ch);
    }
    const bool ok[2] = {q.g < valid, q.g + 8 < valid};
    // do, rounded, as the A fragments of d_out = do . Wout^T
    uint32_t ado[NC][2][4];
    {
      const float* d0 = do_g + (trow + q.g) * c;
      const float* d1 = d0 + 8 * (size_t)c;
      auto ld = [&](const float* row, int h, int col) { return ok[h] && col < c ? row[col] : 0.f; };
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int c0 = j * 32 + kk * 16 + 2 * q.t;
          ado[j][kk][0] = pack_bf16(ld(d0, 0, c0), ld(d0, 0, c0 + 1));
          ado[j][kk][1] = pack_bf16(ld(d1, 1, c0), ld(d1, 1, c0 + 1));
          ado[j][kk][2] = pack_bf16(ld(d0, 0, c0 + 8), ld(d0, 0, c0 + 9));
          ado[j][kk][3] = pack_bf16(ld(d1, 1, c0 + 8), ld(d1, 1, c0 + 9));
        }
    }
    float dxn[NC][4][4] = {};
    // d_qkv's block at column col0 of F3: rounded, written, and folded into
    // d_xn += d_qkv . Wqkv^T
    auto emit = [&](const Acc& dq, int col0) {
      store_rows(dqkv_g + trow * F3 + col0, F3, dq, q, valid);
      uint32_t a[2][4];
      as_a(a, dq);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          uint32_t bfr[2][4];
          b_nk(bfr, w_s + j * 32 * kLW + col0 + kk * 16, kLW, q.lane);
          mma_n32(dxn[j], a[kk], bfr);
        }
    };
    for (int h = 0; h < kHeads; ++h) {
      // d_out_h = bf16(do . Wout_h^T); d_p = d_out_h . ctx_h^T D^-1/2
      float dp[4][4] = {};
      {
        float da[4][4] = {};
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (j * 32 + kk * 16 >= kc) continue;
            uint32_t bfr[2][4];
            b_nk(bfr, wo_s + h * kD * LC + j * 32 + kk * 16, LC, q.lane);
            mma_n32(da, ado[j][kk], bfr);
          }
        uint32_t a[2][4];
        as_a(a, da);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bfr[2][4];
          b_nk(bfr, ctx_s + h * kD * kLH + kk * 16, kLH, q.lane);
          mma_n32(dp, a[kk], bfr);
        }
      }
      // p = softmax(q_h); d_q = p (d_p - sum_d d_p p)
      {
        float pa[4][4] = {};
        mma_rows(pa, xw, LC, w_s + h * kD, kLW, kc, q.lane);
        head_softmax(pa, q, valid, 1.f);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float s = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) s = fmaf(dp[ni][2 * h2 + e] * scale, pa[ni][2 * h2 + e], s);
          s = quad_sum(s);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& p = pa[ni][2 * h2 + e];
              p = p * (dp[ni][2 * h2 + e] * scale - s);
            }
        }
        emit(pa, h * kD);
      }
      // d_e = v_h . d_a_h^T (v rounded; d_a as hi + lo)
      float de[4][4] = {};
      {
        float va[4][4] = {};
        mma_rows(va, xw, LC, w_s + 2 * kF + h * kD, kLW, kc, q.lane);
        uint32_t av[2][4];
        as_a(av, va);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bfr[2][4];
          b_nk(bfr, dah_s + h * kD * kLH + kk * 16, kLH, q.lane);
          mma_n32(de, av[kk], bfr);
          b_nk(bfr, dal_s + h * kD * kLH + kk * 16, kLH, q.lane);
          mma_n32(de, av[kk], bfr);
        }
      }
      // e = exp(k_h - kmax); d_k = e (d_e + d_s); d_v = e_h . d_a_h (e rounded)
      float ea[4][4] = {};
      mma_rows(ea, xw, LC, w_s + kF + h * kD, kLW, kc, q.lane);
      if (h == kHeads - 1) {  // the last read of this warp's rows: load the next tile's
        __syncwarp();
        if (tile + 1 < tr.t1)
          copy_rows(xw, LC, x + (trow + kTM) * c, c, 16, rows_of(tile + 1), C, vec, q.lane, 32,
                    c);
        cp_async_commit();
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h * kD + ni * 8 + 2 * q.t + (e & 1);
          const float ev = ok[e >> 1] ? __expf(ea[ni][e] - kmax_s[col]) : 0.f;
          ea[ni][e] = ev;
          de[ni][e] = ev * (de[ni][e] + ds_s[col]);
        }
      emit(de, kF + h * kD);
      float dv[4][4] = {};
      {
        uint32_t ae[2][4];
        as_a(ae, ea);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t bfr[2][4];
          b_kn(bfr, dah_s + (h * kD + kk * 16) * kLH, kLH, q.lane);
          mma_n32(dv, ae[kk], bfr);
          b_kn(bfr, dal_s + (h * kD + kk * 16) * kLH, kLH, q.lane);
          mma_n32(dv, ae[kk], bfr);
        }
      }
      emit(dv, 2 * kF + h * kD);
    }
    // the pre-norm's backward, dx = dy + inv du - x inv^3 mean(x du) with
    // du = d_xn g_pre; dg_pre += d_xn x inv (d_xn, x and g_pre are 0 past c)
    float dg[NC][4][2] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows past the tokens: zeros (the shuffles take every lane)
      const size_t row = (trow + q.g + 8 * h) * c;
      const float inv = inv_s[r0 + q.g + 8 * h];
      float xv[NC][4][2];
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 32 + ni * 8 + 2 * q.t + e;
            xv[j][ni][e] = ok[h] && col < c ? bf(x[row + col]) : 0.f;
            dot = fmaf(xv[j][ni][e], dxn[j][ni][2 * h + e] * gp_s[col], dot);
          }
      dot = quad_sum(dot) / (float)c;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 32 + ni * 8 + 2 * q.t + e;
            const float g = dxn[j][ni][2 * h + e], xf = xv[j][ni][e];
            const float d = inv * g * gp_s[col] - xf * (inv * inv * inv) * dot;
            if (ok[h] && col < c) dx[row + col] = __float2bfloat16(bf(dy[row + col]) + d);
            dg[j][ni][e] = fmaf(g * xf, inv, dg[j][ni][e]);
          }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = column_sum(dg[j][ni][e]);
          if (q.g == 0) red_s[q.w * C + j * 32 + ni * 8 + 2 * q.t + e] += s;
        }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_s[w * C + i];
    dg_part[(size_t)part * c + i] = s;
  }
}

// part[p][i][j] = sum over the tokens t of split p of A[t][i] B[t][j] (A
// [M, I], B [M, J] bf16, I and J multiples of 8, 16-byte aligned): a 64 x
// 128 output tile per block, warps in 2 x 4 tiles of 32 x 32, 32-token
// slices through a kGStages-deep cp.async ring.
__device__ void wgrad_stage(bf16* st, const bf16* __restrict__ A, const bf16* __restrict__ B,
                            int t0, int end, int i0, int j0, int i_dim, int j_dim) {
  bf16* a_s = st;
  bf16* b_s = st + kGK * kGLA;
  constexpr int ca = kGI / 8, cb = kGJ / 8;
  for (int idx = threadIdx.x; idx < kGK * (ca + cb); idx += kThreads) {
    const bool is_a = idx < kGK * ca;
    const int k = is_a ? idx : idx - kGK * ca, per = is_a ? ca : cb;
    const int r = k / per, col = (k % per) * 8 + (is_a ? i0 : j0);
    const int lim = is_a ? i_dim : j_dim;
    const bool ok = t0 + r < end && col < lim;
    const bf16* src = is_a ? A : B;
    const bf16* s = ok ? src + (size_t)(t0 + r) * lim + col : src;
    bf16* d = is_a ? a_s + r * kGLA + col - i0 : b_s + r * kGLB + col - j0;
    cp_async_16(d, s, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
                int m, int i_dim, int j_dim) {
  extern __shared__ __align__(16) float smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const Quad q;
  const int wm = q.w >> 2, wn = q.w & 3;
  const int i0 = blockIdx.x * kGI, j0 = blockIdx.y * kGJ;
  int per = (m + gridDim.z - 1) / gridDim.z;
  per = (per + kGK - 1) / kGK * kGK;
  const int begin = blockIdx.z * per;
  const int end = begin + per < m ? begin + per : m;
  const int n_kt = end > begin ? (end - begin + kGK - 1) / kGK : 0;
  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_kt)
      wgrad_stage(ring + s * kGStage, A, B, begin + s * kGK, end, i0, j0, i_dim, j_dim);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kGStages - 2>();  // slice kt has landed
    __syncthreads();                // ... for every thread; and slot (kt - 1) is free
    if (kt + kGStages - 1 < n_kt)
      wgrad_stage(ring + ((kt + kGStages - 1) % kGStages) * kGStage, A, B,
                  begin + (kt + kGStages - 1) * kGK, end, i0, j0, i_dim, j_dim);
    cp_async_commit();
    const bf16* a_s = ring + (kt % kGStages) * kGStage;
    const bf16* b_s = a_s + kGK * kGLA;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        a_km(af[mi], a_s + kk * kGLA + wm * 32 + mi * 16, kGLA, q.lane);
      b_kn(bfr, b_s + kk * kGLB + wn * 32, kGLB, q.lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_n32(acc[mi], af[mi], bfr);
    }
  }
  cp_async_wait<0>();
  float* out = part + (size_t)blockIdx.z * i_dim * j_dim;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm * 32 + mi * 16 + q.g + 8 * (e >> 1);
        const int j = j0 + wn * 32 + ni * 8 + 2 * q.t + (e & 1);
        if (i < i_dim && j < j_dim) out[(size_t)i * j_dim + j] = acc[mi][ni][e];
      }
}

// ------------------------------------------------------------- launches
// Shared-memory floats of each CUDA-core per-token kernel for a tile of tn
// tokens, at F = f and D = dh.
int smem_ctx_partial(int c, int f, int dh, int tn) {
  return align4(c * (tn + 4)) + 2 * f * (tn + 4) + 3 * f + f * dh;
}
int smem_out_large(int c, int f, int dh, int tn) {
  return align4(c * (tn + 4)) + 2 * f * (tn + 4) + f * (dh + 1) + tn * c;
}
int smem_bwd_a(int c, int f, int dh, int tn) {
  return align4(c * (tn + 4)) + 3 * f * (tn + 4) + f * (dh + 1) + 2 * align4(tn * c) + f * dh +
         2 * align4(c);
}
int smem_bwd_b(int c, int f, int dh, int tn) {
  return align4(c * (tn + 4)) + 2 * align4(tn * c) + tn + 6 * f * (tn + 4) + 2 * f * (dh + 1) +
         2 * f + align4(c);
}

// The largest tile of 32, 16 or 8 tokens whose shared memory lets two
// blocks share an SM (latency hiding for these FMA loops); else the
// largest that fits one block; else 0. The bytes to *bytes.
int cores_tile(int (*floats)(int, int, int, int), int c, int f, int dh, size_t* bytes) {
  const size_t limits[2] = {(size_t)kSmemTwoBlocks, (size_t)kMaxSmem};
  for (size_t limit : limits)
    for (int tn = 32; tn >= 8; tn /= 2) {
      *bytes = (size_t)floats(c, f, dh, tn) * sizeof(float);
      if (*bytes <= limit) return tn;
    }
  return 0;
}

template <typename K>
int pick_tile(int (*floats)(int, int, int, int), int c, int f, int dh, K kernel, size_t* bytes) {
  const int tn = cores_tile(floats, c, f, dh, bytes);
  if (tn && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)*bytes) != cudaSuccess)
    return 0;
  return tn;
}

int check_last() { return (int)cudaGetLastError(); }

int sum_parts(const float* part, float* out, int outer, int nparts, int len, cudaStream_t s) {
  const long total = (long)outer * len;
  sum_parts_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, out, outer, nparts, len);
  return check_last();
}

template <typename T, typename TA, typename TB>
int wgrad(const TA* a, const TB* b, float* part, float* out, int m, int i_dim, int j_dim,
          int nsplit, cudaStream_t s) {
  const dim3 grid((i_dim + kWT - 1) / kWT, (j_dim + kWT - 1) / kWT, nsplit);
  wgrad_kernel<T, TA, TB><<<grid, kThreads, 0, s>>>(a, b, part, m, i_dim, j_dim);
  int err = check_last();
  if (err) return err;
  return sum_parts(part, out, 1, nsplit, i_dim * j_dim, s);
}

// ----------------------------------------------------------- the plan
constexpr int kRouteCores = 0, kRouteTensor = 1, kRouteNone = -1;

// The route of one call of #2-#5 (kernel 2 to 5), the tokens of its tile,
// its blocks per batch row (splits), the token splits of its weight-gradient
// launch (wsplits) and its workspace, in regions of `bytes` (each 256-byte
// aligned): a function of the shape alone, never of a failure.
//   #2 cores: m, s parts [B splits, F], a parts [B splits, F, D], f32;
//   #2 tensor: records [B splits, 2, kPart] f32;
//   #3 either: none;
//   #4 cores: out [B N, F] (activation type), d_ctx parts [B splits, F, D],
//             dbout, dg_out parts [B splits, C], dWout parts [wsplits, F, C];
//   #4 tensor: d_ctx, dbout, dg_out parts, dWout parts [B splits, F, C];
//   #5 either: xn [B N, C], d_qkv [B N, 3F] (activation type), dg_pre parts
//             [B splits, C], dWqkv parts [wsplits, C, 3F].
struct LargePlan {
  int route, tile, splits, wsplits;
  long long bytes[5];
  long long ws_bytes;
};

inline long long up256(long long v) { return (v + 255) / 256 * 256; }
inline int clampi(long long v, int lo, long long hi) {
  return (int)(v < lo ? lo : v > hi ? hi : v);
}

// Shared-memory bytes of a block of kernel 2-5's tensor-core route at C
// (C padded to pad32).
inline int tc_smem(int kernel, int c) {
  switch (kernel) {
    case 2: return ctx_layout(pad32(c)).total;
    case 3: return out_layout(pad32(c)).total;
    case 4: return bwd_a_layout(pad32(c)).total;
    default: return bwd_b_layout(pad32(c)).total;
  }
}

LargePlan make_large_plan(int kernel, int batch, int n, int c, int heads, int dim_head,
                          int is_bf16) {
  LargePlan p{};
  if (batch < 1 || n < 1 || c < 1 || heads < 1 || dim_head < 1 || kernel < 2 || kernel > 5) {
    p.route = kRouteNone;
    return p;
  }
  const long long dh = dim_head, f = (long long)heads * dh, m = (long long)batch * n;
  const int esz = is_bf16 ? 2 : 4;
  // the four pad C to whole 32-column blocks in shared memory and need
  // 16-byte rows (C % 8 == 0)
  const bool tensor = is_bf16 && heads == kHeads && dim_head == kD && c % 8 == 0 &&
                      c <= kMaxC && tc_smem(kernel, c) <= kMaxSmem;
  if (tensor) {
    // splits a row: as many as fill one wave of the blocks an SM holds (two
    // where their shared memory fits twice: #2 and #3 at C <= 64, padded;
    // #4 and #5 hold over half an SM's at every C), at most one a tile
    const int per_sm = tc_smem(kernel, c) <= kSmemTwoBlocks ? 2 : 1;
    p.route = kRouteTensor;
    p.tile = kTM;
    p.splits = clampi((long long)per_sm * kWave / batch, 1, (n + kTM - 1) / kTM);
  } else {
    static int (*const floats[4])(int, int, int, int) = {smem_ctx_partial, smem_out_large,
                                                         smem_bwd_a, smem_bwd_b};
    size_t smem;
    p.route = kRouteCores;
    p.tile = cores_tile(floats[kernel - 2], c, (int)f, dim_head, &smem);
    // #3: a block a tile; the others: ~4 waves of blocks, at most one per 32 tokens
    p.splits = kernel == 3 ? (p.tile ? (n + p.tile - 1) / p.tile : 0)
                           : clampi((512 + batch - 1) / batch, 1, (n + 31) / 32);
  }
  const long long parts = (long long)batch * p.splits;
  if (kernel == 2) {
    if (tensor) {
      p.bytes[0] = parts * 2 * kPart * 4;
    } else {
      p.bytes[0] = p.bytes[1] = parts * f * 4;
      p.bytes[2] = parts * f * dh * 4;
    }
  } else if (kernel == 4) {
    if (tensor) {
      const long long b4[5] = {parts * f * dh * 4, parts * c * 4, parts * c * 4, parts * f * c * 4,
                               0};
      for (int i = 0; i < 5; ++i) p.bytes[i] = b4[i];
    } else {
      const long long tiles = ((f + kWT - 1) / kWT) * ((c + kWT - 1) / kWT);
      p.wsplits = clampi((512 + tiles - 1) / tiles, 1, (m + 31) / 32);
      const long long b4[5] = {m * f * esz, parts * f * dh * 4, parts * c * 4, parts * c * 4,
                               (long long)p.wsplits * f * c * 4};
      for (int i = 0; i < 5; ++i) p.bytes[i] = b4[i];
    }
  } else if (kernel == 5) {
    if (tensor) {
      const long long tiles = ((c + kGI - 1) / kGI) * ((3 * f + kGJ - 1) / kGJ);
      p.wsplits = clampi(kWgradBlocks / tiles, 1, (m + kGK - 1) / kGK);
    } else {
      const long long tiles = ((c + kWT - 1) / kWT) * ((3 * f + kWT - 1) / kWT);
      p.wsplits = clampi((512 + tiles - 1) / tiles, 1, (m + 31) / 32);
    }
    const long long b5[5] = {m * c * esz, m * 3 * f * esz, parts * c * 4,
                             (long long)p.wsplits * c * 3 * f * 4, 0};
    for (int i = 0; i < 5; ++i) p.bytes[i] = b5[i];
  }
  for (int i = 0; i < 5; ++i) p.ws_bytes += up256(p.bytes[i]);
  return p;
}

// The plan's regions of the workspace ws, in order.
void carve(const LargePlan& p, void* ws, char* (&region)[5]) {
  char* at = static_cast<char*>(ws);
  for (int i = 0; i < 5; ++i) {
    region[i] = at;
    at += up256(p.bytes[i]);
  }
}

template <typename T>
int bwd_a_cores(const LargePlan& p, const void* x, const void* dy, const float* g_pre,
                const void* wqkv, const void* ctx, const void* wout, const float* bout,
                const float* g_out, float* do_g, float* dctx, float* dwout, float* dbout,
                float* dgout, void* ws, int batch, int n_tok, int c_dim, int heads, int dh,
                cudaStream_t st) {
  const int f = heads * dh;
  char* r[5];
  carve(p, ws, r);
  T* out_g = reinterpret_cast<T*>(r[0]);
  float *dctx_part = reinterpret_cast<float*>(r[1]), *db_part = reinterpret_cast<float*>(r[2]),
        *dg_part = reinterpret_cast<float*>(r[3]), *wg_part = reinterpret_cast<float*>(r[4]);
  size_t bytes;
  const int tn = pick_tile(smem_bwd_a, c_dim, f, dh, bwd_a_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  bwd_a_kernel<T><<<dim3(p.splits, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g_pre, static_cast<const T*>(wqkv),
      static_cast<const T*>(ctx), static_cast<const T*>(wout), bout, g_out, do_g, out_g,
      dctx_part, db_part, dg_part, n_tok, c_dim, f, dh, tn);
  int err = check_last();
  if (err) return err;
  if ((err = sum_parts(dctx_part, dctx, batch, p.splits, f * dh, st))) return err;
  if ((err = sum_parts(db_part, dbout, 1, batch * p.splits, c_dim, st))) return err;
  if ((err = sum_parts(dg_part, dgout, 1, batch * p.splits, c_dim, st))) return err;
  return wgrad<T, T, float>(out_g, do_g, wg_part, dwout, batch * n_tok, f, c_dim, p.wsplits, st);
}

template <typename T>
int bwd_b_cores(const LargePlan& p, const void* x, const void* dy, const float* do_g,
                const float* g_pre, const void* wqkv, const void* ctx, const void* wout,
                const float* kmax, const float* d_a, const float* d_s, void* dx, float* dwqkv,
                float* dgpre, void* ws, int batch, int n_tok, int c_dim, int heads, int dh,
                cudaStream_t st) {
  const int f = heads * dh;
  char* r[5];
  carve(p, ws, r);
  T *xn_g = reinterpret_cast<T*>(r[0]), *dqkv_g = reinterpret_cast<T*>(r[1]);
  float *dg_part = reinterpret_cast<float*>(r[2]), *wg_part = reinterpret_cast<float*>(r[3]);
  size_t bytes;
  const int tn = pick_tile(smem_bwd_b, c_dim, f, dh, bwd_b_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  bwd_b_kernel<T><<<dim3(p.splits, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), do_g, g_pre,
      static_cast<const T*>(wqkv), static_cast<const T*>(ctx), static_cast<const T*>(wout),
      kmax, d_a, d_s, static_cast<T*>(dx), xn_g, dqkv_g, dg_part, n_tok, c_dim, f, dh, tn);
  int err = check_last();
  if (err) return err;
  if ((err = sum_parts(dg_part, dgpre, 1, batch * p.splits, c_dim, st))) return err;
  return wgrad<T, T, T>(xn_g, dqkv_g, wg_part, dwqkv, batch * n_tok, c_dim, 3 * f, p.wsplits, st);
}

template <int NC, bool kPad>
int bwd_a_tc(const LargePlan& p, const bf16* x, const bf16* dy, const float* g_pre,
             const bf16* wqkv, const bf16* ctx, const bf16* wout, const float* bout,
             const float* g_out, float* do_g, float* dctx, float* dwout, float* dbout,
             float* dgout, void* ws, int batch, int n_tok, int c, int vec, cudaStream_t st) {
  constexpr int C = 32 * NC;
  char* r[5];
  carve(p, ws, r);
  float *dctx_part = reinterpret_cast<float*>(r[0]), *db_part = reinterpret_cast<float*>(r[1]),
        *dg_part = reinterpret_cast<float*>(r[2]), *dwout_part = reinterpret_cast<float*>(r[3]);
  int err = allow_smem<bwd_a_tc_kernel<NC, kPad>>(kMaxSmem);
  if (err) return err;
  bwd_a_tc_kernel<NC, kPad><<<dim3(p.splits, batch), kThreads, bwd_a_layout(C).total, st>>>(
      x, dy, g_pre, wqkv, ctx, wout, bout, g_out, do_g, dctx_part, db_part, dg_part, dwout_part,
      n_tok, c, p.splits, vec);
  if ((err = check_last())) return err;
  const int parts = batch * p.splits;
  if ((err = sum_parts(dctx_part, dctx, batch, p.splits, kF * kD, st))) return err;
  if ((err = sum_parts(db_part, dbout, 1, parts, c, st))) return err;
  if ((err = sum_parts(dg_part, dgout, 1, parts, c, st))) return err;
  return sum_parts(dwout_part, dwout, 1, parts, kF * c, st);
}

template <int NC, bool kPad>
int bwd_b_tc(const LargePlan& p, const bf16* x, const bf16* dy, const float* do_g,
             const float* g_pre, const bf16* wqkv, const bf16* ctx, const bf16* wout,
             const float* kmax, const float* d_a, const float* d_s, bf16* dx, float* dwqkv,
             float* dgpre, void* ws, int batch, int n_tok, int c, int vec, cudaStream_t st) {
  constexpr int C = 32 * NC;
  char* r[5];
  carve(p, ws, r);
  bf16 *xn_g = reinterpret_cast<bf16*>(r[0]), *dqkv_g = reinterpret_cast<bf16*>(r[1]);
  float *dg_part = reinterpret_cast<float*>(r[2]), *wg_part = reinterpret_cast<float*>(r[3]);
  int err = allow_smem<bwd_b_tc_kernel<NC, kPad>>(kMaxSmem);
  if (err) return err;
  bwd_b_tc_kernel<NC, kPad><<<dim3(p.splits, batch), kThreads, bwd_b_layout(C).total, st>>>(
      x, dy, do_g, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, dx, xn_g, dqkv_g, dg_part, n_tok, c,
      p.splits, vec);
  if ((err = check_last())) return err;
  if ((err = sum_parts(dg_part, dgpre, 1, batch * p.splits, c, st))) return err;
  // dWqkv [c, 3F] from xn [B N, c] (16-byte rows: c % 8 == 0) and d_qkv;
  // its loads zero-fill and its stores skip the rows past c
  const int m = batch * n_tok;
  const dim3 grid((c + kGI - 1) / kGI, (3 * kF + kGJ - 1) / kGJ, p.wsplits);
  wgrad_tc_kernel<<<grid, kThreads, kGStages * kGStage * 2, st>>>(xn_g, dqkv_g, wg_part, m, c,
                                                                  3 * kF);
  if ((err = check_last())) return err;
  return sum_parts(wg_part, dwqkv, 1, p.wsplits, c * 3 * kF, st);
}

template <typename T>
int ctx_cores(const LargePlan& p, const void* x, const float* g_pre, const void* wqkv,
              float* kmax, float* s, float* a, void* ws, int batch, int n_tok, int c_dim,
              int heads, int dh, cudaStream_t st) {
  const int f = heads * dh;
  char* r[5];
  carve(p, ws, r);
  float *m_part = reinterpret_cast<float*>(r[0]), *s_part = reinterpret_cast<float*>(r[1]),
        *a_part = reinterpret_cast<float*>(r[2]);
  size_t bytes;
  const int tn = pick_tile(smem_ctx_partial, c_dim, f, dh, ctx_partial_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  ctx_partial_kernel<T><<<dim3(p.splits, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), g_pre, static_cast<const T*>(wqkv), m_part, s_part, a_part,
      n_tok, c_dim, f, dh, tn);
  int err = check_last();
  if (err) return err;
  ctx_reduce_kernel<<<batch, kThreads, f * sizeof(float), st>>>(m_part, s_part, a_part, kmax,
                                                                 s, a, p.splits, f, dh);
  return check_last();
}

template <bool kPad>
int ctx_tc(const LargePlan& p, const bf16* x, const float* g_pre, const bf16* wqkv, float* kmax,
           float* s, float* a, void* ws, int batch, int n_tok, int c_dim, int vec,
           cudaStream_t st) {
  float* parts = static_cast<float*>(ws);
  int err = allow_smem<ctx_tc_kernel<kPad>>(kMaxSmem);
  if (err) return err;
  ctx_tc_kernel<kPad><<<dim3(p.splits, batch), kThreads, ctx_layout(pad32(c_dim)).total, st>>>(
      x, g_pre, wqkv, parts, n_tok, c_dim, p.splits, vec);
  if ((err = check_last())) return err;
  ctx_merge_kernel<<<dim3(batch, kF * kD / kThreads), kThreads, 0, st>>>(parts, kmax, s, a,
                                                                       2 * p.splits);
  return check_last();
}

template <typename T>
int out_cores(const void* x, const float* g_pre, const void* wqkv, const void* ctx,
              const void* wout, const float* bout, const float* g_out, void* y, int batch,
              int n_tok, int c_dim, int heads, int dh, cudaStream_t st) {
  const int f = heads * dh;
  size_t bytes;
  const int tn = pick_tile(smem_out_large, c_dim, f, dh, out_large_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  out_large_kernel<T><<<dim3((n_tok + tn - 1) / tn, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), g_pre, static_cast<const T*>(wqkv), static_cast<const T*>(ctx),
      static_cast<const T*>(wout), bout, g_out, static_cast<T*>(y), n_tok, c_dim, f, dh, tn);
  return check_last();
}

template <int NC, bool kPad>
int out_tc(const LargePlan& p, const bf16* x, const float* g_pre, const bf16* wqkv,
           const bf16* ctx, const bf16* wout, const float* bout, const float* g_out, bf16* y,
           int batch, int n_tok, int c, int vec, cudaStream_t st) {
  int err = allow_smem<out_tc_kernel<NC, kPad>>(kMaxSmem);
  if (err) return err;
  out_tc_kernel<NC, kPad><<<dim3(p.splits, batch), kThreads, out_layout(32 * NC).total, st>>>(
      x, g_pre, wqkv, ctx, wout, bout, g_out, y, n_tok, c, p.splits, vec);
  return check_last();
}

// f(NC, kPad), each a std::integral_constant: C's 32-column blocks and
// whether C pads (the tensor route of #3, #4 and #5).
template <int NC, typename F>
int with_pad(bool pad, F& f) {
  return pad ? f(std::integral_constant<int, NC>{}, std::true_type{})
             : f(std::integral_constant<int, NC>{}, std::false_type{});
}

template <typename F>
int by_blocks(int c, F&& f) {
  const bool pad = c % 32 != 0;
  switch (pad32(c) / 32) {
    case 1: return with_pad<1>(pad, f);
    case 2: return with_pad<2>(pad, f);
    case 3: return with_pad<3>(pad, f);
    default: return with_pad<4>(pad, f);
  }
}

}  // namespace

// Interfaces. x, y, dy, dx, ctx and the matrices wqkv [C, 3F] and wout
// [F, C] are in the activation type (bf16 if is_bf16, else f32); g_pre,
// bout, g_out and everything else are f32. H = heads of D = dim_head
// channels, F = H D. a, d_a, ctx, d_ctx are [B, H, D, D]; s, kmax, d_s
// [B, F]. The workspace ws of #2, #4 and #5 holds
// ws_bytes >= what ccdm_attn_large_plan returns for the call (#3 needs
// none). Each launches on `stream` and returns the first cudaError_t it
// meets.

// #2: kmax, s [B, F] and a [B, H, D, D], f32.
extern "C" int ccdm_attn_ctx_large(const void* x, const float* g_pre, const void* wqkv,
                                   float* kmax, float* s, float* a, void* ws, int batch,
                                   int n_tok, int c_dim, int heads, int dim_head, int is_bf16,
                                   long long ws_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LargePlan p = make_large_plan(2, batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (p.route == kRouteNone || ws_bytes < p.ws_bytes || !ws) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteCores)
    return is_bf16 ? ctx_cores<__nv_bfloat16>(p, x, g_pre, wqkv, kmax, s, a, ws, batch, n_tok,
                                              c_dim, heads, dim_head, st)
                   : ctx_cores<float>(p, x, g_pre, wqkv, kmax, s, a, ws, batch, n_tok, c_dim,
                                      heads, dim_head, st);
  const int vec = aligned16(x) && aligned16(wqkv);
  const bf16 *xb = static_cast<const bf16*>(x), *wq = static_cast<const bf16*>(wqkv);
  return c_dim % 32 ? ctx_tc<true>(p, xb, g_pre, wq, kmax, s, a, ws, batch, n_tok, c_dim, vec, st)
                    : ctx_tc<false>(p, xb, g_pre, wq, kmax, s, a, ws, batch, n_tok, c_dim, vec, st);
}

// #3: y [B, N, C] in the activation type.
extern "C" int ccdm_attn_out_large(const void* x, const float* g_pre, const void* wqkv,
                                   const void* ctx, const void* wout, const float* bout,
                                   const float* g_out, void* y, int batch, int n_tok,
                                   int c_dim, int heads, int dim_head, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LargePlan p = make_large_plan(3, batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (p.route == kRouteNone) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteCores)
    return is_bf16 ? out_cores<__nv_bfloat16>(x, g_pre, wqkv, ctx, wout, bout, g_out, y, batch,
                                              n_tok, c_dim, heads, dim_head, st)
                   : out_cores<float>(x, g_pre, wqkv, ctx, wout, bout, g_out, y, batch, n_tok,
                                      c_dim, heads, dim_head, st);
  const int vec = aligned16(x) && aligned16(wqkv) && aligned16(ctx) && aligned16(wout) &&
                  aligned16(y);
  const bf16 *xb = static_cast<const bf16*>(x), *wq = static_cast<const bf16*>(wqkv),
             *cb = static_cast<const bf16*>(ctx), *wo = static_cast<const bf16*>(wout);
  bf16* yb = static_cast<bf16*>(y);
  return by_blocks(c_dim, [&](auto nc, auto pad) {
    return out_tc<decltype(nc)::value, decltype(pad)::value>(p, xb, g_pre, wq, cb, wo, bout, g_out,
                                                             yb, batch, n_tok, c_dim, vec, st);
  });
}

// The plan of one call of #2-#5 (kernel 2 to 5): writes the route (0 CUDA
// cores, 1 tensor cores, -1 an empty shape), the tokens of a tile, the
// blocks per batch row and the weight-gradient launch's token splits to
// out[0..3] (if out is not null); returns the workspace bytes.
extern "C" long long ccdm_attn_large_plan(int kernel, int batch, int n_tok, int c_dim, int heads,
                                        int dim_head, int is_bf16, int* out) {
  const LargePlan p = make_large_plan(kernel, batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (out) {
    out[0] = p.route;
    out[1] = p.tile;
    out[2] = p.splits;
    out[3] = p.wsplits;
  }
  return p.ws_bytes;
}

// #4: do [B, N, C], d_ctx [B, H, D, D], dwout [F, C], dbout, dgout [C], f32.
extern "C" int ccdm_attn_bwd_a(const void* x, const void* dy, const float* g_pre,
                               const void* wqkv, const void* ctx, const void* wout,
                               const float* bout, const float* g_out, float* do_g, float* dctx,
                               float* dwout, float* dbout, float* dgout, void* ws, int batch,
                               int n_tok, int c_dim, int heads, int dim_head, int is_bf16,
                               long long ws_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LargePlan p = make_large_plan(4, batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (p.route == kRouteNone || ws_bytes < p.ws_bytes || !ws) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteCores)
    return is_bf16 ? bwd_a_cores<__nv_bfloat16>(p, x, dy, g_pre, wqkv, ctx, wout, bout, g_out,
                                                do_g, dctx, dwout, dbout, dgout, ws, batch,
                                                n_tok, c_dim, heads, dim_head, st)
                   : bwd_a_cores<float>(p, x, dy, g_pre, wqkv, ctx, wout, bout, g_out, do_g,
                                        dctx, dwout, dbout, dgout, ws, batch, n_tok, c_dim,
                                        heads, dim_head, st);
  const int vec = aligned16(x) && aligned16(wqkv) && aligned16(ctx) && aligned16(wout);
  const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
             *wq = static_cast<const bf16*>(wqkv), *cb = static_cast<const bf16*>(ctx),
             *wo = static_cast<const bf16*>(wout);
  return by_blocks(c_dim, [&](auto nc, auto pad) {
    return bwd_a_tc<decltype(nc)::value, decltype(pad)::value>(
        p, xb, dyb, g_pre, wq, cb, wo, bout, g_out, do_g, dctx, dwout, dbout, dgout, ws, batch,
        n_tok, c_dim, vec, st);
  });
}

// #5: dx [B, N, C] in the activation type, dwqkv [C, 3F], dgpre [C] f32.
extern "C" int ccdm_attn_bwd_b(const void* x, const void* dy, const float* do_g,
                               const float* g_pre, const void* wqkv, const void* ctx,
                               const void* wout, const float* kmax, const float* d_a,
                               const float* d_s, void* dx, float* dwqkv, float* dgpre, void* ws,
                               int batch, int n_tok, int c_dim, int heads, int dim_head,
                               int is_bf16, long long ws_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LargePlan p = make_large_plan(5, batch, n_tok, c_dim, heads, dim_head, is_bf16);
  if (p.route == kRouteNone || ws_bytes < p.ws_bytes || !ws) return (int)cudaErrorInvalidValue;
  if (p.route == kRouteCores)
    return is_bf16 ? bwd_b_cores<__nv_bfloat16>(p, x, dy, do_g, g_pre, wqkv, ctx, wout, kmax,
                                                d_a, d_s, dx, dwqkv, dgpre, ws, batch, n_tok,
                                                c_dim, heads, dim_head, st)
                   : bwd_b_cores<float>(p, x, dy, do_g, g_pre, wqkv, ctx, wout, kmax, d_a, d_s,
                                        dx, dwqkv, dgpre, ws, batch, n_tok, c_dim, heads,
                                        dim_head, st);
  const int vec = aligned16(x) && aligned16(wqkv) && aligned16(ctx) && aligned16(wout);
  const bf16 *xb = static_cast<const bf16*>(x), *dyb = static_cast<const bf16*>(dy),
             *wq = static_cast<const bf16*>(wqkv), *cb = static_cast<const bf16*>(ctx),
             *wo = static_cast<const bf16*>(wout);
  bf16* dxb = static_cast<bf16*>(dx);
  return by_blocks(c_dim, [&](auto nc, auto pad) {
    return bwd_b_tc<decltype(nc)::value, decltype(pad)::value>(
        p, xb, dyb, do_g, g_pre, wq, cb, wo, kmax, d_a, d_s, dxb, dwqkv, dgpre, ws, batch, n_tok,
        c_dim, vec, st);
  });
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

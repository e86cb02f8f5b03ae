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
// Norms, softmaxes and their backward run in f32; every product takes its
// operands rounded to the activation type (bf16 or f32) and accumulates in
// f32, where the TPU kernels feed their MXU. Per-head sums are reduced per
// head directly (the TPU kernels' block-diagonal ones matmul was a Mosaic
// workaround); only the diagonal D x D blocks of ctx exist here.
//
// A TPU grid runs in order and carried its sums over N (a, s, d_ctx) and
// over the whole grid (the weight grads) in VMEM. Hopper blocks run in no
// order, so every sum across blocks is written as per-block partials and
// reduced by a second launch, in a fixed order (deterministic, no atomics):
//   - pass A: each block keeps a running column max of k and rescales its
//     a and s when it grows (as an online softmax does); ctx_reduce merges
//     the blocks' (max, s, a) into the exact kmax and a, s relative to it;
//   - the backward's per-token kernels write the operands of the two weight
//     products (out and do; xn and d_qkv) to device memory, and wgrad, a
//     register-tiled split-K product, reduces them over all B*N tokens.
//
// What bounds them on this card: at the 64x64 training shape (B 128,
// N 4096, C 64, F 128) each pass moves a few hundred MB (~0.1 ms at
// 3.35 TB/s) and does 20-100 GFLOP (~0.02-0.1 ms at 989 TFLOP/s): the
// bound is the tensor cores. This first design keeps every product on the
// CUDA cores (f32 FMAs from shared memory, register tiles of 8 tokens), so
// it is bound by FMA issue; moving the products to wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 32;  // dim_head: one warp lane per head channel
constexpr int kDP = kD + 1;  // padded row of a [F][D] matrix read down a column
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTG = 8;       // tokens per thread in a register tile
constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block
constexpr int kSmemTwoBlocks = 115712;  // per block, with two blocks on an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the operand type of the products and back to f32.
template <typename T>
__device__ __forceinline__ float as_operand(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[t] += a[t] * w for the 8 tokens of a tile row in shared memory.
__device__ __forceinline__ void fma8(float (&acc)[kTG], const float* a, float w) {
  const float4 lo = *reinterpret_cast<const float4*>(a);
  const float4 hi = *reinterpret_cast<const float4*>(a + 4);
  acc[0] = fmaf(lo.x, w, acc[0]);
  acc[1] = fmaf(lo.y, w, acc[1]);
  acc[2] = fmaf(lo.z, w, acc[2]);
  acc[3] = fmaf(lo.w, w, acc[3]);
  acc[4] = fmaf(hi.x, w, acc[4]);
  acc[5] = fmaf(hi.y, w, acc[5]);
  acc[6] = fmaf(hi.z, w, acc[6]);
  acc[7] = fmaf(hi.w, w, acc[7]);
}

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
// one warp per (token, head); tokens past N become zeros.
template <typename T>
__device__ void q_softmax_tile(float* q_t, int tn, int tnp, int valid, int heads) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)kD);
  for (int task = warp; task < tn * heads; task += kWarps) {
    const int i = task / heads;
    const int h = task % heads;
    float* cell = q_t + (h * kD + lane) * tnp + i;
    float qs = 0.f;
    if (i < valid) {  // uniform across the warp
      const float q = *cell;
      const float e = expf(q - warp_max(q));
      qs = as_operand<T>(e / fmaxf(warp_sum(e), 1e-30f) * scale);
    }
    *cell = qs;
  }
}

// Per head h, a tile of F rows times a D x D matrix m ([F][kDP], row h*D + r
// of head h): out_t[h*D + o][t] = sum_i in_t[h*D + i][t] * M[i][o], with
// M[i][o] = m[(h*D + i) * kDP + o], or its transpose if `transpose`;
// rounded to the operand type if `round_out`.
template <typename T>
__device__ void head_product(const float* in_t, const float* m, bool transpose, bool round_out,
                             int tn, int tnp, int f, float* out_t) {
  const int groups = tn / kTG;
  for (int task = threadIdx.x; task < f * groups; task += kThreads) {
    const int col = task % f;
    const int g = task / f;
    const int h = col / kD;
    const int o = col % kD;
    float acc[kTG] = {};
    const float* mh = m + h * kD * kDP;
    const float* ih = in_t + h * kD * tnp + g * kTG;
    for (int i = 0; i < kD; ++i)
      fma8(acc, ih + i * tnp, transpose ? mh[o * kDP + i] : mh[i * kDP + o]);
#pragma unroll
    for (int t = 0; t < kTG; ++t)
      out_t[col * tnp + g * kTG + t] = round_out ? as_operand<T>(acc[t]) : acc[t];
  }
}

// a_t[h*D + e][t] = operand(sum_d qs_t[h*D + d][t] * ctx[h][d][e]).
template <typename T>
__device__ void attn_out_tile(const float* qs_t, const float* ctx_s, int tn, int tnp, int f,
                              float* a_t) {
  head_product<T>(qs_t, ctx_s, false, true, tn, tnp, f, a_t);
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

// ctx_s[f * kDP + e] = ctx[b][f][e] in f32 (ctx is already in operand type).
template <typename T>
__device__ void load_ctx(const T* __restrict__ ctxb, int f, float* ctx_s) {
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads)
    ctx_s[(idx / kD) * kDP + idx % kD] = to_f32(ctxb[idx]);
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
                   int f, int tn) {
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
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) a_s[idx] = 0.f;
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
    for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) {
      const int r = idx / kD;  // k channel h*D + d
      const int e = idx % kD;
      const float* ek = kv_t + r * tnp;
      const float* vv = kv_t + (f + (r / kD) * kD + e) * tnp;
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
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads)
    a_part[(size_t)part * f * kD + idx] = a_s[idx];
}

// Per batch: kmax = max of the splits' maxima; s and a summed in split
// order, each split's share rescaled to kmax. Shared: kmax [F].
__global__ void __launch_bounds__(kThreads)
ctx_reduce_kernel(const float* __restrict__ m_part, const float* __restrict__ s_part,
                  const float* __restrict__ a_part, float* __restrict__ kmax,
                  float* __restrict__ s, float* __restrict__ a, int nsplit, int f) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const float* mb = m_part + (size_t)b * nsplit * f;
  const float* sb = s_part + (size_t)b * nsplit * f;
  const float* ab = a_part + (size_t)b * nsplit * f * kD;
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
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) {
    const int r = idx / kD;
    float acc = 0.f;
    for (int p = 0; p < nsplit; ++p) {
      const float mp = mb[p * f + r];
      if (mp > -INFINITY) acc += ab[(size_t)p * f * kD + idx] * expf(mp - smem[r]);
    }
    a[(size_t)b * f * kD + idx] = acc;
  }
}

// ------------------------------------------------------------ #3: pass B
// Per (token tile, batch): q projection, q softmax, . ctx, . Wout + bout,
// out-norm and the residual. Shared: xn_t [C][tnp], q_t [F][tnp],
// ctx_s [F][kDP], a_t [F][tnp], o_s [tn][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
out_large_kernel(const T* __restrict__ x, const float* __restrict__ g_pre,
                 const T* __restrict__ wqkv, const T* __restrict__ ctx,
                 const T* __restrict__ wout, const float* __restrict__ bout,
                 const float* __restrict__ g_out, T* __restrict__ y, int n_tok, int c_dim, int f,
                 int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  float* xn_t = smem;
  float* q_t = xn_t + align4(c_dim * tnp);
  float* ctx_s = q_t + f * tnp;
  float* a_t = ctx_s + f * kDP;
  float* o_s = a_t + f * tnp;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tn;
  const int valid = n_tok - n0 < tn ? n_tok - n0 : tn;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xb = x + (size_t)b * n_tok * c_dim;

  norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, nullptr, nullptr);
  load_ctx<T>(ctx + (size_t)b * f * kD, f, ctx_s);
  __syncthreads();
  tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, 3 * f, 0, f, q_t);
  __syncthreads();
  q_softmax_tile<T>(q_t, tn, tnp, valid, f / kD);
  __syncthreads();
  attn_out_tile<T>(q_t, ctx_s, tn, tnp, f, a_t);
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
// Shared: xn_t [C][tnp] (then do, operand), q_t [F][tnp], ctx_s [F][kDP],
// a_t [F][tnp], o_s [tn][C] (then do, f32), dyon_s [tn][C],
// dout_t [F][tnp], dctx_s [F][D], db_s, dg_s [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_a_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ g_pre,
             const T* __restrict__ wqkv, const T* __restrict__ ctx, const T* __restrict__ wout,
             const float* __restrict__ bout, const float* __restrict__ g_out,
             float* __restrict__ do_g, T* __restrict__ out_g, float* __restrict__ dctx_part,
             float* __restrict__ db_part, float* __restrict__ dg_part, int n_tok, int c_dim,
             int f, int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  float* xn_t = smem;
  float* q_t = xn_t + align4(c_dim * tnp);
  float* ctx_s = q_t + f * tnp;
  float* a_t = ctx_s + f * kDP;
  float* o_s = a_t + f * tnp;
  float* dyon_s = o_s + align4(tn * c_dim);
  float* dout_t = dyon_s + align4(tn * c_dim);
  float* dctx_s = dout_t + f * tnp;
  float* db_s = dctx_s + f * kD;
  float* dg_s = db_s + align4(c_dim);
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int part = b * gridDim.x + split;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* xb = x + (size_t)b * n_tok * c_dim;
  int begin, end;
  split_range(split, gridDim.x, n_tok, &begin, &end);

  load_ctx<T>(ctx + (size_t)b * f * kD, f, ctx_s);
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) dctx_s[idx] = 0.f;
  for (int c = threadIdx.x; c < c_dim; c += kThreads) db_s[c] = dg_s[c] = 0.f;
  __syncthreads();

  for (int n0 = begin; n0 < end; n0 += tn) {
    const int valid = end - n0 < tn ? end - n0 : tn;
    norm_tile<T>(xb, g_pre, n0, valid, tn, tnp, c_dim, xn_t, nullptr, nullptr);
    __syncthreads();
    tile_times_w<T>(xn_t, c_dim, tn, tnp, wqkv, 3 * f, 0, f, q_t);
    __syncthreads();
    q_softmax_tile<T>(q_t, tn, tnp, valid, f / kD);
    __syncthreads();
    attn_out_tile<T>(q_t, ctx_s, tn, tnp, f, a_t);
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
    for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) {
      const int r = idx / kD;
      const float* qr = q_t + r * tnp;
      const float* dr = dout_t + ((r / kD) * kD + idx % kD) * tnp;
      float acc = dctx_s[idx];
      for (int t = 0; t < tn; ++t) acc = fmaf(qr[t], dr[t], acc);
      dctx_s[idx] = acc;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads)
    dctx_part[(size_t)part * f * kD + idx] = dctx_s[idx];
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
// x_t (d_qs) and y_t (d_e, then d_k) [F][tnp], ctx_s and da_s [F][kDP],
// kmax_s and ds_s [F], dxn_s [tn][C], dg_s [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_b_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ do_g,
             const float* __restrict__ g_pre, const T* __restrict__ wqkv,
             const T* __restrict__ ctx, const T* __restrict__ wout,
             const float* __restrict__ kmax, const float* __restrict__ d_a,
             const float* __restrict__ d_s, T* __restrict__ dx, T* __restrict__ xn_g,
             T* __restrict__ dqkv_g, float* __restrict__ dg_part, int n_tok, int c_dim, int f,
             int tn) {
  extern __shared__ __align__(16) float smem[];
  const int tnp = tn + 4;
  const int f3 = 3 * f;
  const int heads = f / kD;
  float* xn_t = smem;
  float* xf_s = xn_t + align4(c_dim * tnp);
  float* inv_s = xf_s + align4(tn * c_dim);
  float* qkv_t = inv_s + tn;
  float* dout_t = qkv_t + f3 * tnp;
  float* x_t = dout_t + f * tnp;
  float* y_t = x_t + f * tnp;
  float* ctx_s = y_t + f * tnp;
  float* da_s = ctx_s + f * kDP;
  float* kmax_s = da_s + f * kDP;
  float* ds_s = kmax_s + f;
  float* dxn_s = ds_s + f;
  float* dg_s = dxn_s + align4(tn * c_dim);
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int part = b * gridDim.x + split;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)kD);
  const T* xb = x + (size_t)b * n_tok * c_dim;
  int begin, end;
  split_range(split, gridDim.x, n_tok, &begin, &end);

  load_ctx<T>(ctx + (size_t)b * f * kD, f, ctx_s);
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads)
    da_s[(idx / kD) * kDP + idx % kD] = d_a[(size_t)b * f * kD + idx];
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
    head_product<T>(dout_t, ctx_s, true, false, tn, tnp, f, x_t);
    head_product<T>(qkv_t + 2 * f * tnp, da_s, true, false, tn, tnp, f, y_t);
    __syncthreads();
    // q rows <- operand(d_q), d_q = p (d_p - sum_h d_p p), d_p = d_qs D^-1/2,
    // p = softmax of the head's q: one thread per (token, head)
    for (int task = threadIdx.x; task < tn * heads; task += kThreads) {
      const int t = task % tn;
      float* q = qkv_t + (task / tn) * kD * tnp + t;
      const float* dqs = x_t + (task / tn) * kD * tnp + t;
      if (t < valid) {
        float mx = -INFINITY;
        for (int d = 0; d < kD; ++d) mx = fmaxf(mx, q[d * tnp]);
        float sum = 0.f;
        for (int d = 0; d < kD; ++d) {
          q[d * tnp] = expf(q[d * tnp] - mx);
          sum += q[d * tnp];
        }
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        float pg = 0.f;
        for (int d = 0; d < kD; ++d) {
          q[d * tnp] *= inv;
          pg = fmaf(dqs[d * tnp] * scale, q[d * tnp], pg);
        }
        for (int d = 0; d < kD; ++d)
          q[d * tnp] = as_operand<T>(q[d * tnp] * (dqs[d * tnp] * scale - pg));
      } else {
        for (int d = 0; d < kD; ++d) q[d * tnp] = 0.f;
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
    head_product<T>(dout_t, da_s, false, true, tn, tnp, f, qkv_t + 2 * f * tnp);
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

// --------------------------------------------------- the weight products
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

// ------------------------------------------------------------- launches
// Shared-memory floats of each per-token kernel for a tile of tn tokens.
int smem_ctx_partial(int c, int f, int tn) {
  return align4(c * (tn + 4)) + 2 * f * (tn + 4) + 3 * f + f * kD;
}
int smem_out_large(int c, int f, int tn) {
  return align4(c * (tn + 4)) + 2 * f * (tn + 4) + f * kDP + tn * c;
}
int smem_bwd_a(int c, int f, int tn) {
  return align4(c * (tn + 4)) + 3 * f * (tn + 4) + f * kDP + 2 * align4(tn * c) + f * kD +
         2 * align4(c);
}
int smem_bwd_b(int c, int f, int tn) {
  return align4(c * (tn + 4)) + 2 * align4(tn * c) + tn + 6 * f * (tn + 4) + 2 * f * kDP +
         2 * f + align4(c);
}

// The largest tile of 32, 16 or 8 tokens whose shared memory lets two
// blocks share an SM (latency hiding for these FMA loops); else the
// largest that fits one block; else 0.
template <typename K>
int pick_tile(int (*floats)(int, int, int), int c, int f, K kernel, size_t* bytes) {
  const size_t limits[2] = {(size_t)kSmemTwoBlocks, (size_t)kSmemLimit};
  for (size_t limit : limits)
    for (int tn = 32; tn >= 8; tn /= 2) {
      *bytes = (size_t)floats(c, f, tn) * sizeof(float);
      if (*bytes <= limit) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)*bytes) != cudaSuccess)
          return 0;
        return tn;
      }
    }
  return 0;
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

template <typename T>
int ctx_large(const void* x, const float* g_pre, const void* wqkv, float* m_part,
              float* s_part, float* a_part, float* kmax, float* s, float* a, int batch,
              int n_tok, int c_dim, int heads, int nsplit, cudaStream_t st) {
  const int f = heads * kD;
  size_t bytes;
  const int tn = pick_tile(smem_ctx_partial, c_dim, f, ctx_partial_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  ctx_partial_kernel<T><<<dim3(nsplit, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), g_pre, static_cast<const T*>(wqkv), m_part, s_part, a_part,
      n_tok, c_dim, f, tn);
  int err = check_last();
  if (err) return err;
  ctx_reduce_kernel<<<batch, kThreads, f * sizeof(float), st>>>(m_part, s_part, a_part, kmax,
                                                                 s, a, nsplit, f);
  return check_last();
}

template <typename T>
int out_large(const void* x, const float* g_pre, const void* wqkv, const void* ctx,
              const void* wout, const float* bout, const float* g_out, void* y, int batch,
              int n_tok, int c_dim, int heads, cudaStream_t st) {
  const int f = heads * kD;
  size_t bytes;
  const int tn = pick_tile(smem_out_large, c_dim, f, out_large_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  out_large_kernel<T><<<dim3((n_tok + tn - 1) / tn, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), g_pre, static_cast<const T*>(wqkv), static_cast<const T*>(ctx),
      static_cast<const T*>(wout), bout, g_out, static_cast<T*>(y), n_tok, c_dim, f, tn);
  return check_last();
}

template <typename T>
int bwd_a(const void* x, const void* dy, const float* g_pre, const void* wqkv, const void* ctx,
          const void* wout, const float* bout, const float* g_out, float* do_g, void* out_g,
          float* dctx_part, float* db_part, float* dg_part, float* wg_part, float* dctx,
          float* dwout, float* dbout, float* dgout, int batch, int n_tok, int c_dim, int heads,
          int nsplit, int nsplit_w, cudaStream_t st) {
  const int f = heads * kD;
  size_t bytes;
  const int tn = pick_tile(smem_bwd_a, c_dim, f, bwd_a_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  bwd_a_kernel<T><<<dim3(nsplit, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g_pre, static_cast<const T*>(wqkv),
      static_cast<const T*>(ctx), static_cast<const T*>(wout), bout, g_out, do_g,
      static_cast<T*>(out_g), dctx_part, db_part, dg_part, n_tok, c_dim, f, tn);
  int err = check_last();
  if (err) return err;
  if ((err = sum_parts(dctx_part, dctx, batch, nsplit, f * kD, st))) return err;
  if ((err = sum_parts(db_part, dbout, 1, batch * nsplit, c_dim, st))) return err;
  if ((err = sum_parts(dg_part, dgout, 1, batch * nsplit, c_dim, st))) return err;
  return wgrad<T, T, float>(static_cast<const T*>(out_g), do_g, wg_part, dwout,
                            batch * n_tok, f, c_dim, nsplit_w, st);
}

template <typename T>
int bwd_b(const void* x, const void* dy, const float* do_g, const float* g_pre,
          const void* wqkv, const void* ctx, const void* wout, const float* kmax,
          const float* d_a, const float* d_s, void* dx, void* xn_g, void* dqkv_g,
          float* dg_part, float* wg_part, float* dwqkv, float* dgpre, int batch, int n_tok,
          int c_dim, int heads, int nsplit, int nsplit_w, cudaStream_t st) {
  const int f = heads * kD;
  size_t bytes;
  const int tn = pick_tile(smem_bwd_b, c_dim, f, bwd_b_kernel<T>, &bytes);
  if (!tn) return (int)cudaErrorInvalidValue;
  bwd_b_kernel<T><<<dim3(nsplit, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), do_g, g_pre,
      static_cast<const T*>(wqkv), static_cast<const T*>(ctx), static_cast<const T*>(wout),
      kmax, d_a, d_s, static_cast<T*>(dx), static_cast<T*>(xn_g), static_cast<T*>(dqkv_g),
      dg_part, n_tok, c_dim, f, tn);
  int err = check_last();
  if (err) return err;
  if ((err = sum_parts(dg_part, dgpre, 1, batch * nsplit, c_dim, st))) return err;
  return wgrad<T, T, T>(static_cast<const T*>(xn_g), static_cast<const T*>(dqkv_g), wg_part,
                        dwqkv, batch * n_tok, c_dim, 3 * f, nsplit_w, st);
}

}  // namespace

// Interfaces. x, y, dy, dx, ctx, the matrices wqkv [C, 3F] and wout [F, C]
// and the scratch out_g [B, N, F], xn_g [B, N, C], dqkv_g [B, N, 3F] are in
// the activation type (bf16 if is_bf16, else f32); g_pre, bout, g_out and
// everything else are f32. a, d_a, ctx, d_ctx are [B, H, 32, 32]; s, kmax,
// d_s [B, F]. The *_part buffers are per-block partials: [B * nsplit, ...]
// for the per-token kernels, [nsplit_w, rows, cols] for the weight grads.
// Each launches on `stream` and returns the first cudaError_t it meets.

extern "C" int ccdm_attn_ctx_large(const void* x, const float* g_pre, const void* wqkv,
                                   float* m_part, float* s_part, float* a_part, float* kmax,
                                   float* s, float* a, int batch, int n_tok, int c_dim,
                                   int heads, int nsplit, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctx_large<__nv_bfloat16>(x, g_pre, wqkv, m_part, s_part, a_part, kmax, s, a, batch,
                                    n_tok, c_dim, heads, nsplit, st);
  return ctx_large<float>(x, g_pre, wqkv, m_part, s_part, a_part, kmax, s, a, batch, n_tok,
                          c_dim, heads, nsplit, st);
}

extern "C" int ccdm_attn_out_large(const void* x, const float* g_pre, const void* wqkv,
                                   const void* ctx, const void* wout, const float* bout,
                                   const float* g_out, void* y, int batch, int n_tok,
                                   int c_dim, int heads, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return out_large<__nv_bfloat16>(x, g_pre, wqkv, ctx, wout, bout, g_out, y, batch, n_tok,
                                    c_dim, heads, st);
  return out_large<float>(x, g_pre, wqkv, ctx, wout, bout, g_out, y, batch, n_tok, c_dim,
                          heads, st);
}

extern "C" int ccdm_attn_bwd_a(const void* x, const void* dy, const float* g_pre,
                               const void* wqkv, const void* ctx, const void* wout,
                               const float* bout, const float* g_out, float* do_g, void* out_g,
                               float* dctx_part, float* db_part, float* dg_part,
                               float* wg_part, float* dctx, float* dwout, float* dbout,
                               float* dgout, int batch, int n_tok, int c_dim, int heads,
                               int nsplit, int nsplit_w, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_a<__nv_bfloat16>(x, dy, g_pre, wqkv, ctx, wout, bout, g_out, do_g, out_g,
                                dctx_part, db_part, dg_part, wg_part, dctx, dwout, dbout,
                                dgout, batch, n_tok, c_dim, heads, nsplit, nsplit_w, st);
  return bwd_a<float>(x, dy, g_pre, wqkv, ctx, wout, bout, g_out, do_g, out_g, dctx_part,
                      db_part, dg_part, wg_part, dctx, dwout, dbout, dgout, batch, n_tok,
                      c_dim, heads, nsplit, nsplit_w, st);
}

extern "C" int ccdm_attn_bwd_b(const void* x, const void* dy, const float* do_g,
                               const float* g_pre, const void* wqkv, const void* ctx,
                               const void* wout, const float* kmax, const float* d_a,
                               const float* d_s, void* dx, void* xn_g, void* dqkv_g,
                               float* dg_part, float* wg_part, float* dwqkv, float* dgpre,
                               int batch, int n_tok, int c_dim, int heads, int nsplit,
                               int nsplit_w, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_b<__nv_bfloat16>(x, dy, do_g, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, dx, xn_g,
                                dqkv_g, dg_part, wg_part, dwqkv, dgpre, batch, n_tok, c_dim,
                                heads, nsplit, nsplit_w, st);
  return bwd_b<float>(x, dy, do_g, g_pre, wqkv, ctx, wout, kmax, d_a, d_s, dx, xn_g, dqkv_g,
                      dg_part, wg_part, dwqkv, dgpre, batch, n_tok, c_dim, heads, nsplit,
                      nsplit_w, st);
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

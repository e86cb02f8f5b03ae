// Fused linear-attention block for Hopper (sm_90a).
//
// Replaces the TPU kernel ccdm_tpu/ops/attn_block.py:_kernel (launched by
// _forward_pallas). For x [B, N, C] and F = heads * 32:
//
//   y = x + RMSNorm_gout(Wout . LA(Wqkv . RMSNorm_gpre(x)) + bout)
//
// LA is the linear attention: q is softmaxed over each head's D = 32 channels
// and scaled by D^-1/2; k is softmaxed over the N tokens, per channel;
// ctx_h = k'_h^T v_h is D x D per head; out = q'_h . ctx_h. Norms and
// softmaxes are in f32. Every product takes its operands rounded to the
// activation type (bf16 or f32) and accumulates in f32, which is the
// contract of the TPU kernel's bf16 MXU products: the product of two bf16
// values is exact in f32.
//
// What bounds it on this card: at the 64x64 level (N 4096, C 64, F 128,
// B 64, bf16) the function moves 2*B*N*C*2 bytes (~67 MB, ~20 us at
// 3.35 TB/s) and does 2*B*N*(3CF + 2FD + FC) operations (~21.5 GFLOP, ~22 us
// at the 989 TFLOP/s bf16 tensor-core rate): it sits on the ridge, so a fast
// version needs both the tensor cores and no intermediate in device memory.
//
// This first design is the simple one and is bound by neither: its products
// run on the CUDA cores (f32 FMAs from shared memory, a register tile of
// 8 tokens per thread), and it sends two intermediates through device memory:
//   - the qkv projection, [B, N, 3F] in f32, written by launch 1 and read
//     by launches 2 (k and v) and 3 (q);
//   - the per-head context, [B, H, D, D] in f32, from launch 2 to launch 3.
// Blocks on Hopper cannot carry the sum over N across the grid as the TPU
// kernel's one cell did, so the softmax over tokens is its own launch:
//   1. qkv_kernel, per (32-token tile, batch): pre-norm, then x . Wqkv;
//   2. ctx_kernel, per (head, batch): exact column max of k over N, then
//      ctx = sum_n exp(k - max) v / sum_n exp(k - max);
//   3. out_kernel, per (32-token tile, batch): per-head softmax of q (with
//      the head's own max), . ctx, . Wout + bout, out-norm, + x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 32;         // dim_head: one warp lane per head channel
constexpr int kTN = 32;        // tokens per block in launches 1 and 3
constexpr int kTNP = kTN + 4;  // padded row of a transposed [*, kTN] tile (float4-aligned)
constexpr int kTG = 8;         // tokens per thread in the register tile
constexpr int kTK = 64;        // tokens per shared-memory tile in launch 2
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == 8 * kD, "ctx_kernel maps 8 threads to each row of ctx");
static_assert(kTN % kTG == 0 && kTG == 8, "fma8 reads a tile of 8 tokens");

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

// Launch 2: per (head, batch), ctx[d][e] = sum_n softmax_N(k)[n][d] v[n][e].
__global__ void __launch_bounds__(kThreads)
ctx_kernel(const float* __restrict__ qkv, float* __restrict__ ctx, int n_tok, int f) {
  __shared__ __align__(16) float e_s[kTK][kD];
  __shared__ __align__(16) float v_s[kTK][kD];
  __shared__ float red[kWarps][kD];
  __shared__ float kmax[kD];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int heads = gridDim.x;
  const int f3 = 3 * f;
  const int kcol = f + h * kD;
  const int vcol = 2 * f + h * kD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* base = qkv + (size_t)b * n_tok * f3;

  // exact column max of k over all tokens
  float m = -INFINITY;
  for (int n = warp; n < n_tok; n += kWarps) m = fmaxf(m, base[(size_t)n * f3 + kcol + lane]);
  red[warp][lane] = m;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w][lane]);
    kmax[lane] = m;
  }
  __syncthreads();

  const int d = threadIdx.x >> 3;        // row of ctx: a channel of k
  const int e0 = (threadIdx.x & 7) * 4;  // four columns of ctx: channels of v
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float s = 0.f;
  for (int n0 = 0; n0 < n_tok; n0 += kTK) {
    const int rows = min(kTK, n_tok - n0);
    for (int idx = threadIdx.x; idx < rows * kD; idx += kThreads) {
      const int r = idx / kD;
      const int cc = idx % kD;
      const float* row = base + (size_t)(n0 + r) * f3;
      e_s[r][cc] = expf(row[kcol + cc] - kmax[cc]);
      v_s[r][cc] = row[vcol + cc];
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float k = e_s[r][d];
      const float4 v = *reinterpret_cast<const float4*>(&v_s[r][e0]);
      s += k;
      acc[0] = fmaf(k, v.x, acc[0]);
      acc[1] = fmaf(k, v.y, acc[1]);
      acc[2] = fmaf(k, v.z, acc[2]);
      acc[3] = fmaf(k, v.w, acc[3]);
    }
    __syncthreads();
  }
  float* out = ctx + ((size_t)b * heads + h) * kD * kD + d * kD + e0;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = acc[i] / s;
}

// Launch 3: per 32 tokens, y = x + RMSNorm_gout((q' . ctx) . Wout + bout).
// Dynamic shared memory, f32: q' transposed [F][kTNP], ctx [H][D][D], the
// attention output transposed [F][kTNP], the out projection [kTN][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
out_kernel(const T* __restrict__ x, const float* __restrict__ qkv,
           const float* __restrict__ ctx, const T* __restrict__ wout,
           const T* __restrict__ bout, const T* __restrict__ g_out,
           T* __restrict__ y, int n_tok, int c_dim, int f) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;
  float* ctx_s = q_t + f * kTNP;
  float* a_t = ctx_s + f * kD;
  float* o_s = a_t + f * kTNP;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTN;
  const int heads = f / kD;
  const int f3 = 3 * f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)kD);

  // q': one warp per (token, head), one lane per channel of the head
  for (int task = warp; task < kTN * heads; task += kWarps) {
    const int i = task / heads;
    const int h = task % heads;
    const int n = n0 + i;
    float qs = 0.f;
    if (n < n_tok) {  // uniform across the warp
      const float q = qkv[((size_t)b * n_tok + n) * f3 + h * kD + lane];
      const float e = expf(q - warp_max(q));
      qs = as_operand<T>(e / fmaxf(warp_sum(e), 1e-30f) * scale);
    }
    q_t[(h * kD + lane) * kTNP + i] = qs;
  }
  const float* cb = ctx + (size_t)b * heads * kD * kD;
  for (int idx = threadIdx.x; idx < f * kD; idx += kThreads) ctx_s[idx] = as_operand<T>(cb[idx]);
  __syncthreads();

  constexpr int kGroups = kTN / kTG;
  // a[i][h*D + e] = sum_d q'[i][h*D + d] ctx[h][d][e]
  for (int task = threadIdx.x; task < f * kGroups; task += kThreads) {
    const int col = task % f;
    const int g = task / f;
    const int h = col / kD;
    const int e = col % kD;
    float acc[kTG] = {};
    const float* ch = ctx_s + h * kD * kD + e;
    const float* qh = q_t + h * kD * kTNP + g * kTG;
    for (int dd = 0; dd < kD; ++dd) fma8(acc, qh + dd * kTNP, ch[dd * kD]);
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

template <typename T>
int launch(const void* x, const void* g_pre, const void* wqkv, const void* wout,
           const void* bout, const void* g_out, void* y, void* qkv, void* ctx,
           int batch, int n_tok, int c_dim, int heads, cudaStream_t stream) {
  const int f = heads * kD;
  const dim3 tok_grid((n_tok + kTN - 1) / kTN, batch);
  const size_t smem_qkv = (size_t)c_dim * kTNP * sizeof(float);
  const size_t smem_out =
      ((size_t)2 * f * kTNP + (size_t)f * kD + (size_t)kTN * c_dim) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_qkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_out);
  if (err != cudaSuccess) return (int)err;

  qkv_kernel<T><<<tok_grid, kThreads, smem_qkv, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g_pre), static_cast<const T*>(wqkv),
      static_cast<float*>(qkv), n_tok, c_dim, 3 * f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ctx_kernel<<<dim3(heads, batch), kThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(ctx), n_tok, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  out_kernel<T><<<tok_grid, kThreads, smem_out, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(qkv), static_cast<const float*>(ctx),
      static_cast<const T*>(wout), static_cast<const T*>(bout), static_cast<const T*>(g_out),
      static_cast<T*>(y), n_tok, c_dim, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, N, C] and the weights in one type (bf16 if is_bf16, else f32);
// qkv [B, N, 3F] and ctx [B, H, 32, 32] are f32 scratch. Launches on
// `stream` and returns the cudaError_t of the last launch check.
extern "C" int ccdm_attn_block_forward(const void* x, const void* g_pre, const void* wqkv,
                                       const void* wout, const void* bout, const void* g_out,
                                       void* y, void* qkv, void* ctx, int batch, int n_tok,
                                       int c_dim, int heads, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, g_pre, wqkv, wout, bout, g_out, y, qkv, ctx, batch, n_tok,
                                 c_dim, heads, s);
  return launch<float>(x, g_pre, wqkv, wout, bout, g_out, y, qkv, ctx, batch, n_tok, c_dim,
                       heads, s);
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

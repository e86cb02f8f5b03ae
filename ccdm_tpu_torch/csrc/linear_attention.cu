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
// Here each block works on one head and forms only its D x D block (4x fewer
// products at H 4). Entry points:
//   ccdm_la_fulllane (#6, _kernel_fulllane), two launches:
//     1. per (head, batch): the exact column max and sum of exp(k - max) over
//        N (one online sweep), then ctx = k'^T v with k' = exp(k - max) / sum
//        (a second sweep), written [B, H, D, D] in the operand type;
//     2. per (64 tokens, head, batch): q', then q' . ctx.
//   ccdm_la_ctx_twopass (#7, _kernel_ctx_twopass): given m = colmax(k) [B, F]
//     f32, per (chunk of tokens, head, batch) the partial a = exp(k - m)^T v
//     and s = sum exp(k - m); a second launch sums the partials over the
//     chunks in their order (no atomics) into a [B, H, D, D] and s [B, F], f32.
//   ccdm_la_out_twopass (#8, _kernel_out_twopass): launch 2 of #6 on a context
//     the caller finalised (a / s, in the operand type).
//   ccdm_la_per_head (#9, _kernel): one block per (batch, head) does all of it
//     in f32, sweeping N three times (column max and sum, ctx, out).
// Rounding points on the bf16 path follow each TPU kernel: #6 rounds k', v, ctx
// and q' to bf16 for its products; #7 rounds exp(k - m) and v (s sums the
// unrounded values); #8 rounds q'; #9 rounds only the output. Products
// accumulate in f32.
//
// What bounds them on this card: at B 64, N 4096, F 128 in bf16, #6 and #9
// must read q, k, v and write out (268 MB, 80 us at 3.35 TB/s) and do 4 B N F D
// products (4.3 GFLOP, 4.3 us at the bf16 tensor-core rate): bytes. #7 and #8
// each move half of that. This first design runs the products on the CUDA
// cores from shared memory, and #6 reads k twice (the max-and-sum sweep, then
// the product sweep).
//
// D may be any size up to 128: the kernels are instantiated for a padded width
// DP in {16, 32, 64, 128} and hold zeros in the channels past D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;  // tokens per shared-memory tile of a context sweep
constexpr int kTN = 64;  // tokens per block of the out pass

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

// Round to the operand type of a product and back to f32.
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

// Calls fn with std::integral_constant<int, DP> for the padded width of d.
template <typename Fn>
int with_width(int d, Fn&& fn) {
  if (d <= 16) return fn(std::integral_constant<int, 16>());
  if (d <= 32) return fn(std::integral_constant<int, 32>());
  if (d <= 64) return fn(std::integral_constant<int, 64>());
  return fn(std::integral_constant<int, 128>());
}

// Raises Kernel's dynamic shared-memory limit to `bytes` once per device: the
// size depends only on the instantiation's width DP, so later launches skip
// the call.
template <auto Kernel>
int allow_smem(size_t bytes) {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return 0;
  err = (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
  if (!err) done.fetch_or(bit, std::memory_order_release);
  return err;
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

// q, k, v, out [B, N, H, d] and ctx [B, H, d, d] scratch, all bf16 if is_bf16,
// else f32 (#6). Every entry point launches on `stream` and returns the
// cudaError_t of its last launch check.
extern "C" int ccdm_la_fulllane(const void* q, const void* k, const void* v, void* ctx,
                                void* out, int batch, int n_tok, int heads, int d, int is_bf16,
                                void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_fulllane<__nv_bfloat16, DP>(q, k, v, ctx, out, batch, n_tok, heads,
                                                        d, st)
                   : launch_fulllane<float, DP>(q, k, v, ctx, out, batch, n_tok, heads, d, st);
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
// is_bf16, else f32.
extern "C" int ccdm_la_out_twopass(const void* q, const void* ctx, void* out, int batch,
                                   int n_tok, int heads, int d, int is_bf16, void* stream) {
  if (bad_shape(batch, n_tok, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_width(d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return is_bf16 ? launch_out<__nv_bfloat16, DP>(q, ctx, out, batch, n_tok, heads, d, st)
                   : launch_out<float, DP>(q, ctx, out, batch, n_tok, heads, d, st);
  });
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

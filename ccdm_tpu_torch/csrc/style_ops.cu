// Fused bias + activation + gain + clamp for Hopper (sm_90a): kernel #12.
//
// Replaces the TPU kernel ccdm_tpu/ops/style_ops.py:_bias_act_pallas. Over
// x [rows, C] (the channels last), with b [C] or no bias:
//
//   y = clamp(gain * act(x + b, alpha), -clamp, clamp)
//
// for one of nine activations (linear, relu, lrelu, tanh, sigmoid, elu, selu,
// softplus, swish); gain is applied where it is not 1 and the clamp where it
// is >= 0, as in JAX. Each value is computed in f32 and rounded once to x's
// type (JAX rounds after each operation in x's type: in bf16 the two differ by
// up to about two units in the last place).
//
// What bounds it on this card: it reads x once and writes y once (2 bytes each
// in bf16) and does a few operations an element: bytes, by far. So each
// thread moves 16 bytes each way (8 bf16 or 4 f32 values of one row) with one
// vector load and one vector store; rows whose width is not a multiple of
// that, or a tensor not 16-byte aligned, take one value a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;
constexpr float kSeluScale = 1.0507009873554804934193349852946f;

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

// The activations of ccdm_tpu/ops/style_ops.py:activation_funcs, in their order.
__device__ __forceinline__ float activate(int act, float x, float alpha) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);                               // relu
    case 2: return x >= 0.f ? x : x * alpha;                     // lrelu
    case 3: return tanhf(x);                                     // tanh
    case 4: return 1.f / (1.f + expf(-x));                       // sigmoid
    case 5: return x > 0.f ? x : expm1f(x);                      // elu
    case 6: return kSeluScale * (x > 0.f ? x : kSeluAlpha * expm1f(x));  // selu
    case 7: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));     // softplus
    case 8: return 1.f / (1.f + expf(-x)) * x;                   // swish
    default: return x;                                           // linear
  }
}

// One thread per VEC consecutive values of a row: n_vec = rows * C / VEC,
// C % VEC == 0.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ y,
                long long n_vec, int c, int act, float alpha, float gain, float clamp) {
  struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
  };
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  Pack p = reinterpret_cast<const Pack*>(x)[i];
  const int c0 = (int)((i * VEC) % c);
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    float v = to_f32(p.v[u]);
    if (bias != nullptr) v += to_f32(bias[c0 + u]);
    v = activate(act, v, alpha);
    if (gain != 1.f) v *= gain;
    if (clamp >= 0.f) v = fminf(fmaxf(v, -clamp), clamp);
    p.v[u] = from_f32<T>(v);
  }
  reinterpret_cast<Pack*>(y)[i] = p;
}

template <typename T, int VEC>
int launch(const void* x, const void* bias, void* y, long long n, int c, int act, float alpha,
           float gain, float clamp, cudaStream_t stream) {
  const long long n_vec = n / VEC;
  if (n_vec == 0) return 0;
  bias_act_kernel<T, VEC><<<dim3((unsigned)((n_vec + kThreads - 1) / kThreads)), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<T*>(y), n_vec, c, act,
      alpha, gain, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [n / c, c] and bias [c] (or null), bf16 if is_bf16, else f32; act is
// the index of the activation (0 linear ... 8 swish); clamp < 0 means none.
// vec 1 takes one value a thread; vec 0 takes 16 bytes a thread, and then c
// must be a multiple of 8 (bf16) or 4 (f32) and x, y 16-byte aligned.
// Launches on `stream` and returns the cudaError_t of the launch check.
extern "C" int ccdm_bias_act(const void* x, const void* bias, void* y, long long n, int c,
                             int act, float alpha, float gain, float clamp, int vec,
                             int is_bf16, void* stream) {
  if (n < 0 || c < 1 || n % c != 0 || act < 0 || act > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec == 1) return launch<__nv_bfloat16, 1>(x, bias, y, n, c, act, alpha, gain, clamp, s);
    if (c % 8 != 0) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, 8>(x, bias, y, n, c, act, alpha, gain, clamp, s);
  }
  if (vec == 1) return launch<float, 1>(x, bias, y, n, c, act, alpha, gain, clamp, s);
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  return launch<float, 4>(x, bias, y, n, c, act, alpha, gain, clamp, s);
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

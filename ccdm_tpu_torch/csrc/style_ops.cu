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
// in bf16) and does a few operations an element: bytes, by far
// ([65536, 256] bf16: 67 MB, 20 us at 3.35 TB/s). So each thread moves 16
// bytes each way per pack (8 bf16 or 4 f32 values of one row) and keeps
// kPacks packs in flight: it issues all their loads before the first store.
// The activation is a template parameter, switched once per launch; the
// index math is 32-bit where the tensor allows; each thread computes its
// first pack's column once and steps it by the block's stride. Rows whose
// width is not a multiple of the pack, or a tensor not 16-byte aligned, take
// one value a pack.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPacks = 4;  // packs a thread keeps in flight
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;
constexpr float kSeluScale = 1.0507009873554804934193349852946f;

// The activations of ccdm_tpu/ops/style_ops.py:activation_funcs, in their order.
template <int ACT>
__device__ __forceinline__ float activate(float x, float alpha) {
  if constexpr (ACT == 1) return fmaxf(x, 0.f);                               // relu
  else if constexpr (ACT == 2) return x >= 0.f ? x : x * alpha;               // lrelu
  else if constexpr (ACT == 3) return tanhf(x);                               // tanh
  else if constexpr (ACT == 4) return 1.f / (1.f + expf(-x));                 // sigmoid
  else if constexpr (ACT == 5) return x > 0.f ? x : expm1f(x);                // elu
  else if constexpr (ACT == 6) return kSeluScale * (x > 0.f ? x : kSeluAlpha * expm1f(x));  // selu
  else if constexpr (ACT == 7) return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // softplus
  else if constexpr (ACT == 8) return 1.f / (1.f + expf(-x)) * x;             // swish
  else return x;                                                              // linear
}

// Thread t of block b takes packs b * kThreads * kPacks + u * kThreads + t,
// u < kPacks, of VEC consecutive values of a row each: n_vec = rows * C / VEC,
// C % VEC == 0. I is the index type (int where rows * C allows).
template <typename T, int VEC, int ACT, typename I>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ y,
                I n_vec, int c, float alpha, float gain, float clamp) {
  struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
  };
  const I first = (I)blockIdx.x * (kThreads * kPacks) + (I)threadIdx.x;
  Pack p[kPacks];
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const I i = first + (I)(u * kThreads);
    if (i < n_vec) p[u] = reinterpret_cast<const Pack*>(x)[i];
  }
  int col = (int)((first * VEC) % c);  // the first pack's column, then + the stride mod C
  const int step = (kThreads * VEC) % c;
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const I i = first + (I)(u * kThreads);
    if (i < n_vec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f32(p[u].v[e]);
        if (bias != nullptr) v += to_f32(bias[col + e]);
        v = activate<ACT>(v, alpha);
        if (gain != 1.f) v *= gain;
        if (clamp >= 0.f) v = fminf(fmaxf(v, -clamp), clamp);
        p[u].v[e] = from_f32<T>(v);
      }
      reinterpret_cast<Pack*>(y)[i] = p[u];
    }
    col += step;
    if (col >= c) col -= c;
  }
}

template <typename T, int VEC, int ACT>
int launch_act(const void* x, const void* bias, void* y, long long n, int c, float alpha,
               float gain, float clamp, cudaStream_t stream) {
  const long long n_vec = n / VEC;
  if (n_vec == 0) return 0;
  const dim3 grid((unsigned)((n_vec + kThreads * kPacks - 1) / (kThreads * kPacks)));
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  if (n + (long long)kThreads * kPacks * VEC <= INT32_MAX)
    bias_act_kernel<T, VEC, ACT, int><<<grid, kThreads, 0, stream>>>(xt, bt, yt, (int)n_vec, c,
                                                                   alpha, gain, clamp);
  else
    bias_act_kernel<T, VEC, ACT, long long><<<grid, kThreads, 0, stream>>>(xt, bt, yt, n_vec, c,
                                                                         alpha, gain, clamp);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch(const void* x, const void* bias, void* y, long long n, int c, int act, float alpha,
           float gain, float clamp, cudaStream_t s) {
  switch (act) {
    case 1: return launch_act<T, VEC, 1>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 2: return launch_act<T, VEC, 2>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 3: return launch_act<T, VEC, 3>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 4: return launch_act<T, VEC, 4>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 5: return launch_act<T, VEC, 5>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 6: return launch_act<T, VEC, 6>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 7: return launch_act<T, VEC, 7>(x, bias, y, n, c, alpha, gain, clamp, s);
    case 8: return launch_act<T, VEC, 8>(x, bias, y, n, c, alpha, gain, clamp, s);
    default: return launch_act<T, VEC, 0>(x, bias, y, n, c, alpha, gain, clamp, s);
  }
}

}  // namespace

// x, y [n / c, c] and bias [c] (or null), bf16 if is_bf16, else f32; act is
// the index of the activation (0 linear ... 8 swish); clamp < 0 means none.
// vec 1 takes one value a pack; vec 0 takes 16 bytes a pack, and then c
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

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
// the activation type. That is the contract of the TPU kernels.
//
// Design. The TPU kernels compute the conv on a flat [HW, C] tile as nine
// sublane rolls + border masks + MXU products, because Mosaic has no gather.
// Here the conv is an implicit GEMM: M = B*H*W pixels, N = Cout, K = 9*Cin.
// Each K slice is kKC channels of one tap (dy, dx); a block loads the slice
// of its pixel tile from the tap's shifted pixels into shared memory, zero
// outside the map, beside the slice's kKC rows of w, and every thread adds a
// register tile of 4 pixels x 8 channels. Pixel tiles run across image
// boundaries, so the 16-pixel maps of the 4x4 level fill blocks too.
//
// The RMSNorm needs the whole Cout row of a pixel. A block owns all of Cout
// for its pixel tile: 256 threads x 32 accumulators hold MT x Cout = 8192
// values (MT 128 pixels at Cout 64, 16 at Cout 512), so the norm is a
// reduction inside the block (per-thread partial sums of squares through
// shared memory, in a fixed order) and the bias, norm, FiLM, SiLU and
// residual are the epilogue of the same launch. The other choice, Cout split
// over blocks, would send partial sums through device memory and need a
// second pass. The cost of this one: few blocks where Cout is wide and the
// map small (B 64 at 4x4, Cout 512: 64 blocks on 132 SMs).
//
// #11 with a projection runs two products: the conv into one accumulator
// and, after its epilogue, x . Wres (K = Cin, the centre tap only) into a
// second one, because the residual is added after the norm and the SiLU.
//
// What bounds it on this card: the products at the small maps, and products
// and bytes about equally at the 64x64 and 32x32 maps, where the kernels sit
// near the ridge. One B-64 CFG forward of the RC-49 64x64 UNet runs 23
// launches of each kernel, ~518 GFLOP in all: ~0.52 ms at the 989 TFLOP/s
// bf16 tensor-core peak; the bytes (x, h1 and y once each, the weights) add
// at most as much at 3.35 TB/s. This first version runs the products on the
// CUDA cores in f32 FMAs from shared memory, with no pipelining of the
// loads: it is far from that bound, and tensor cores (mma.sync / wgmma), TMA
// and a load pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;  // channels of one tap per K slice
constexpr int kPX = 4;   // pixels per thread
constexpr int kCH = 8;   // output channels per thread

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
template <typename T>
__device__ void accumulate(float (&acc)[kPX][kCH], const T* __restrict__ src, int cin,
                           const T* __restrict__ w, int cout, int ntaps, int hh, int ww,
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
          v = to_f32(src[(((size_t)s.img[p] * hh + r) * ww + c) * cin + ci]);
        s.as[k * t.mt + p] = v;
      }
      for (int i = threadIdx.x; i < kKC * t.cpad; i += kThreads) {
        const int k = i / t.cpad, n = i % t.cpad, ci = c0 + k;
        s.bs[i] = (ci < cin && n < cout) ? to_f32(w[((size_t)tap * cin + ci) * cout + n]) : 0.f;
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
__device__ void bias_and_rms(float (&acc)[kPX][kCH], const float* __restrict__ bias, int cout,
                             const Smem& s, const Tile& t, int px0, int ch0, int grp_ch,
                             bool active) {
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

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// #10: one block per tile of mt pixels, all of Cout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
half_a_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, const T* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ g1, T* __restrict__ h1,
              int batch, int hh, int ww, int cin, int cout) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = make_tile(cout);
  const Smem s = carve(smem, t);
  const int m0 = blockIdx.x * t.mt;
  locate_pixels(s, t, m0, batch * hh * ww, hh, ww);
  const int grp_ch = threadIdx.x % t.cg;
  const int px0 = (threadIdx.x / t.cg) * kPX, ch0 = grp_ch * kCH;
  const bool active = (int)threadIdx.x < t.pg * t.cg;

  float acc[kPX][kCH] = {};
  accumulate<T>(acc, x, cin, w1, cout, 9, hh, ww, s, t, px0, ch0, active);
  bias_and_rms(acc, b1, cout, s, t, px0, ch0, grp_ch, active);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int p = px0 + i, b = s.img[p];
    if (b < 0) continue;
    const float inv = s.inv[p];
    T* out = h1 + (size_t)(m0 + p) * cout;
#pragma unroll
    for (int j = 0; j < kCH; ++j) {
      const int n = ch0 + j;
      if (n >= cout) continue;
      float v = acc[i][j] * inv * g1[n];
      v = v * (scale[(size_t)b * cout + n] + 1.f) + shift[(size_t)b * cout + n];
      out[n] = from_f32<T>(silu(v));
    }
  }
}

// #11: conv3x3 over h1 (Cout channels in), norm, SiLU, then the residual.
template <typename T>
__global__ void __launch_bounds__(kThreads)
half_b_kernel(const T* __restrict__ h1, const T* __restrict__ x, const T* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ g2,
              const T* __restrict__ wres, const float* __restrict__ bres, T* __restrict__ y,
              int batch, int hh, int ww, int cin, int cout, int has_res) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = make_tile(cout);
  const Smem s = carve(smem, t);
  const int m0 = blockIdx.x * t.mt;
  locate_pixels(s, t, m0, batch * hh * ww, hh, ww);
  const int grp_ch = threadIdx.x % t.cg;
  const int px0 = (threadIdx.x / t.cg) * kPX, ch0 = grp_ch * kCH;
  const bool active = (int)threadIdx.x < t.pg * t.cg;

  float acc[kPX][kCH] = {};
  accumulate<T>(acc, h1, cout, w2, cout, 9, hh, ww, s, t, px0, ch0, active);
  bias_and_rms(acc, b2, cout, s, t, px0, ch0, grp_ch, active);
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
  if (has_res) accumulate<T>(res, x, cin, wres, cout, 1, hh, ww, s, t, px0, ch0, active);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int p = px0 + i;
    if (s.img[p] < 0) continue;
    const size_t m = (size_t)(m0 + p);
    T* out = y + m * cout;
#pragma unroll
    for (int j = 0; j < kCH; ++j) {
      const int n = ch0 + j;
      if (n >= cout) continue;
      const float r = has_res ? res[i][j] + bres[n] : to_f32(x[m * cin + n]);
      out[n] = from_f32<T>(acc[i][j] + r);
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, const Tile& t, size_t* smem) {
  if (t.cg > kThreads) return cudaErrorInvalidValue;  // Cout above 2048
  *smem = smem_floats(t) * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

inline int blocks(int batch, int hh, int ww, const Tile& t) {
  return (batch * hh * ww + t.mt - 1) / t.mt;
}

template <typename T>
int launch_a(const void* x, const void* scale, const void* shift, const void* w1,
             const void* b1, const void* g1, void* h1, int batch, int hh, int ww, int cin,
             int cout, cudaStream_t stream) {
  const Tile t = make_tile(cout);
  size_t smem = 0;
  cudaError_t err = prepare(half_a_kernel<T>, t, &smem);
  if (err != cudaSuccess) return (int)err;
  half_a_kernel<T><<<blocks(batch, hh, ww, t), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g1), static_cast<T*>(h1),
      batch, hh, ww, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(const void* h1, const void* x, const void* w2, const void* b2, const void* g2,
             const void* wres, const void* bres, void* y, int batch, int hh, int ww, int cin,
             int cout, int has_res, cudaStream_t stream) {
  const Tile t = make_tile(cout);
  size_t smem = 0;
  cudaError_t err = prepare(half_b_kernel<T>, t, &smem);
  if (err != cudaSuccess) return (int)err;
  half_b_kernel<T><<<blocks(batch, hh, ww, t), kThreads, smem, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(x), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const T*>(wres), static_cast<const float*>(bres), static_cast<T*>(y),
      batch, hh, ww, cin, cout, has_res);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H*W, Cin] and w1 [9*Cin, Cout] in the activation type (bf16 if
// is_bf16, else f32); scale, shift [B, Cout], b1, g1 [Cout] f32; h1
// [B, H*W, Cout] in the activation type. Launches on `stream` and returns the
// cudaError_t of the launch check.
extern "C" int ccdm_resnet_half_a(const void* x, const void* scale, const void* shift,
                                  const void* w1, const void* b1, const void* g1, void* h1,
                                  int batch, int hh, int ww, int cin, int cout, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_a<__nv_bfloat16>(x, scale, shift, w1, b1, g1, h1, batch, hh, ww, cin, cout, s);
  return launch_a<float>(x, scale, shift, w1, b1, g1, h1, batch, hh, ww, cin, cout, s);
}

// h1 [B, H*W, Cout], x [B, H*W, Cin], w2 [9*Cout, Cout], wres [Cin, Cout] (read
// only if has_res) and y [B, H*W, Cout] in the activation type; b2, g2, bres
// [Cout] f32. Without has_res, Cin must equal Cout.
extern "C" int ccdm_resnet_half_b(const void* h1, const void* x, const void* w2,
                                  const void* b2, const void* g2, const void* wres,
                                  const void* bres, void* y, int batch, int hh, int ww,
                                  int cin, int cout, int has_res, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!has_res && cin != cout) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_b<__nv_bfloat16>(h1, x, w2, b2, g2, wres, bres, y, batch, hh, ww, cin, cout,
                                   has_res, s);
  return launch_b<float>(h1, x, w2, b2, g2, wres, bres, y, batch, hh, ww, cin, cout, has_res, s);
}

extern "C" const char* ccdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

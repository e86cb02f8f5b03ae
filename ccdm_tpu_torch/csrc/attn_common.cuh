// Device code shared by the two sources of the attention block,
// csrc/attn_block.cu (kernel #1) and csrc/attn_block_large.cu (kernels
// #2-#5): the scalar helpers of their CUDA-core routes, and the pieces of
// #1's split pass 1 that #2's tensor-core route runs as they are: the
// resident-weight products of a 64-token tile in a 2 x 4 grid of warps
// (mma_slice, mma_resident), and the online softmax over the tokens with its
// f32 records (WarpCtx, online_update, write_record) and their merge in a
// fixed order (merge_records). ops/_build.py hashes this header into both
// libraries' paths; the g++ emulation of tests/test_torch_cuda_emulation.py
// compiles it as it is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 32;          // dim_head: one warp lane per head channel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTG = 8;          // tokens per thread in a CUDA-core register tile
constexpr int kHeads = 4;       // heads of the tensor-core routes: one warp column each
constexpr int kF = kHeads * kD;  // 128: q, k and v are one 128-column weight chunk each
constexpr int kBN = 128;        // columns of a weight chunk: 4 warp columns of 32
constexpr int kBK = 32;         // K rows per slice of a weight (two k16 steps)
constexpr int kWave = 132;      // blocks that fill the card once: the SMs of an H100 SXM
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int kEW = kD + 8;     // bf16 per row of a warp's e and v tiles (80 bytes)
constexpr int kPart = 2 * kF + kF * kD;  // f32 of one partial record: m, s, a
constexpr int kWarpScratch = 2 * 32 * kEW * 2 + 32 * 4;  // a warp's e, v and rescale factors

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

// ------------------------------------------------- bf16: tensor cores

// Where this thread's accumulator element [mi][ni][h * 2 + e] lies in its
// warp's 32 x 32 tile: row mi * 16 + g + 8 h, column ni * 8 + 2 t + e.
struct Lane {
  int lane, g, t, wm, wn;
  __device__ Lane() {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = (threadIdx.x >> 5) >> 2;
    wn = (threadIdx.x >> 5) & 3;
  }
};

// The tiles [t0, t1) of split z of a row of `tiles` tiles.
struct TileRange {
  int t0, t1;
  __device__ TileRange(int z, int splits, int tiles)
      : t0(z * tiles / splits), t1((z + 1) * tiles / splits) {}
};

// A weight operand in device memory: NB chunks of kBN columns at col0 +
// j col_step of w [k_total, *] (row stride ldw); columns at or past col_lim
// and rows at or past k_total read as zero.
struct WSlab {
  const bf16* w;
  int ldw, col0, col_step, col_lim;
};

// Copies rows [k0, k0 + rows) of the slab's NB chunks to dst [rows][NB kBN + 8]:
// cp.async copies (vec) or element loads; the caller commits, waits and
// synchronises.
template <int NB>
__device__ void load_slab(bf16* dst, const WSlab& ws, int k0, int rows, int k_total, int vec) {
  constexpr int ldb = NB * kBN + 8, per_row = NB * kBN / 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int k = i / per_row, j = (i % per_row) / (kBN / 8), cc = (i % (kBN / 8)) * 8;
    const int kr = k0 + k, col = ws.col0 + j * ws.col_step + cc;
    const bool ok = kr < k_total && col < ws.col_lim;
    const bf16* s = ok ? ws.w + (size_t)kr * ws.ldw + col : ws.w;
    bf16* d = dst + k * ldb + j * kBN + cc;
    if (vec) {
      cp_async_16(d, s, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok && col + e < ws.col_lim ? s[e] : zero;
    }
  }
}

// acc[j] += A[:, ak0 .. ak0 + 32) . b_s[0 .. 32)[j kBN .. (j + 1) kBN) for
// j < NB: A the 64 rows of a_s [64][lda], b_s a K slice [32][NB kBN + 8].
// Warp (wm, wn) takes rows wm * 32 and columns wn * 32 of each chunk.
template <int NB>
__device__ __forceinline__ void mma_slice(float (&acc)[NB][2][4][4], const bf16* a_s, int lda,
                                          int ak0, const bf16* b_s) {
  constexpr int ldb = NB * kBN + 8;
  const Lane q;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], a_s + (q.wm * 32 + mi * 16 + (q.lane & 15)) * lda + ak0 + kk +
                              (q.lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], b_s + (kk + (q.lane & 15)) * ldb + j * kBN + q.wn * 32 +
                                       nj * 16 + (q.lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t b[2] = {bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]};
          mma_16816(acc[j][mi][ni], af[mi], b);
        }
    }
  }
}

// acc += A . W over K = k_total (A zero past k_total up to the whole slice),
// W resident in shared memory: w_s [K slices x 32][NB kBN + 8]. No barrier.
template <int NB>
__device__ __forceinline__ void mma_resident(float (&acc)[NB][2][4][4], const bf16* a_s, int lda,
                                             const bf16* w_s, int k_total) {
  for (int k0 = 0; k0 < k_total; k0 += kBK)
    mma_slice<NB>(acc, a_s, lda, k0, w_s + k0 * (NB * kBN + 8));
}

// One warp's online softmax over its tokens, for the 32 channels of its head:
// the running max m and sum s of its 8 channels (columns 8 ni + 2 t + e of
// the accumulator layout, the same in each lane of a column), and the
// context a[d][e] = sum_n exp(k[n][d] - m[d]) v[n][e] (rows mi * 16 + g + 8 h).
struct WarpCtx {
  float m[8], s[8];
  float a[2][4][4];
  __device__ void init() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[j] = -INFINITY;
      s[j] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mi][ni][i] = 0.f;
  }
};

// Folds the warp's 32 tokens of k and v (accumulator layout; rows at or past
// valid are padding) into st. The warp's scratch holds e = exp(k - m) and v
// as bf16 [token][channel] (the operands of e^T v) and the factors that
// rescale a's rows when m grows.
__device__ void online_update(WarpCtx& st, const float (&k)[2][4][4], const float (&v)[2][4][4],
                              int valid, char* scratch) {
  const Lane q;
  bf16* e_w = reinterpret_cast<bf16*>(scratch);
  bf16* v_w = e_w + 32 * kEW;
  float* sc_w = reinterpret_cast<float*>(v_w + 32 * kEW);
  float scale[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float mx = -INFINITY;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (mi * 16 + q.g + 8 * h < valid) mx = fmaxf(mx, k[mi][j / 2][h * 2 + j % 2]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m[j], mx);
    scale[j] = m_new == -INFINITY ? 1.f : __expf(st.m[j] - m_new);
    st.m[j] = m_new;
    st.s[j] *= scale[j];
  }
  __syncwarp();  // the last update's reads of the scratch are done
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mi * 16 + q.g + 8 * h;
      const bool ok = row < valid;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float e0 = ok ? __expf(k[mi][ni][h * 2] - st.m[ni * 2]) : 0.f;
        const float e1 = ok ? __expf(k[mi][ni][h * 2 + 1] - st.m[ni * 2 + 1]) : 0.f;
        st.s[ni * 2] += e0;
        st.s[ni * 2 + 1] += e1;
        const int col = ni * 8 + 2 * q.t;
        *reinterpret_cast<uint32_t*>(e_w + row * kEW + col) = pack_bf16(e0, e1);
        *reinterpret_cast<uint32_t*>(v_w + row * kEW + col) =
            pack_bf16(v[mi][ni][h * 2], v[mi][ni][h * 2 + 1]);
      }
    }
  if (q.g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc_w[(j / 2) * 8 + 2 * q.t + j % 2] = scale[j];
  }
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float f = sc_w[mi * 16 + q.g + 8 * h];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        st.a[mi][ni][h * 2] *= f;
        st.a[mi][ni][h * 2 + 1] *= f;
      }
    }
  // a += e^T v: A = e^T (rows: channels d, K: tokens) through ldmatrix .trans
  // of e_w; B = v [token][channel] through ldmatrix .trans of v_w
#pragma unroll
  for (int kk = 0; kk < 32; kk += 16) {
    uint32_t af[2][4], bfr[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4_trans(af[mi], e_w + (kk + (q.lane & 7) + ((q.lane >> 4) << 3)) * kEW +
                                    mi * 16 + ((q.lane >> 3) & 1) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(bfr[nj], v_w + (kk + (q.lane & 15)) * kEW + nj * 16 + (q.lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b[2] = {bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]};
        mma_16816(st.a[mi][ni], af[mi], b);
      }
  }
}

// Writes the warp's (m, s, a) for its head into the record rec [kPart]
// (m [F], s [F], a [F][D]); s summed over the lanes of a column in a fixed order.
__device__ void write_record(WarpCtx& st, float* rec) {
  const Lane q;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) st.s[j] += __shfl_xor_sync(0xffffffffu, st.s[j], o);
  if (q.g == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = q.wn * kD + (j / 2) * 8 + 2 * q.t + j % 2;
      rec[ch] = st.m[j];
      rec[kF + ch] = st.s[j];
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(rec + 2 * kF + (q.wn * kD + mi * 16 + q.g + 8 * h) * kD +
                                   ni * 8 + 2 * q.t) =
            float2{st.a[mi][ni][h * 2], st.a[mi][ni][h * 2 + 1]};
}

// Merges the records of one batch row, taken in order, for elements i =
// ch * D + e from `first` in steps of `step`: M, the max of the records' m
// of channel ch, s = sum_r s_r exp(m_r - M) and a = sum_r a_r[ch][e]
// exp(m_r - M) go to out(i, M, s, a) (#1: ctx = a / s in bf16; #2: kmax, s
// and a in f32).
template <typename Out>
__device__ void merge_records(const float* recs, int count, int first, int step, Out out) {
  for (int i = first; i < kF * kD; i += step) {
    const int ch = i / kD;
    float mx = -INFINITY;
    for (int r = 0; r < count; ++r) mx = fmaxf(mx, recs[(size_t)r * kPart + ch]);
    float s = 0.f, a = 0.f;
    for (int r = 0; r < count; ++r) {
      const float* rec = recs + (size_t)r * kPart;
      const float f = rec[ch] == -INFINITY ? 0.f : __expf(rec[ch] - mx);
      s = fmaf(rec[kF + ch], f, s);
      a = fmaf(rec[2 * kF + i], f, a);
    }
    out(i, mx, s, a);
  }
}

}  // namespace

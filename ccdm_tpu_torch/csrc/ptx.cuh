// PTX helpers of the tensor-core kernels (csrc/attn_block.cu,
// csrc/attn_block_large.cu, csrc/resnet_block.cu, csrc/linear_attention.cu),
// and the fragment loads and row copies built on them.
//
// Every PTX instruction of those kernels is here, so that an emulation can
// supply the same names (CCDM_PTX_EMULATED) and run the kernels on a CPU with
// the fragment layouts of the PTX ISA. ops/_build.py hashes this header into
// the library path of every source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#ifndef CCDM_PTX_EMULATED
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared, of which the first src_bytes are read and
// the rest zero-filled (src_bytes 0: 16 zeros).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Four 8x8 b16 matrices; lane l gives the row address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a . b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), f32 d.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// The A fragment of mma_16816 for a 16 (m) x 16 (k) bf16 block at p (row
// stride ld) in shared memory: stored [m][k] (a_mk) or [k][m] (a_km,
// ldmatrix .trans: a product over the tokens of a tile).
__device__ __forceinline__ void a_mk(uint32_t (&a)[4], const __nv_bfloat16* p, int ld, int lane) {
  ldmatrix_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}
__device__ __forceinline__ void a_km(uint32_t (&a)[4], const __nv_bfloat16* p, int ld, int lane) {
  ldmatrix_x4_trans(a, p + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}
// The B fragments of a 16 (k) x 16 (n) block stored [k][n] at p: n8 tile 0
// in b[0], b[1] and n8 tile 1 in b[2], b[3].
__device__ __forceinline__ void b_kn16(uint32_t (&b)[4], const __nv_bfloat16* p, int ld,
                                       int lane) {
  ldmatrix_x4_trans(b, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// Rows [0, rows) x columns [0, cols) of src (row stride lds) to dst [rows][ldd]
// in 16-byte chunks, zeros past rows_valid and from column cols_valid on;
// cp.async (vec) or element loads, by threads tid of nthr. cols % 8 == 0 and
// cols_valid % 8 == 0. The caller commits and waits.
__device__ inline void copy_rows(__nv_bfloat16* dst, int ldd,
                                 const __nv_bfloat16* __restrict__ src, int lds, int rows,
                                 int rows_valid, int cols, int vec, int tid, int nthr,
                                 int cols_valid = 1 << 30) {
  const int per_row = cols / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < rows * per_row; i += nthr) {
    const int r = i / per_row, col = (i % per_row) * 8;
    const bool ok = r < rows_valid && col < cols_valid;
    const __nv_bfloat16* s = ok ? src + (size_t)r * lds + col : src;
    __nv_bfloat16* d = dst + r * ldd + col;
    if (vec) {
      cp_async_16(d, s, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? s[e] : zero;
    }
  }
}

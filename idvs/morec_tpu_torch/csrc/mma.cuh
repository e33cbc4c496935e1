// Warp-level tensor-core building blocks for sm_90a: 16-byte cp.async
// copies into shared memory, ldmatrix loads of bf16 fragments and the
// mma.sync m16n8k16 bf16 product with float32 accumulation.
//
// Fragment layout of one m16n8k16 product (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and q = lane % 4:
//   A (16 x 16, four b32 of two bf16): a0 = (g, 2q..2q+1),
//     a1 = (g + 8, 2q..), a2 = (g, 8 + 2q..), a3 = (g + 8, 8 + 2q..);
//   B (16 x 8, two b32): b0 = (k 2q..2q+1, n g), b1 = (k 8 + 2q.., n g);
//   C (16 x 8, four f32): c0, c1 = (g, 2q..2q+1), c2, c3 = (g + 8, 2q..).
// So the accumulators of two neighbouring 8-column tiles are, packed to
// bf16 pairs, the A operand of the next product over those 16 columns.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace idvs {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, and register m of lane l holds row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 of matrix m (.trans: column l / 4, rows 2 (l % 4)..)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane l's ldmatrix address, as (row, column) offsets within a 16 x 16
// block of a row-major tile, for the four operand shapes:
//   A from an [m][k] tile, ldsm_x4:          (a_row, a_col)
//   A from a [k][m] tile (its transpose), ldsm_x4_t: (bn_row, bn_col)
//   B (two 8-column tiles) from an [n][k] tile, ldsm_x4: (bn_row, bn_col),
//     registers 0-1 the first tile's b0, b1, registers 2-3 the second's
//   B from a [k][n] tile, ldsm_x4_t:          (bk_row, bk_col), likewise
__device__ __forceinline__ int a_row(int l) { return l & 15; }
__device__ __forceinline__ int a_col(int l) { return (l >> 4) << 3; }
__device__ __forceinline__ int bn_row(int l) {
  return (l & 7) + ((l >> 4) << 3);
}
__device__ __forceinline__ int bn_col(int l) { return ((l >> 3) & 1) << 3; }
__device__ __forceinline__ int bk_row(int l) {
  return (l & 7) + (((l >> 3) & 1) << 3);
}
__device__ __forceinline__ int bk_col(int l) { return (l >> 4) << 3; }

}  // namespace idvs

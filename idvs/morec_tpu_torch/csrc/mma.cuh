// Warp-level tensor-core building blocks for sm_90a: 16- and 4-byte
// cp.async copies into shared memory, ldmatrix loads of bf16 fragments (and
// of float fragments, two b16 halves a float), the mma.sync m16n8k16 bf16
// product and the m16n8k8 tf32 product with float32 accumulation, the
// split of a float into two tf32 terms (in five operations, or three with
// the small term unrounded), the 3xTF32 step built on both, and a slice of
// 3xTF32 products from float tiles in shared memory (tf32_slice: premlp.cu's
// and win_attn.cu's float32 bodies).
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

// 16 bytes to shared memory of which the first `bytes` (0..16) come from
// src and the rest are zeros; src is not read when bytes is 0
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst,
                                                 const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src), "r"(bytes));
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

// d += a . b, m16n8k8 with tf32 operands (floats whose low 13 bits are
// zero) and float32 accumulators. Fragments (g = lane / 4, q = lane % 4):
// a0 = (g, q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4);
// b0 = (k q, n g), b1 = (k q + 4, n g); C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 stored mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's rounding, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about float32's precision (3xTF32): big =
// tf32_rna(x), small = tf32_rna(x - big), the subtraction exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The 3xTF32 product of one m16n8k8 step into the running sums c: the
// step's small.big + big.small + big.big into zeroed sums d (the tensor
// cores' accumulation is no float sum, gemm.cu's header), then c += d by
// float adds
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// d = a . b with zero sums: mma_tf32 into sums that need no zeroing first
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// split_tf32 in three operations: big = tf32_rna(x), small = x - big
// exact and left unrounded, the tensor cores reading its upper 19 bits
// (its truncation errs by at most 2^-21 of x, random in sign: the small
// term's own rounding, a part of x the dropped small.small term already
// is)
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& big,
                                                uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// acc[i][j] += the 3xTF32 product of MT m16 tiles of A and NJ n8 tiles of
// B over NK 8-deep k-steps (a slice), the slice's products summed into
// zeroed sums and those added to acc by float adds (gemm.cu's header: the
// tensor cores' accumulation is no float sum). A: float rows, a[(16 i +
// r) * lda + k] for row r of tile i; B: float rows of k, b[k * ldb + 8 j +
// n]. Within a k-step, fragment column q is k 2q and column q + 4 is
// 2q + 1 for A and B alike, so an A row read is one float2. Each float is
// split once here: A's for the NJ tiles, B's for the MT tiles. With lda
// 8 mod 32 floats and ldb 4 mod 16 the reads are free of bank conflicts.
template <int MT, int NJ, int NK>
__device__ __forceinline__ void tf32_slice(float (&acc)[MT][NJ][4],
                                           const float* a, int lda,
                                           const float* b, int ldb) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  uint32_t ab[NK][MT][4], as[NK][MT][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* r = a + (16 * i + g) * lda + 8 * kk + 2 * q;
      const float2 lo = *reinterpret_cast<const float2*>(r);
      const float2 hi = *reinterpret_cast<const float2*>(r + 8 * lda);
      split_tf32_fast(lo.x, ab[kk][i][0], as[kk][i][0]);
      split_tf32_fast(hi.x, ab[kk][i][1], as[kk][i][1]);
      split_tf32_fast(lo.y, ab[kk][i][2], as[kk][i][2]);
      split_tf32_fast(hi.y, ab[kk][i][3], as[kk][i][3]);
    }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t bb[NK][2], bs[NK][2];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const float* c = b + (8 * kk + 2 * q) * ldb + 8 * j + g;
      split_tf32_fast(c[0], bb[kk][0], bs[kk][0]);
      split_tf32_fast(c[ldb], bb[kk][1], bs[kk][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float d[4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (kk == 0)
          mma_tf32_zero(d, as[0][i], bb[0][0], bb[0][1]);
        else
          mma_tf32(d, as[kk][i], bb[kk][0], bb[kk][1]);
        mma_tf32(d, ab[kk][i], bs[kk][0], bs[kk][1]);
        mma_tf32(d, ab[kk][i], bb[kk][0], bb[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
    }
  }
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

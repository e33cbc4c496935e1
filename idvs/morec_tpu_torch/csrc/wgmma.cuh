// Hopper's asynchronous building blocks for sm_90a, shared by the port's
// warp-specialised kernels (resln_bwd_wg.cu, premlp_bwd_wg.cu): warpgroup
// products (wgmma.mma_async) on bf16 operands in shared memory with float
// accumulators in registers, their shared-memory descriptors, the
// mbarriers of a producer-consumer ring, TMA tile loads into that ring,
// and setmaxnreg.
//
// Operand layout. Every operand here is K-major (each row of A or B holds
// consecutive k; premlp_bwd_wg.cu's W1 alone is MN-major, sw128_desc_mn)
// in the 128-byte swizzled layout that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a row of 64 bf16 (128 bytes) per line, 8
// lines an atom of 1024 bytes (1024-byte aligned), and within line r the
// 16-byte piece c stored at piece c ^ (r % 8). A tile deeper than 64 in K
// is stored as K-blocks of 64, one after another. A product's k-step of 16
// (32 bytes) inside a K-block advances the descriptor's start address by
// 32 bytes; consecutive 8-row groups lie 1024 bytes apart (the stride
// byte offset). Threads that write such a tile themselves place their
// bytes with sw128_offset and, before a product reads it, run
// fence_async_smem and a barrier.
//
// Accumulator map of an m64nNk16 product (acc_row, acc_col): thread t of
// the warpgroup's 128 holds value i of its N / 2 at row 16 (t / 32) +
// (t % 32) / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) +
// i % 2, the mma.sync m16n8 accumulator repeated over the four warps and
// the N / 8 column tiles.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace idvs {
namespace wg {

// byte offset of element (r, k) of a 64-wide K-block of the swizzled
// layout, from its 1024-byte aligned base
__device__ __forceinline__ uint32_t sw128_offset(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
}

// The descriptor of a K-major, 128-byte swizzled operand whose first row
// is at shared address `addr`: start address >> 4 in bits 0-13, leading
// byte offset 1 (unused by this layout), stride byte offset 1024 >> 4 in
// bits 32-45, layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptor of an MN-major (transposed) operand in the same swizzle,
// as TMA writes a [k][64] box of a row-major (K, N) matrix: each 128-byte
// line holds 64 consecutive n of one k, 8 lines an atom; the stride byte
// offset (bits 32-45) steps 8 k (1024 bytes), the leading byte offset
// (bits 16-29) steps 64 n, `mn_stride` bytes. A k-step of 16 advances the
// start address by 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr,
                                                  uint32_t mn_stride) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(mn_stride >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the descriptor of k-step ks (16 deep) of a tile stored as K-blocks of
// 64, `kblock` bytes apart
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int ks,
                                               uint32_t kblock) {
  return sw128_desc(base + (ks >> 2) * kblock + (ks & 3) * 32);
}

__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// orders this thread's generic shared-memory writes before the async
// proxy's reads (wgmma operands, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B on the tensor cores, m64nNk16, A and B bf16 in shared memory
// (descriptors a, b), d float; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// TB 1 takes B MN-major (transposed, sw128_desc_mn), bf16 only
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a,
                                    uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_m64n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_m64n128(d, a, b, scale_d);
  else wgmma_m64n256(d, a, b, scale_d);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a 2-D box of `map` at coordinates (x inner, y) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// registers a thread of this warpgroup may hold from here on
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// bar.sync over `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- host: tensor maps ------------------------------------------------------

// The 2-D map of a row-major bf16 (rows, cols) matrix whose boxes are
// box_rows x 64 columns in the 128-byte swizzled layout. The driver's
// encoder is reached through the runtime (no link against libcuda).
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace idvs

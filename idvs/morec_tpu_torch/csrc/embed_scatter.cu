// dE[ids[i]] += dX[i]: the embedding-table gradient (BERT's word table).
//
// Replaces idvs/morec_tpu/ops/pallas/embed_scatter.py _kernel (reached
// through scatter_add_rows, the backward of embed_gather :132-138): float
// accumulation whatever dX's dtype, duplicate ids add up, and the result is
// cast to dX's dtype.
//
// Bound on the H100: device-memory bandwidth and atomic throughput. At the
// train shapes dX is titles x 30 rows of 512 and the table 30522 x 512
// floats (62.5 MB, zeroed by the wrapper). The TPU kernel keeps a (V, 512)
// stripe resident in VMEM across a sequential grid so each row's
// read-modify-write runs at VMEM latency; the H100 has no such grid, but
// its L2 (50 MB) holds most of the table and float atomicAdd resolves
// there. Design: one warp per token row, each lane adding 4-element groups
// of the row with float atomics (rows of the same id may land in any
// order, so sums differ from a sequential order by float reassociation
// only); a second pass casts the float table to bf16 when dX is bf16.
#include "common.cuh"

namespace idvs {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const long long* __restrict__ ids,
                       const T* __restrict__ dx, float* __restrict__ table,
                       int M, int D, int V) {
  const int warps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * warps + (threadIdx.x >> 5); i < M;
       i += gridDim.x * warps) {
    const long long id = ids[i];
    if (id < 0 || id >= V) continue;   // the forward gather has raised
    float* dst = table + id * D;
    const T* src = dx + static_cast<size_t>(i) * D;
    for (int d = lane; d < D; d += 32) atomicAdd(dst + d, to_f32(src[d]));
  }
}

__global__ void cast_kernel(const float* __restrict__ src,
                            __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

template <typename T>
cudaError_t launch(const long long* ids, const void* dx, float* table, int M,
                   int D, int V, cudaStream_t s) {
  const int blocks = min((M + 7) / 8, 132 * 16);
  scatter_add_kernel<T><<<blocks, kThreads, 0, s>>>(
      ids, static_cast<const T*>(dx), table, M, D, V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// ids: (M,) int64 in [0, V); dx: (M, D) in the compute dtype; table:
// (V, D) float, zeroed by the caller, accumulated in place. out: (V, D)
// bf16 receiving the cast table when dtype is bf16, unused (null) for f32.
extern "C" int idvs_scatter_add_rows(const void* ids, const void* dx,
                                     void* table, void* out, int M, int D,
                                     int V, int dtype, void* stream) {
  using namespace idvs;
  if (M < 0 || D < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long* i = static_cast<const long long*>(ids);
  float* t = static_cast<float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    return M ? static_cast<int>(launch<float>(i, dx, t, M, D, V, s)) : 0;
  } else if (dtype == kBF16) {
    if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = M ? launch<__nv_bfloat16>(i, dx, t, M, D, V, s) : cudaSuccess;
    if (err != cudaSuccess) return static_cast<int>(err);
    cast_kernel<<<132 * 8, 256, 0, s>>>(t, static_cast<__nv_bfloat16*>(out),
                                        static_cast<size_t>(V) * D);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dE[ids[i]] += dX[i]: the embedding-table gradient (BERT's word table).
//
// Replaces idvs/morec_tpu/ops/pallas/embed_scatter.py _kernel (reached
// through scatter_add_rows, the backward of embed_gather :132-138): float
// accumulation whatever dX's dtype, duplicate ids add up, and the result is
// cast to dX's dtype.
//
// Bound on the H100: bytes. dX (M x D) read once and the (V x D) table
// written once in dX's dtype: at the train shapes (M = titles x 30 tokens,
// D = 512, V = 30522) 23.6 MB and 31.3 MB in bf16, 0.0164 ms at 3.35 TB/s.
// The TPU kernel keeps a (V, 512) float stripe resident in VMEM across a
// sequential grid; the H100 has no such grid. Design: three passes, and
// only the rows of ids that repeat are accumulated in float.
//   1. count: a warp per 32 tokens counts each id's tokens (counts (V,)
//      int32, cleared by a memset); the token that makes an id repeat has
//      its warp zero that id's float row;
//   2. add: a warp per kGroup consecutive tokens walks them in order,
//      summing each run of one id in registers. An id that occurs once is
//      written to its output row as it is (no float row, no atomic); a
//      repeated id's run is added into its float row with float atomics,
//      which resolve in the 50 MB L2 (a lane adds 4 neighbouring columns
//      as one float4 atomic, sm_90);
//   3. write: every other table row once, in dX's dtype: zeros where no id
//      points, the float row cast where the id repeats.
// In float32 the float rows are the output table itself, so pass 3 only
// writes the zeros. At the train shapes about half the tokens' ids occur
// once. Hot rows: BERT's titles end in runs of the padding id and repeat
// CLS and SEP once a title, so the padding row alone can take a third of
// a batch's tokens. The run sums fold each warp's stretch of a title's
// padding into one atomic an element, so a hot row takes about one atomic
// per element per title it appears in, not one per token. Atomics add the
// runs in no fixed order: sums of a repeated id differ from a sequential
// order by float reassociation only.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace idvs {
namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kGroup = 16;       // tokens a warp of the add pass walks
constexpr int kVec = 4;          // columns a lane adds as one float4
constexpr int kSlab = 32 * kVec * 4;   // columns a warp sums at once

__global__ void __launch_bounds__(kThreads)
    mark_kernel(const long long* __restrict__ ids, int* __restrict__ counts,
                float* __restrict__ acc, int M, int D, int V) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32 + lane;
  long long id = -1;
  bool second = false;
  if (i < M) {
    id = ids[i];
    // an id outside [0, V) is skipped: the forward gather has raised
    if (id >= 0 && id < V) second = atomicAdd(counts + id, 1) == 1;
  }
  // the token that makes an id repeat zeroes its float row
  unsigned todo = __ballot_sync(~0u, second);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    float* row = acc + __shfl_sync(~0u, id, src) * D;
    for (int d = lane; d < D; d += 32) row[d] = 0.f;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Vec: D % 4 == 0 and the rows 16-byte (float) / 8-byte (bf16) aligned, so
// a lane loads, stores and adds 4 neighbouring columns at once (one float4
// atomic, sm_90); else a column a lane. A run of an id that occurs once in
// the batch is that id's row: it is written to the output as it is.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
    add_kernel(const long long* __restrict__ ids, const T* __restrict__ dx,
               const int* __restrict__ counts, float* __restrict__ acc,
               T* __restrict__ out, int M, int D, int V) {
  constexpr int kW = Vec ? kVec : 1;         // columns a lane's piece
  constexpr int kPieces = kSlab / (32 * kW);  // pieces a lane sums at once
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroup;
  if (i0 >= M) return;
  const int i1 = min(M, i0 + kGroup);
  for (int c0 = 0; c0 < D; c0 += 32 * kW * kPieces) {
    float4 sum[kPieces];
    long long cur = -1;
    auto flush = [&]() {
      if (cur < 0 || cur >= V) return;
      const bool once = counts[cur] == 1;
      float* row = acc + cur * D;
      T* dst = out + cur * D;
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int d = c0 + kW * (lane + 32 * j);
        if (d >= D) continue;
        if constexpr (Vec) {
          if (once)
            store4(dst + d, sum[j]);
          else
            atomicAdd(reinterpret_cast<float4*>(row + d), sum[j]);
        } else {
          if (once)
            dst[d] = from_f32<T>(sum[j].x);
          else
            atomicAdd(row + d, sum[j].x);
        }
      }
    };
    for (int i = i0; i < i1; ++i) {
      const long long id = ids[i];   // the same for every lane
      if (id != cur) {
        flush();
        cur = id;
#pragma unroll
        for (int j = 0; j < kPieces; ++j) sum[j] = make_float4(0, 0, 0, 0);
      }
      const T* src = dx + static_cast<size_t>(i) * D;
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int d = c0 + kW * (lane + 32 * j);
        if (d >= D) continue;
        if constexpr (Vec) {
          const float4 f = load4(src + d);
          sum[j].x += f.x, sum[j].y += f.y, sum[j].z += f.z, sum[j].w += f.w;
        } else {
          sum[j].x += to_f32(src[d]);
        }
      }
    }
    flush();
  }
}

// a warp a row: zeros where no id points, the float sums cast to T where
// the id repeats (in float32, acc is out: nothing), and nothing where it
// occurs once (add_kernel wrote the row)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const int* __restrict__ counts, const float* __restrict__ acc,
                 T* __restrict__ out, int D, int V) {
  constexpr bool kInPlace = std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31;
  for (int v = blockIdx.x * kWarps + (threadIdx.x >> 5); v < V;
       v += gridDim.x * kWarps) {
    const int c = counts[v];
    if (c == 1 || (kInPlace && c > 1)) continue;
    const bool hit = c > 1;
    const float* src = acc + static_cast<size_t>(v) * D;
    T* dst = out + static_cast<size_t>(v) * D;
    if (D % 8 == 0) {   // 8 elements a lane at a time, 16-byte aligned
      for (int d = 8 * lane; d < D; d += 256) {
        float f[8] = {};
        if (hit) {
          const float4 a = *reinterpret_cast<const float4*>(src + d);
          const float4 b = *reinterpret_cast<const float4*>(src + d + 4);
          f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
          f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
        }
        if constexpr (kInPlace) {
          reinterpret_cast<float4*>(dst + d)[0] = make_float4(0, 0, 0, 0);
          reinterpret_cast<float4*>(dst + d)[1] = make_float4(0, 0, 0, 0);
        } else {
          *reinterpret_cast<uint4*>(dst + d) =
              make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
      }
    } else {
      for (int d = lane; d < D; d += 32)
        dst[d] = from_f32<T>(hit ? src[d] : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const long long* ids, const void* dx, int* counts,
                   float* acc, T* out, int M, int D, int V, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * V, s);
  if (err != cudaSuccess) return err;
  if (M > 0) {
    mark_kernel<<<(M + 32 * kWarps - 1) / (32 * kWarps), kThreads, 0, s>>>(
        ids, counts, acc, M, D, V);
    const int blocks = ((M + kGroup - 1) / kGroup + kWarps - 1) / kWarps;
    const T* x = static_cast<const T*>(dx);
    const bool vec = D % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (kVec * sizeof(T)) ==
                         0 &&
                     reinterpret_cast<uintptr_t>(out) % (kVec * sizeof(T)) ==
                         0 &&
                     reinterpret_cast<uintptr_t>(acc) % 16 == 0;
    if (vec)
      add_kernel<T, true><<<blocks, kThreads, 0, s>>>(ids, x, counts, acc,
                                                      out, M, D, V);
    else
      add_kernel<T, false><<<blocks, kThreads, 0, s>>>(ids, x, counts, acc,
                                                       out, M, D, V);
  }
  const int blocks = min((V + kWarps - 1) / kWarps, 132 * 16);
  write_kernel<T><<<blocks, kThreads, 0, s>>>(counts, acc, out, D, V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// ids: (M,) int64 in [0, V); dx: (M, D) in the compute dtype; counts:
// (V,) int32 scratch; out: (V, D) in the compute dtype, every row written.
// table: (V, D) float scratch of which only the rows of repeated ids are
// touched, for bf16; for float32 it is out itself (pass out twice). A
// 16-byte aligned table and out when D is a multiple of 8.
extern "C" int idvs_scatter_add_rows(const void* ids, const void* dx,
                                     void* counts, void* table, void* out,
                                     int M, int D, int V, int dtype,
                                     void* stream) {
  using namespace idvs;
  if (M < 0 || D < 1 || V < 1 || !counts || !table || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* i = static_cast<const long long*>(ids);
  int* f = static_cast<int*>(counts);
  float* t = static_cast<float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (table != out) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch<float>(i, dx, f, t, static_cast<float*>(out), M, D, V, s));
  }
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(
        i, dx, f, t, static_cast<__nv_bfloat16*>(out), M, D, V, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

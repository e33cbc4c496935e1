// Row passes of the post-LN tails' backward (proj_resln.cu, mlp_resln.cu):
// the LayerNorm backward with the dropout, and deterministic column sums.
//
// Replaces the row-local half of idvs/morec_tpu/ops/pallas/mlp.py
// _bwd_proj_kernel (:739-758) and _bwd_post_kernel (:463-483): from the
// saved, cast pre-LN sum y_pre it recomputes the float LN statistics and
//   xhat = (y_pre - mu) * rstd
//   dyp  = rstd * (dout*g - mean(dout*g) - xhat * mean(dout*g * xhat))
//   dres = cast(dyp)                                   (proj tail only)
//   dz   = dropout(dyp) with the forward's mask, cast -> the matmul side
// and the column sums dgamma = sum(dout * xhat), dbeta = sum(dout),
// db = sum(dropout(dyp)) (float, before the cast, as the Pallas kernels).
// The products of the backward (dW = xᵀ dz, dx = dz Wᵀ, ...) run in
// gemm.cu. This is the products route of resln_bwd_plan (ops/cuda/mlp.py):
// C = 768 and 2048, and float32 at every C; bf16 at C <= 512 takes the fused
// route, resln_bwd_wg.cu, which runs this pass as its prologue.
//
// Bound on the H100: pure bandwidth (y_pre and dout in, dz and dres out).
// The TPU kernels accumulate the column sums in a resident buffer over a
// sequential grid; here every block reduces its rows (one warp per row,
// lane l owning columns 4l + 128j) into registers, then through shared
// memory into one partial row per block, and a second pass adds the
// blocks' partials in a fixed order, so the sums are deterministic.
#include "common.cuh"
#include "dropout.cuh"
#include "reduce.cuh"
#include "rowtile.cuh"

namespace idvs {
namespace {

using rowtile::load4;
using rowtile::store4;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const T* __restrict__ ypre, const T* __restrict__ dout,
                       const float* __restrict__ gamma, T* __restrict__ dres,
                       float* __restrict__ dyp_out, T* __restrict__ dz,
                       float* __restrict__ partials, int M, float eps,
                       Drop drop) {
  constexpr int C = 128 * NG, V = 4 * NG;
  extern __shared__ float red[];   // [kWarps][3][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float g[V], pg[V] = {}, pb[V] = {}, pd[V] = {};
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const float4 t = load4(gamma + 4 * lane + 128 * j);
    g[4 * j] = t.x, g[4 * j + 1] = t.y, g[4 * j + 2] = t.z,
          g[4 * j + 3] = t.w;
  }
  for (int row = blockIdx.x * kWarps + warp; row < M;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * C;
    float y[V], d[V];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * lane + 128 * j;
      const float4 a = load4(ypre + base + col), b = load4(dout + base + col);
      y[4 * j] = a.x, y[4 * j + 1] = a.y, y[4 * j + 2] = a.z,
            y[4 * j + 3] = a.w;
      d[4 * j] = b.x, d[4 * j + 1] = b.y, d[4 * j + 2] = b.z,
            d[4 * j + 3] = b.w;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sum += y[v];
      sq += y[v] * y[v];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / C;
    const float var = fmaxf(sq / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      y[v] = (y[v] - mu) * rstd;        // xhat
      const float dx = d[v] * g[v];
      s1 += dx;
      s2 += dx * y[v];
      pg[v] += d[v] * y[v];
      pb[v] += d[v];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * lane + 128 * j;
      float o[4], z[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = 4 * j + c;
        o[c] = rstd * (d[v] * g[v] - m1 - y[v] * m2);
        z[c] = drop.apply(o[c], static_cast<uint32_t>(base + col + c));
        pd[v] += z[c];
      }
      const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
      if (dres != nullptr) store4(dres + base + col, o4);
      if (dyp_out != nullptr) store4(dyp_out + base + col, o4);
      store4(dz + base + col, make_float4(z[0], z[1], z[2], z[3]));
    }
  }
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = 4 * j + c, col = 4 * lane + 128 * j + c;
      red[(warp * 3 + 0) * C + col] = pg[v];
      red[(warp * 3 + 1) * C + col] = pb[v];
      red[(warp * 3 + 2) * C + col] = pd[v];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 3 * C + e];
    partials[static_cast<size_t>(blockIdx.x) * 3 * C + e] = s;
  }
}

// The same pass at C = 2048 (SASRec under the vision towers), where a
// warp's 64 columns a lane would not fit the registers: the block's 256
// threads share one row, thread t owning columns 4t + 1024j, so the row
// sums cross the warps through shared memory and each thread's column sums
// are the block's own (no shared reduction at the end).
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kWarps]) {
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();   // the last read of red is over
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_wide_kernel(const T* __restrict__ ypre,
                            const T* __restrict__ dout,
                            const float* __restrict__ gamma,
                            T* __restrict__ dres, float* __restrict__ dyp_out,
                            T* __restrict__ dz, float* __restrict__ partials,
                            int M, float eps, Drop drop) {
  constexpr int C = 2048, NG = C / (4 * kThreads), V = 4 * NG;
  __shared__ float red[2][kWarps];
  float g[V], pg[V] = {}, pb[V] = {}, pd[V] = {};
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const float4 t = load4(gamma + 4 * threadIdx.x + 4 * kThreads * j);
    g[4 * j] = t.x, g[4 * j + 1] = t.y, g[4 * j + 2] = t.z,
          g[4 * j + 3] = t.w;
  }
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * C;
    float y[V], d[V];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * threadIdx.x + 4 * kThreads * j;
      const float4 a = load4(ypre + base + col), b = load4(dout + base + col);
      y[4 * j] = a.x, y[4 * j + 1] = a.y, y[4 * j + 2] = a.z,
            y[4 * j + 3] = a.w;
      d[4 * j] = b.x, d[4 * j + 1] = b.y, d[4 * j + 2] = b.z,
            d[4 * j + 3] = b.w;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sum += y[v];
      sq += y[v] * y[v];
    }
    block_sum2(sum, sq, red);
    const float mu = sum / C;
    const float var = fmaxf(sq / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      y[v] = (y[v] - mu) * rstd;        // xhat
      const float dx = d[v] * g[v];
      s1 += dx;
      s2 += dx * y[v];
      pg[v] += d[v] * y[v];
      pb[v] += d[v];
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * threadIdx.x + 4 * kThreads * j;
      float o[4], z[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = 4 * j + c;
        o[c] = rstd * (d[v] * g[v] - m1 - y[v] * m2);
        z[c] = drop.apply(o[c], static_cast<uint32_t>(base + col + c));
        pd[v] += z[c];
      }
      const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
      if (dres != nullptr) store4(dres + base + col, o4);
      if (dyp_out != nullptr) store4(dyp_out + base + col, o4);
      store4(dz + base + col, make_float4(z[0], z[1], z[2], z[3]));
    }
  }
  float* part = partials + static_cast<size_t>(blockIdx.x) * 3 * C;
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = 4 * j + c, col = 4 * threadIdx.x + 4 * kThreads * j + c;
      part[0 * C + col] = pg[v];
      part[1 * C + col] = pb[v];
      part[2 * C + col] = pd[v];
    }
}

// part[by][n] = sum over rows r = by, by + gridDim.y, ... of x[r][n]
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ x,
                              float* __restrict__ part, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = blockIdx.y; r < M; r += gridDim.y)
    s += to_f32(x[static_cast<size_t>(r) * N + n]);
  part[static_cast<size_t>(blockIdx.y) * N + n] = s;
}

template <typename T, int NG>
cudaError_t launch_rows(const void* ypre, const void* dout,
                        const float* gamma, void* dres, float* dyp, void* dz,
                        float* part, float* sums, int nb, int M, float eps,
                        Drop drop, cudaStream_t s) {
  constexpr int C = 128 * NG;
  const size_t smem = sizeof(float) * kWarps * 3 * C;
  auto kernel = ln_bwd_rows_kernel<T, NG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nb, kThreads, smem, s>>>(
      static_cast<const T*>(ypre), static_cast<const T*>(dout), gamma,
      static_cast<T*>(dres), dyp, static_cast<T*>(dz), part, M, eps, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, sums, nb, 3 * C, s);
}

template <typename T>
cudaError_t launch_rows_wide(const void* ypre, const void* dout,
                             const float* gamma, void* dres, float* dyp,
                             void* dz, float* part, float* sums, int nb,
                             int M, float eps, Drop drop, cudaStream_t s) {
  ln_bwd_rows_wide_kernel<T><<<nb, kThreads, 0, s>>>(
      static_cast<const T*>(ypre), static_cast<const T*>(dout), gamma,
      static_cast<T*>(dres), dyp, static_cast<T*>(dz), part, M, eps, drop);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, sums, nb, 3 * 2048, s);
}

template <typename T>
cudaError_t dispatch_rows(const void* ypre, const void* dout,
                          const float* gamma, void* dres, float* dyp,
                          void* dz, float* part, float* sums, int nb, int M,
                          int C, float eps, Drop d, cudaStream_t s) {
  switch (C) {
    case 128:
      return launch_rows<T, 1>(ypre, dout, gamma, dres, dyp, dz, part, sums,
                               nb, M, eps, d, s);
    case 256:
      return launch_rows<T, 2>(ypre, dout, gamma, dres, dyp, dz, part, sums,
                               nb, M, eps, d, s);
    case 512:
      return launch_rows<T, 4>(ypre, dout, gamma, dres, dyp, dz, part, sums,
                               nb, M, eps, d, s);
    case 768:
      return launch_rows<T, 6>(ypre, dout, gamma, dres, dyp, dz, part, sums,
                               nb, M, eps, d, s);
    case 2048:
      return launch_rows_wide<T>(ypre, dout, gamma, dres, dyp, dz, part, sums,
                                 nb, M, eps, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace idvs

// ypre, dout: (M, C) in the compute dtype; gamma: (C,) float. Writes
// dz (M, C) in the compute dtype, dres (M, C, compute dtype) and dyp
// (M, C, float) when they are not null, and sums (3, C) float = dgamma,
// dbeta, db. part: nb * 3 * C floats of scratch; nb blocks. C must be 128,
// 256, 512, 768 or 2048. Dropout as the forward (dropout.cuh).
extern "C" int idvs_resln_bwd_rows(const void* ypre, const void* dout,
                                   const void* gamma, void* dres, void* dyp,
                                   void* dz, void* part, void* sums, int nb,
                                   int M, int C, float eps, unsigned drop_key,
                                   unsigned drop_thresh, float drop_scale,
                                   int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Drop d{drop_key, drop_thresh, drop_scale};
  const float* g = static_cast<const float*>(gamma);
  float* yp = static_cast<float*>(dyp);
  float* pt = static_cast<float*>(part);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(dispatch_rows<float>(ypre, dout, g, dres, yp, dz,
                                                 pt, sm, nb, M, C, eps, d,
                                                 s));
  if (dtype == kBF16)
    return static_cast<int>(dispatch_rows<__nv_bfloat16>(
        ypre, dout, g, dres, yp, dz, pt, sm, nb, M, C, eps, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (N,) float = the column sums of x (M, N, compute dtype), through nb
// row groups: part holds nb * N floats of scratch.
extern "C" int idvs_colsum(const void* x, void* part, void* out, int nb,
                           int M, int N, int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || N < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 255) / 256, nb);
  if (dtype == kF32)
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                              pt, M, N);
  else if (dtype == kBF16)
    colsum_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pt, M, N);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(pt, static_cast<float*>(out), nb, N, s));
}

// Row passes of the pre-LN MLP's backward (fused_mlp, fused_mlp_res): the
// LayerNorm recomputed, DropPath's per-row scale on the cotangent, and the
// LayerNorm's backward with its column sums.
//
// Replaces the row-local half of idvs/morec_tpu/ops/pallas/mlp.py
// _bwd_kernel (:166-172, :180-185, :195-210). The backward of
//   out = [x +] [s *] dense2(cast(act(dense1(cast(LN(x))))))
// runs as (products in gemm.cu, with the rounding points of the TPU kernel):
//   xn  = cast(LN_f32(x))                           ln_rows_kernel
//   h   = f32(xn @ W1) + b1                         gemm, float out
//         (or the forward's saved cast(h), the save_h edition)
//   dy  = cast(s[row] * dout)                       scale_rows_kernel
//   dW2 = cast(act(h))^T dy,  db2 = colsum(dy)      gemm (act on load)
//   dh  = cast((dy @ W2^T) * act'(h))               gemm (gate epilogue)
//   dW1 = xn^T dh,  db1 = colsum(dh)                gemm
//   dxn = f32(dh @ W1^T)                            gemm, float out
//   dx  = cast(LN_bwd_f32(dxn) [+ dout])            ln_bwd_rows_kernel
//   dgamma = colsum(dxn * xhat), dbeta = colsum(dxn)  ln_colsums_kernel
// The TPU kernel keeps the (BM, F) tiles of h and dh in VMEM and adds the
// weight gradients into a resident buffer over a sequential grid. Here the
// (M, F) h and dh pass through device memory once each between products
// (4-5 % of the step's time at F = 4C; gemm.cu's tensor cores, as 3xTF32
// in float32), and the sums over rows are split and added in a fixed
// order.
//
// Bound on the H100: these row passes are pure bandwidth (x, dxn and dout
// in, xn or dx out). One warp a row, lanes striding the C columns, so any
// width goes (Swin's 96..768 are no multiples of 128); the column sums run
// a thread a column over row groups, then reduce.cuh adds the groups.
#include "common.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// xn = cast(LN(x)); stats[row] = (mu, rstd). The fast variance
// E[x^2] - E[x]^2 clamped at 0, as the forward (premlp.cu).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ xn,
                   float2* __restrict__ stats, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + warp; row < M;
       row += gridDim.x * kWarps) {
    const T* xr = x + static_cast<size_t>(row) * C;
    float sum = 0.f, sq = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float v = to_f32(xr[k]);
      sum += v;
      sq += v * v;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / C;
    const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + eps);
    T* out = xn + static_cast<size_t>(row) * C;
    for (int k = lane; k < C; k += 32)
      out[k] = from_f32<T>((to_f32(xr[k]) - mu) * rstd * gamma[k] + beta[k]);
    if (lane == 0) stats[row] = make_float2(mu, rstd);
  }
}

// dy = cast(scale[row] * dout)
template <typename T>
__global__ void scale_rows_kernel(const T* __restrict__ dout,
                                  const float* __restrict__ scale,
                                  T* __restrict__ dy, size_t n, int C) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dy[i] = from_f32<T>(to_f32(dout[i]) * scale[i / C]);
}

// dx = cast(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + dout)
// with dxhat = dxn * gamma; dout (the residual branch) may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dxn,
                       const float* __restrict__ gamma,
                       const float2* __restrict__ stats,
                       const T* __restrict__ dout, T* __restrict__ dx, int M,
                       int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + warp; row < M;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * C;
    const float mu = stats[row].x, rstd = stats[row].y;
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float dxhat = dxn[base + k] * gamma[k];
      s1 += dxhat;
      s2 += dxhat * (to_f32(x[base + k]) - mu) * rstd;
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int k = lane; k < C; k += 32) {
      const float xhat = (to_f32(x[base + k]) - mu) * rstd;
      float v = rstd * (dxn[base + k] * gamma[k] - m1 - xhat * m2);
      if (dout != nullptr) v += to_f32(dout[base + k]);
      dx[base + k] = from_f32<T>(v);
    }
  }
}

// part[by][0][n] = sum over rows r = by, by + gridDim.y, ... of
// dxn[r][n] * xhat[r][n]; part[by][1][n] the same sum of dxn[r][n]
template <typename T>
__global__ void ln_colsums_kernel(const T* __restrict__ x,
                                  const float* __restrict__ dxn,
                                  const float2* __restrict__ stats,
                                  float* __restrict__ part, int M, int C) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= C) return;
  float pg = 0.f, pb = 0.f;
  for (int r = blockIdx.y; r < M; r += gridDim.y) {
    const size_t i = static_cast<size_t>(r) * C + n;
    const float2 st = stats[r];
    const float d = dxn[i];
    pg += d * (to_f32(x[i]) - st.x) * st.y;
    pb += d;
  }
  part[(static_cast<size_t>(blockIdx.y) * 2 + 0) * C + n] = pg;
  part[(static_cast<size_t>(blockIdx.y) * 2 + 1) * C + n] = pb;
}

int row_blocks(int M) {
  const int blocks = (M + kWarps - 1) / kWarps;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

template <typename T>
cudaError_t ln_rows(const void* x, const float* gamma, const float* beta,
                    void* xn, float2* stats, int M, int C, float eps,
                    cudaStream_t s) {
  ln_rows_kernel<T><<<row_blocks(M), kThreads, 0, s>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(xn), stats, M, C,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scale_rows(const void* dout, const float* scale, void* dy, int M,
                       int C, cudaStream_t s) {
  scale_rows_kernel<T><<<132 * 8, 256, 0, s>>>(
      static_cast<const T*>(dout), scale, static_cast<T*>(dy),
      static_cast<size_t>(M) * C, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_bwd(const void* x, const float* dxn, const float* gamma,
                   const float2* stats, const void* dout, void* dx,
                   float* part, float* sums, int nb, int M, int C,
                   cudaStream_t s) {
  ln_bwd_rows_kernel<T><<<row_blocks(M), kThreads, 0, s>>>(
      static_cast<const T*>(x), dxn, gamma, stats,
      static_cast<const T*>(dout), static_cast<T*>(dx), M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_colsums_kernel<T><<<dim3((C + 127) / 128, nb), 128, 0, s>>>(
      static_cast<const T*>(x), dxn, stats, part, M, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, sums, nb, 2 * C, s);
}

}  // namespace
}  // namespace idvs

// x, xn: (M, C) in the compute dtype; gamma, beta: (C,) float; stats:
// (M, 2) float, which receives each row's (mean, 1/std).
extern "C" int idvs_premlp_ln_rows(const void* x, const void* gamma,
                                   const void* beta, void* xn, void* stats,
                                   int M, int C, float eps, int dtype,
                                   void* stream) {
  using namespace idvs;
  if (M < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float2* st = static_cast<float2*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(ln_rows<float>(x, g, b, xn, st, M, C, eps, s));
  if (dtype == kBF16)
    return static_cast<int>(
        ln_rows<__nv_bfloat16>(x, g, b, xn, st, M, C, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy (M, C) = cast(scale[row] * dout), scale (M,) float.
extern "C" int idvs_scale_rows(const void* dout, const void* scale, void* dy,
                               int M, int C, int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(scale_rows<float>(dout, sc, dy, M, C, s));
  if (dtype == kBF16)
    return static_cast<int>(scale_rows<__nv_bfloat16>(dout, sc, dy, M, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The LayerNorm's backward from x (M, C, compute dtype), its stats from
// idvs_premlp_ln_rows, and dxn (M, C) float: writes dx (M, C, compute
// dtype), adding dout (compute dtype) when it is not null, and sums (2, C)
// float = dgamma, dbeta. part: nb * 2 * C floats of scratch; nb row groups.
extern "C" int idvs_premlp_ln_bwd(const void* x, const void* dxn,
                                  const void* gamma, const void* stats,
                                  const void* dout, void* dx, void* part,
                                  void* sums, int nb, int M, int C, int dtype,
                                  void* stream) {
  using namespace idvs;
  if (M < 1 || C < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* d = static_cast<const float*>(dxn);
  const float* g = static_cast<const float*>(gamma);
  const float2* st = static_cast<const float2*>(stats);
  float* pt = static_cast<float*>(part);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        ln_bwd<float>(x, d, g, st, dout, dx, pt, sm, nb, M, C, s));
  if (dtype == kBF16)
    return static_cast<int>(
        ln_bwd<__nv_bfloat16>(x, d, g, st, dout, dx, pt, sm, nb, M, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

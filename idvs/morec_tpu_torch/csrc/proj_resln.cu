// out = LN(res + dropout(x @ W + b)), forward: the post-LN attention tail
// of BERT (attention_output + attention_ln) and of SASRec (fc + ln_attn,
// with a zero bias).
//
// Replaces idvs/morec_tpu/ops/pallas/mlp.py _fwd_proj_only_kernel (the
// custom-VJP primal of fused_proj_resln, when ypre is null) and
// _fwd_proj_kernel (the training edition, which also stores the cast pre-LN
// sum y_pre for the backward, resln_bwd.cu), body _fwd_proj_body, with the
// in-kernel dropout of dropout.cuh.
//
// Bound on the H100: a (M, C) x (C, C) product at C = 512 does 2*C = 1024
// flops per byte of W and M*C*2 bytes of x/res/out traffic; at M = 15360 it
// is compute-bound on the float units (f32 parity forbids TF32 tensor
// cores), while the LN epilogue is pure bandwidth.
// Design: one 256-thread block per 32-row tile owns all C output columns
// (an 8 x 8 register tile per thread at C = 512, rowtile.cuh), so the
// dropout, the residual add, the cast and the LN run on the accumulator
// before the single (M, C) store: device memory sees x and res in and out
// out, plus y_pre in the training edition. K is walked in 16-deep slices, double-buffered through
// shared memory with the next slice's loads in flight during the FMAs.
#include "rowtile.cuh"

namespace idvs {
namespace {

using namespace rowtile;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    proj_resln_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const T* __restrict__ w, const T* __restrict__ b,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out,
                      T* __restrict__ ypre, int M, float eps, Drop drop) {
  using Lay = Layout<C>;
  constexpr int kBM = Lay::BM, kBK = Lay::BK, kLdA = Lay::LDA;
  constexpr int kSlices = C / kBK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* At = smem;                        // 2 x [kBK][kLdA]  x slices
  float* Bs = At + 2 * kBK * kLdA;         // 2 x [kBK][C]     W slices
  float* red = Bs + 2 * kBK * C;           // [Lay::kRedFloats]
  const int row0 = blockIdx.x * kBM;
  const int row_off = Lay::wr() * Lay::TR;
  const int col_off = Lay::wc() * 128 * Lay::NG;

  float acc[Lay::TR][4 * Lay::NG] = {};
  ASlice<T, kBM, kBK> a;
  BSlice<T, C, kBK> bw;
  a.load(x, C, row0, M, 0);
  bw.load(w, C, 0, 0);
  for (int t = 0; t < kSlices; ++t) {
    float* at = At + (t & 1) * kBK * kLdA;
    float* bs = Bs + (t & 1) * kBK * C;
    a.store(at);
    bw.store(bs);
    __syncthreads();
    if (t + 1 < kSlices) {     // next slice in flight during the FMAs
      a.load(x, C, row0, M, (t + 1) * kBK);
      bw.load(w, C, (t + 1) * kBK, 0);
    }
    fma_slice<Lay::TR, Lay::NG, C, kBK, kLdA>(acc, at, bs, row_off,
                                               col_off);
  }
  ln_epilogue<T, C>(acc, b, res, gamma, beta, out, row0, M, eps, red, drop,
                    ypre);
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* res, const void* w,
                   const void* b, const float* gamma, const float* beta,
                   void* out, void* ypre, int M, float eps, Drop drop,
                   cudaStream_t stream) {
  using Lay = Layout<C>;
  constexpr int kBM = Lay::BM;
  const size_t smem = sizeof(float) * (2 * Lay::BK * Lay::LDA +
                                       2 * Lay::BK * C + Lay::kRedFloats);
  auto kernel = proj_resln_kernel<T, C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<const T*>(b), gamma, beta,
      static_cast<T*>(out), static_cast<T*>(ypre), M, eps, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* res, const void* w,
                     const void* b, const float* gamma, const float* beta,
                     void* out, void* ypre, int M, int C, float eps, Drop d,
                     cudaStream_t s) {
  switch (C) {
    case 128:
      return launch<T, 128>(x, res, w, b, gamma, beta, out, ypre, M, eps, d, s);
    case 256:
      return launch<T, 256>(x, res, w, b, gamma, beta, out, ypre, M, eps, d, s);
    case 512:
      return launch<T, 512>(x, res, w, b, gamma, beta, out, ypre, M, eps, d, s);
    case 2048:   // 8-row tiles
      return launch<T, 2048>(x, res, w, b, gamma, beta, out, ypre, M, eps, d,
                             s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace idvs

// x, res, out: (M, C); w: (C, C) in (in, out) layout; b: (C,) in the compute
// dtype; gamma, beta: (C,) float. C must be 128, 256, 512 or 2048. ypre:
// (M, C) in the compute dtype, or null for the forward-only edition.
// Dropout:
// drop_key = mix32(seed), drop_thresh = 0 for none (dropout.cuh).
extern "C" int idvs_proj_resln_fwd(const void* x, const void* res,
                                   const void* w, const void* b,
                                   const void* gamma, const void* beta,
                                   void* out, void* ypre, int M, int C,
                                   float eps, unsigned drop_key,
                                   unsigned drop_thresh, float drop_scale,
                                   int dtype, void* stream) {
  using namespace idvs;
  const Drop d{drop_key, drop_thresh, drop_scale};
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        dispatch<float>(x, res, w, b, g, bt, out, ypre, M, C, eps, d, s));
  if (dtype == kBF16)
    return static_cast<int>(
        dispatch<__nv_bfloat16>(x, res, w, b, g, bt, out, ypre, M, C, eps, d,
                                s));
  return static_cast<int>(cudaErrorInvalidValue);
}

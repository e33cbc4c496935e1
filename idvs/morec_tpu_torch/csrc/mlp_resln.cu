// out = LN(x + dropout(act(x @ W1 + b1) @ W2 + b2)), forward: the post-LN
// FFN tail of BERT (intermediate/output/output_ln, exact GELU) and of SASRec
// (w_1/w_2/ln_ffn, ReLU), and the entry point's third activation,
// quick_gelu h * sigmoid(1.702 h) (mlp.py _act_f32 :83-96).
//
// Replaces idvs/morec_tpu/ops/pallas/mlp.py _fwd_post_only_kernel (the
// custom-VJP primal of fused_mlp_resln, when ypre and h are null) and
// _fwd_post_kernel (the training edition, which also stores the cast pre-LN
// sum y_pre and the cast pre-activation h = x @ W1 + b1 for the backward,
// mlp.py:403-419), body _fwd_post_body, with the in-kernel dropout of
// dropout.cuh. GELU uses CUDA's erff; the Pallas kernel's Abramowitz-Stegun
// erf was a Mosaic workaround.
//
// Bound on the H100: 4*C*F flops per row at C = 512, F = 2048; in f32 (no
// TF32, for parity) it is bound by the float FMA rate. The (M, F)
// intermediate is 4x the size of x: writing and re-reading it would triple
// the tail's device-memory traffic.
// Design: one 256-thread block per 32-row tile keeps its x tile resident in
// shared memory and walks F in chunks (256 wide at C = 512): h = act(x @
// W1[:, chunk] + b1) is cast to the compute dtype (mlp.py:406) and parked
// in shared memory, then folded into the block's (32, C) dense2
// accumulator in registers (an 8 x 8 tile per thread). The forward-only
// edition never writes the intermediate to device memory (the training
// edition stores the cast pre-activation once, for the backward); the
// residual add, the dropout, the cast and the LN run on the accumulator
// (rowtile.cuh). Weight slices are double-buffered with
// the next slice's loads in flight during the FMAs.
#include "rowtile.cuh"

namespace idvs {
namespace {

using namespace rowtile;

// the numbering of ops/cuda/mlp.py ACTS; gemm.cu numbers its own
enum Act { kGelu = 0, kRelu = 1, kQuickGelu = 2 };

template <int ACT>
__device__ __forceinline__ float act(float h) {
  if (ACT == kRelu) return fmaxf(h, 0.f);
  if (ACT == kQuickGelu) return h / (1.f + expf(-1.702f * h));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// F is walked in chunks of FC = 128 * WC columns: in dense1 every lane owns
// one 4-column group of the chunk (a TR x 4 tile of h).
template <int C>
__host__ __device__ constexpr int f_chunk() { return 128 * Layout<C>::WC; }

template <int C>
constexpr size_t mlp_smem_floats() {
  using Lay = Layout<C>;
  return C * Lay::LDA + f_chunk<C>() * Lay::LDA + 2 * Lay::BK * C +
         Lay::kRedFloats;
}

template <typename T, int C, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_resln_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ out,
                     T* __restrict__ ypre, T* __restrict__ hsave, int M,
                     int F, float eps, Drop drop) {
  using Lay = Layout<C>;
  constexpr int TR = Lay::TR, FC = f_chunk<C>();
  constexpr int kBM = Lay::BM, kBK = Lay::BK, kLdA = Lay::LDA;
  constexpr int kSlices1 = C / kBK, kSlices2 = FC / kBK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Xt = smem;                // [C][kLdA]      x tile, transposed
  float* Ht = Xt + C * kLdA;       // [FC][kLdA]     act(h) chunk, transposed
  float* Ws = Ht + FC * kLdA;      // 2 x [kBK][C]   W1 or W2 slices
  float* red = Ws + 2 * kBK * C;   // [Lay::kRedFloats]
  const int row0 = blockIdx.x * kBM;
  const int l = threadIdx.x & 31;
  const int row_off = Lay::wr() * TR;
  const int col1 = Lay::wc() * 128;            // dense1 column span
  const int col2 = Lay::wc() * 128 * Lay::NG;  // dense2 column span

  // the x tile stays resident for the whole F walk
  for (int i = threadIdx.x; i < kBM * C / 4; i += kThreads) {
    const int r = i / (C / 4), k = 4 * (i % (C / 4));
    const int row = row0 + r;
    const float4 v = row < M ? load4(x + static_cast<size_t>(row) * C + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    Xt[(k + 0) * kLdA + r] = v.x;
    Xt[(k + 1) * kLdA + r] = v.y;
    Xt[(k + 2) * kLdA + r] = v.z;
    Xt[(k + 3) * kLdA + r] = v.w;
  }

  float acc[TR][4 * Lay::NG] = {};
  for (int f0 = 0; f0 < F; f0 += FC) {
    // dense1: h = x @ W1[:, f0:f0+FC], double-buffered over K = C
    float h[TR][4] = {};
    BSlice<T, FC, kBK> s1;
    s1.load(w1, F, 0, f0);
    for (int t = 0; t < kSlices1; ++t) {
      float* ws = Ws + (t & 1) * kBK * C;
      s1.store(ws);
      __syncthreads();
      if (t + 1 < kSlices1) s1.load(w1, F, (t + 1) * kBK, f0);
      fma_slice<TR, 1, FC, kBK, kLdA>(h, Xt + t * kBK * kLdA, ws, row_off,
                                      col1);
    }
    // cast(act(h + b1)) into the chunk buffer; the previous chunk's reads
    // of Ht ended before the first barrier of the loop above
    const float4 bv = load4(b1 + f0 + col1 + 4 * l);
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
    if (hsave != nullptr) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = row0 + row_off + r;
        if (row < M)
          store4(hsave + static_cast<size_t>(row) * F + f0 + col1 + 4 * l,
                 make_float4(h[r][0] + bb[0], h[r][1] + bb[1],
                             h[r][2] + bb[2], h[r][3] + bb[3]));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < TR; ++r)
        Ht[(col1 + 4 * l + c) * kLdA + row_off + r] =
            round_to<T>(act<ACT>(h[r][c] + bb[c]));
    // dense2: acc += h @ W2[f0:f0+FC, :], double-buffered over K = FC
    BSlice<T, C, kBK> s2;
    s2.load(w2, C, f0, 0);
    for (int t = 0; t < kSlices2; ++t) {
      float* ws = Ws + (t & 1) * kBK * C;
      s2.store(ws);
      __syncthreads();
      if (t + 1 < kSlices2) s2.load(w2, C, f0 + (t + 1) * kBK, 0);
      fma_slice<TR, Lay::NG, C, kBK, kLdA>(acc, Ht + t * kBK * kLdA, ws,
                                           row_off, col2);
    }
  }
  ln_epilogue<T, C>(acc, b2, x, gamma, beta, out, row0, M, eps, red, drop,
                    ypre);
}

template <typename T, int C, int ACT>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const float* gamma,
                   const float* beta, void* out, void* ypre, void* hsave,
                   int M, int F, float eps, Drop drop, cudaStream_t stream) {
  if (F % f_chunk<C>() != 0) return cudaErrorInvalidValue;
  constexpr int kBM = Layout<C>::BM;
  const size_t smem = sizeof(float) * mlp_smem_floats<C>();
  auto kernel = mlp_resln_kernel<T, C, ACT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), gamma, beta, static_cast<T*>(out),
      static_cast<T*>(ypre), static_cast<T*>(hsave), M, F, eps, drop);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t dispatch_c(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const float* g,
                       const float* bt, void* out, void* yp, void* hs, int M,
                       int C, int F, float eps, Drop d, cudaStream_t s) {
  switch (C) {
    case 128:
      return launch<T, 128, ACT>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, F,
                                 eps, d, s);
    case 256:
      return launch<T, 256, ACT>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, F,
                                 eps, d, s);
    case 512:
      return launch<T, 512, ACT>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, F,
                                 eps, d, s);
    case 2048:   // 8-row tiles
      return launch<T, 2048, ACT>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, F,
                                  eps, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const float* g,
                     const float* bt, void* out, void* yp, void* hs, int M,
                     int C, int F, float eps, int activation, Drop d,
                     cudaStream_t s) {
  if (activation == kGelu)
    return dispatch_c<T, kGelu>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, C,
                                F, eps, d, s);
  if (activation == kRelu)
    return dispatch_c<T, kRelu>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M, C,
                                F, eps, d, s);
  if (activation == kQuickGelu)
    return dispatch_c<T, kQuickGelu>(x, w1, b1, w2, b2, g, bt, out, yp, hs, M,
                                     C, F, eps, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace idvs

// x, out: (M, C); w1: (C, F) and w2: (F, C) in (in, out) layout; b1: (F,),
// b2: (C,) in the compute dtype; gamma, beta: (C,) float. C must be 128,
// 256 or 512 and F a multiple of 128 (of 256 at C = 512), or 2048 with F a
// multiple of 1024. activation: 0 = exact GELU, 1 = ReLU, 2 = quick_gelu.
// ypre (M, C) and h (M, F), in the compute dtype, are both given (training
// edition) or both null. Dropout: drop_key = mix32(seed), drop_thresh = 0
// for none (dropout.cuh).
extern "C" int idvs_mlp_resln_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* gamma,
                                  const void* beta, void* out, void* ypre,
                                  void* h, int M, int C, int F, float eps,
                                  int activation, unsigned drop_key,
                                  unsigned drop_thresh, float drop_scale,
                                  int dtype, void* stream) {
  using namespace idvs;
  const Drop d{drop_key, drop_thresh, drop_scale};
  if (M < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(dispatch<float>(x, w1, b1, w2, b2, g, bt, out,
                                            ypre, h, M, C, F, eps, activation,
                                            d, s));
  if (dtype == kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        x, w1, b1, w2, b2, g, bt, out, ypre, h, M, C, F, eps, activation, d,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
}

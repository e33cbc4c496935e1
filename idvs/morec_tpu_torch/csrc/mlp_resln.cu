// out = LN(x + dropout(act(x @ W1 + b1) @ W2 + b2)), forward: the post-LN
// FFN tail of BERT (intermediate/output/output_ln, exact GELU) and of SASRec
// (w_1/w_2/ln_ffn, ReLU), and the entry point's third activation,
// quick_gelu h * sigmoid(1.702 h) (mlp.py _act_f32 :83-96).
//
// Replaces idvs/morec_tpu/ops/pallas/mlp.py _fwd_post_only_kernel (the
// custom-VJP primal of fused_mlp_resln, when ypre and h are null) and
// _fwd_post_kernel (the training edition, which also stores the cast pre-LN
// sum y_pre and the cast pre-activation h = x @ W1 + b1 for the backward,
// mlp.py:397-419), with the in-kernel dropout of dropout.cuh. GELU uses
// CUDA's erff; the Pallas kernel's Abramowitz-Stegun erf was a Mosaic
// workaround. Rounding points as the Pallas kernel's: h in float, g =
// cast(act(h)), y = f32(g @ W2) + b2, dropout, y_pre = cast(y + x), the LN
// statistics of the cast y_pre with the fast variance E[y^2] - E[y]^2
// clamped at 0 (flax).
//
// Bound on the H100: 4*C*F flops a row. BERT's tail (M = 23040 rows of a
// text step, C = 512, F = 2048) is bound by operations (0.098 ms at the
// 989 TFLOP/s bf16 rate); SASRec's at D = 2048 (M = 10 to 640 rows, F =
// 8192) reads 67 MB of bf16 weights (134 MB in float32) for 0.9-43 GFLOP,
// bound by bytes at every M the main paths run in float32 and at M <= 295
// in bf16. Two routes:
//
// bf16 at C = 128, 256, 512 (mlp_resln_mma_kernel), on the tensor cores:
// the dense1 -> act -> dense2 chain of mlp_mma.cuh (premlp.cu's: the
// block's rows of x by cp.async into a bf16 tile, W1 and W2 slices through
// one ring, mma.sync m16n8k16 with float accumulators, bias, activation and
// cast once an element, the cast pre-activation stored by the training
// edition), then the post-LN epilogue on the (BM, C) accumulators: b2, the
// dropout at element row * C + col, the residual from the x tile still in
// shared memory, the cast, y_pre's store, and the row statistics by quad
// shuffles and, across the WN column warps, through shared memory in a
// fixed order. Rows past M are zeros and never stored. The block plan is
// mlp_resln_plan in ops/cuda/mlp.py (premlp_plan's layouts), passed to the
// launch and checked against the instantiation.
//
// C = 2048 in both dtypes, and float32 at every C: a block cannot hold a
// (rows, 2048) float accumulator for more than 8 rows, and 8-row blocks
// each streamed all of W1 and W2 from L2 (10.7 GB at M = 640 in float32;
// M = 10 filled 2 SMs). In float32 at C <= 512 a block body on the float
// FMA units (one 256-thread block per 32 rows) was slower than its plain
// version at the text encode's M = 15360 and ran a request's M = 20 on one
// SM (PERF.md). So h goes through device memory (10 MB in bf16 at M = 640
// beside 67 MB of weights) and the two products are gemm.cu's, split over
// M, N and K to fill the card whatever M (float32 as 3xTF32 on the tensor
// cores): h = f32(x @ W1) + b1 (bias epilogue, float out), g =
// cast(act(h)) (gemm.cu's act pre-pass in bf16, on load in float32, in
// dense1's epilogue in a float32 forward alone), y =
// f32(g @ W2) split over K with a fixed-order sum; then
// post_ln_rows_kernel: b2, dropout, residual, cast, y_pre and the LN (the
// projection tail's route at C = 2048 and in float32 takes the same row
// pass, at every kernel width). The wrapper (ops/cuda/mlp.py) composes
// them; the other split, blocks of (rows, F slice) writing float partial
// sums of dense2, was not built (PERF.md).
#include "mlp_mma.cuh"
#include "rowtile.cuh"

namespace idvs {
namespace {

using rowtile::load4;
using rowtile::store4;

// ---- bf16 at C <= 512: the tensor-core body (mlp_mma.cuh) --------------------

struct PostArgs {
  const void *x, *w1, *b1, *w2, *b2;   // the compute dtype
  const float *gamma, *beta;
  void *out, *ypre, *hsave;            // ypre and hsave: both, or both null
  int M, F;
  float eps;
  int act;
  Drop drop;
};

// MmaCfg with the epilogue's [2][WN][BM] float row sums after the chain
template <int C, int FC, int RW, int WN, int S>
using PostCfg = MmaCfg<C, FC, RW, WN, S, sizeof(float) * 2 * WN * 16 * RW>;

template <typename K>
__global__ void __launch_bounds__(K::threads, K::threads <= 256 ? 2 : 1)
    mlp_resln_mma_kernel(PostArgs p) {
  extern __shared__ __align__(16) unsigned char post_smem[];
  MlpChain<K> chain(post_smem, static_cast<const bf16*>(p.w1),
                    static_cast<const bf16*>(p.b1),
                    static_cast<const bf16*>(p.w2),
                    static_cast<bf16*>(p.hsave), p.M, p.F);
  chain.start(static_cast<const bf16*>(p.x));
  float acc[K::NJ2][4] = {};
  chain.run(p.act, acc);
  // the residual is x, still in its shared tile (zeros past M)
  const bf16* xs = chain.Xs;
  auto resid = [=](int r, int, int col) {
    return pair_f32(xs + r * K::ldx + col);
  };
  post_ln_epilogue<K>(acc, static_cast<const bf16*>(p.b2), resid, p.gamma,
                      p.beta, static_cast<bf16*>(p.out),
                      static_cast<bf16*>(p.ypre), p.drop, chain.row0, p.M,
                      p.eps, reinterpret_cast<float*>(post_smem +
                                                      K::chain_smem));
}

// The block plan the launch passes (mlp_resln_plan in ops/cuda/mlp.py):
// rows a block, F chunk, threads and shared-memory bytes.
struct Plan {
  int rows, f_chunk, threads;
  long long smem;
};

template <int C, int FC, int RW, int WN, int S>
cudaError_t launch_mma(const PostArgs& p, const Plan& plan, cudaStream_t s) {
  using K = PostCfg<C, FC, RW, WN, S>;
  if (p.F % FC != 0 || plan.rows != K::BM || plan.f_chunk != FC ||
      plan.threads != K::threads ||
      plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  auto kernel = mlp_resln_mma_kernel<K>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + K::BM - 1) / K::BM, K::threads, K::smem, s>>>(p);
  return cudaGetLastError();
}

// (FC, RW, WN, stages) by C, as mlp_resln_plan gives them
cudaError_t dispatch_bf16(const PostArgs& p, const Plan& k, int C,
                          cudaStream_t s) {
  switch (C) {
    case 128: return launch_mma<128, 64, 8, 1, 3>(p, k, s);
    case 256: return launch_mma<256, 128, 4, 2, 3>(p, k, s);
    case 512: return launch_mma<512, 256, 4, 4, 3>(p, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the row pass after gemm.cu's products ---------------------------------

constexpr int kRowThreads = 256;

// threads a row at width C: C / 4 up to a block's kRowThreads, so that each
// holds 4 NG columns in NG 4-column groups 4 RT apart
template <int C>
__host__ __device__ constexpr int row_threads() {
  return C / 4 < kRowThreads ? C / 4 : kRowThreads;
}

// kRowThreads / RT rows a block (one at C = 2048, 4 at C = 512), RT
// threads a row: y_pre = cast(dropout(y + b) + res), stored when asked,
// then the LN of y_pre with the row's sums added in a fixed order (lanes by
// xor shuffles, then the row's warps in order through shared memory). The
// tails' second half where a block cannot hold a row's accumulators (C =
// 2048) or the product ran in float32 (gemm.cu's 3xTF32 body): the FFN
// tail's res is x, the projection tail's its residual input.
template <typename T, int C>
__global__ void __launch_bounds__(kRowThreads)
    post_ln_rows_kernel(const float* __restrict__ y, const T* __restrict__ b,
                        const T* __restrict__ res,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out,
                        T* __restrict__ ypre, int M, float eps, Drop drop) {
  constexpr int RT = row_threads<C>(), NG = C / (4 * RT);
  constexpr int kRows = kRowThreads / RT, kRowWarps = RT / 32;
  static_assert(NG * 4 * RT == C && RT % 32 == 0, "whole warps a row");
  __shared__ float red[2][kRowThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x % RT;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRows +
                     threadIdx.x / RT;
  const bool live = row < static_cast<size_t>(M);   // a row's warps alike
  float v[NG][4];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int col = 4 * t + 4 * RT * j;
    const float4 a = live ? load4(y + row * C + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 r = live ? load4(res + row * C + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bb = load4(b + col);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
    const float rv[4] = {r.x, r.y, r.z, r.w};
    const uint32_t index = static_cast<uint32_t>(row * C + col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[j][c] = round_to<T>(drop.apply(av[c] + bv[c], index + c) + rv[c]);
      sum += v[j][c];
      sq += v[j][c] * v[j][c];
    }
    if (ypre != nullptr && live)
      store4(ypre + row * C + col,
             make_float4(v[j][0], v[j][1], v[j][2], v[j][3]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(~0u, sum, o);
    sq += __shfl_xor_sync(~0u, sq, o);
  }
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (!live) return;
  sum = sq = 0.f;
  const int w0 = warp / kRowWarps * kRowWarps;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    sum += red[0][w0 + w];
    sq += red[1][w0 + w];
  }
  const float mu = sum / C;
  const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int col = 4 * t + 4 * RT * j;
    const float4 g4 = load4(gamma + col), be = load4(beta + col);
    store4(out + row * C + col,
           make_float4((v[j][0] - mu) * rstd * g4.x + be.x,
                       (v[j][1] - mu) * rstd * g4.y + be.y,
                       (v[j][2] - mu) * rstd * g4.z + be.z,
                       (v[j][3] - mu) * rstd * g4.w + be.w));
  }
}

template <typename T, int C>
cudaError_t launch_rows(const float* y, const void* b, const void* res,
                        const float* gamma, const float* beta, void* out,
                        void* ypre, int M, float eps, Drop drop,
                        cudaStream_t s) {
  constexpr int kRows = kRowThreads / row_threads<C>();
  post_ln_rows_kernel<T, C><<<(M + kRows - 1) / kRows, kRowThreads, 0, s>>>(
      y, static_cast<const T*>(b), static_cast<const T*>(res), gamma, beta,
      static_cast<T*>(out), static_cast<T*>(ypre), M, eps, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const float* y, const void* b, const void* res,
                          const float* gamma, const float* beta, void* out,
                          void* ypre, int M, int C, float eps, Drop d,
                          cudaStream_t s) {
  switch (C) {
    case 128:
      return launch_rows<T, 128>(y, b, res, gamma, beta, out, ypre, M, eps,
                                 d, s);
    case 256:
      return launch_rows<T, 256>(y, b, res, gamma, beta, out, ypre, M, eps,
                                 d, s);
    case 512:
      return launch_rows<T, 512>(y, b, res, gamma, beta, out, ypre, M, eps,
                                 d, s);
    case 2048:
      return launch_rows<T, 2048>(y, b, res, gamma, beta, out, ypre, M, eps,
                                  d, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace idvs

// x, out: (M, C); w1: (C, F) and w2: (F, C) in (in, out) layout; b1: (F,),
// b2: (C,) bf16; gamma, beta: (C,) float. C must be 128, 256 or 512, F a
// multiple of the plan's chunk; rows, f_chunk, threads, smem: the block
// plan (mlp_resln_plan), which must be the one built for C. activation: 0
// = exact GELU, 1 = ReLU, 2 = quick_gelu. ypre (M, C) and h (M, F), bf16,
// are both given (training edition) or both null. Dropout: drop_key =
// mix32(seed), drop_thresh = 0 for none (dropout.cuh). Operands 16-byte
// aligned. dtype must be bf16: the other routes compose gemm.cu's products
// and the row pass.
extern "C" int idvs_mlp_resln_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* gamma,
                                  const void* beta, void* out, void* ypre,
                                  void* h, int M, int C, int F, float eps,
                                  int activation, unsigned drop_key,
                                  unsigned drop_thresh, float drop_scale,
                                  int rows, int f_chunk, int threads,
                                  long long smem, int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || F < 1 || activation < 0 || activation > 2 ||
      ((ypre == nullptr) != (h == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PostArgs p{x, w1, b1, w2, b2, static_cast<const float*>(gamma),
                   static_cast<const float*>(beta), out, ypre, h, M, F, eps,
                   activation, Drop{drop_key, drop_thresh, drop_scale}};
  const Plan plan{rows, f_chunk, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bf16(p, plan, C, s));
}

// The row pass of the tails composed from gemm.cu's products (C = 2048,
// and both tails in float32): y (M, C) float, the products' sum
// before the bias b; b, res, out and ypre (null outside training) in the
// compute dtype, gamma and beta float. out = LN(cast(dropout(y + b) +
// res)) and ypre = cast(dropout(y + b) + res), the dropout at element row
// * C + col. C must be 128, 256, 512 or 2048; every operand 16-byte
// aligned.
extern "C" int idvs_post_ln_rows(const void* y, const void* b,
                                 const void* res, const void* gamma,
                                 const void* beta, void* out, void* ypre,
                                 int M, int C, float eps, unsigned drop_key,
                                 unsigned drop_thresh, float drop_scale,
                                 int dtype, void* stream) {
  using namespace idvs;
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Drop d{drop_key, drop_thresh, drop_scale};
  const float* yf = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        dispatch_rows<float>(yf, b, res, g, bt, out, ypre, M, C, eps, d, s));
  if (dtype == kBF16)
    return static_cast<int>(dispatch_rows<__nv_bfloat16>(
        yf, b, res, g, bt, out, ypre, M, C, eps, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

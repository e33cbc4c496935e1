// out = LN(res + dropout(x @ W + b)), forward: the post-LN attention tail
// of BERT (attention_output + attention_ln) and of SASRec (fc + ln_attn,
// with a zero bias).
//
// Replaces idvs/morec_tpu/ops/pallas/mlp.py _fwd_proj_only_kernel (the
// custom-VJP primal of fused_proj_resln, when ypre is null; pallas_call
// :811) and _fwd_proj_kernel (the training edition, :796, which also stores
// the cast pre-LN sum y_pre for the backward, resln_bwd.cu), body
// _fwd_proj_body (:691-706), with the in-kernel dropout of dropout.cuh.
// Rounding points as the Pallas body's: y = f32(x @ W) + b, dropout, y_pre
// = cast(y + res), the LN statistics of the cast y_pre.
//
// Bound on the H100: 2 C^2 flops a row. In bf16 at C = 512 a text train
// step's M = 23040 rows is 12.1 GFLOP, 0.0122 ms at the 989 TFLOP/s rate,
// below its 0.0283 ms of bytes (x, res, out and y_pre once): bound by
// bytes, as is every main path's call in bf16.
//
// bf16 at C = 128, 256, 512 (proj_resln_mma_kernel), on the tensor cores:
// mlp_mma.cuh's ProjChain (the block's rows of x by cp.async into a bf16
// tile, W's [32][C] slices streamed through a ring of cp.async stages,
// mma.sync m16n8k16 with the block's (BM, C) sum in float registers), then
// mlp_mma.cuh's post_ln_epilogue, shared with the FFN tail, on the
// accumulators: b, the dropout at element row * C + col, the residual read
// from device memory as bf16 pairs, the cast, y_pre's store (training
// edition only), the row statistics in a fixed order, the LN and one
// store. The block plan is proj_resln_plan in ops/cuda/mlp.py, passed to
// the launch and checked against the instantiation: 64-row blocks of 4 x 4
// warps where they fill the card, 16-row blocks of 1 x (C / 64) warps
// where they would not (SASRec's M = 2560 took 40 blocks on 132 SMs).
//
// C = 2048 (both dtypes) and float32 at every C do not run here: a block
// cannot hold a (rows, 2048) float sum for more than a few rows, and the
// float32 product runs faster on gemm.cu's 3xTF32 tensor-core body than on
// the FMA units (PERF.md). So idvs_proj_resln_products runs y = f32(x @ W)
// through gemm.cu and then mlp_resln.cu's post_ln_rows_kernel with res as
// the residual, in one call from ops/cuda/mlp.py proj_resln_products (one
// wrapper's host work where a request's float32 tail at small M is held
// by the host).
#include "mlp_mma.cuh"

namespace idvs {
namespace {

struct ProjArgs {
  const bf16 *x, *res, *w, *b;
  const float *gamma, *beta;
  bf16 *out, *ypre;   // ypre null outside training
  int M;
  float eps;
  Drop drop;
};

template <typename K>
__global__ void __launch_bounds__(K::threads, K::threads <= 256 ? 2 : 1)
    proj_resln_mma_kernel(ProjArgs p) {
  extern __shared__ __align__(16) unsigned char proj_smem[];
  ProjChain<K> chain(proj_smem, p.w, p.M);
  chain.start(p.x);
  float acc[K::NJ2][4] = {};
  chain.run(acc);
  const bf16* res = p.res;
  const int M = p.M;
  auto resid = [=](int, int row, int col) {
    return row < M ? pair_f32(res + static_cast<size_t>(row) * K::C + col)
                   : make_float2(0.f, 0.f);
  };
  post_ln_epilogue<K>(acc, p.b, resid, p.gamma, p.beta, p.out, p.ypre,
                      p.drop, chain.row0, p.M, p.eps,
                      reinterpret_cast<float*>(proj_smem + K::chain_smem));
}

// The block plan the launch passes (proj_resln_plan): rows a block,
// threads and shared-memory bytes.
struct Plan {
  int rows, threads;
  long long smem;
};

// Launches the instantiation (C, RW, WN, S) when the plan is its own;
// false when it is not
template <int C, int RW, int WN, int S>
bool launch(const ProjArgs& p, const Plan& plan, cudaStream_t s,
            cudaError_t& err) {
  using K = ProjCfg<C, RW, WN, S>;
  if (plan.rows != K::BM || plan.threads != K::threads ||
      plan.smem != static_cast<long long>(K::smem))
    return false;
  auto kernel = proj_resln_mma_kernel<K>;
  err = allow_smem(kernel, K::smem);
  if (err == cudaSuccess) {
    kernel<<<(p.M + K::BM - 1) / K::BM, K::threads, K::smem, s>>>(p);
    err = cudaGetLastError();
  }
  return true;
}

// (RW, WN, stages) by C, as proj_resln_plan gives them
cudaError_t dispatch(const ProjArgs& p, const Plan& k, int C,
                     cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (C) {
    case 128:
      launch<128, 4, 1, 3>(p, k, s, err) || launch<128, 1, 2, 3>(p, k, s, err);
      break;
    case 256:
      launch<256, 4, 2, 3>(p, k, s, err) || launch<256, 1, 4, 3>(p, k, s, err);
      break;
    case 512:
      launch<512, 4, 4, 2>(p, k, s, err) || launch<512, 2, 4, 3>(p, k, s, err) ||
          launch<512, 1, 8, 3>(p, k, s, err);
      break;
    default: break;
  }
  return err;
}

}  // namespace
}  // namespace idvs

// x, res, out: (M, C) bf16; w: (C, C) bf16 in (in, out) layout; b: (C,)
// bf16; gamma, beta: (C,) float; every operand 16-byte aligned. C must be
// 128, 256 or 512, and rows, threads, smem the block plan built for C
// (proj_resln_plan); dtype bf16 (the other routes compose gemm.cu and the
// row pass). ypre: (M, C) bf16, or null for the forward-only edition.
// Dropout: drop_key = mix32(seed), drop_thresh = 0 for none (dropout.cuh).
extern "C" int idvs_proj_resln_fwd(const void* x, const void* res,
                                   const void* w, const void* b,
                                   const void* gamma, const void* beta,
                                   void* out, void* ypre, int M, int C,
                                   float eps, unsigned drop_key,
                                   unsigned drop_thresh, float drop_scale,
                                   int rows, int threads, long long smem,
                                   int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const ProjArgs p{static_cast<const bf16*>(x),
                   static_cast<const bf16*>(res),
                   static_cast<const bf16*>(w),
                   static_cast<const bf16*>(b),
                   static_cast<const float*>(gamma),
                   static_cast<const float*>(beta),
                   static_cast<bf16*>(out),
                   static_cast<bf16*>(ypre),
                   M,
                   eps,
                   Drop{drop_key, drop_thresh, drop_scale}};
  return static_cast<int>(dispatch(p, Plan{rows, threads, smem}, C,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" int idvs_gemm(const void* A, const void* B, void* out,
                         const void* add, const void* gate, const void* bias,
                         void* ws, int M, int N, int K, long long sam,
                         long long sak, long long sbk, long long sbn,
                         int splits, int pro_act, int gate_act, int out_f32,
                         int a_f32, int gate_f32, int dtype, void* stream);
extern "C" int idvs_post_ln_rows(const void* y, const void* b,
                                 const void* res, const void* gamma,
                                 const void* beta, void* out, void* ypre,
                                 int M, int C, float eps, unsigned drop_key,
                                 unsigned drop_thresh, float drop_scale,
                                 int dtype, void* stream);

// The other route, C = 2048 (both dtypes) and float32 at every C: y = f32(x
// @ w) through idvs_gemm in `splits` K slices (idvs_gemm_splits(M, C, C,
// dtype, 0)), then idvs_post_ln_rows with res as the residual. ws holds
// (1 + splits) * M * C floats when splits > 1, else M * C: y, then the
// slices' partial sums. Operands as idvs_proj_resln_fwd's, in the compute
// dtype `dtype`.
extern "C" int idvs_proj_resln_products(
    const void* x, const void* res, const void* w, const void* b,
    const void* gamma, const void* beta, void* out, void* ypre, void* ws,
    int splits, int M, int C, float eps, unsigned drop_key,
    unsigned drop_thresh, float drop_scale, int dtype, void* stream) {
  if (M < 1 || C < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* y = static_cast<float*>(ws);
  const long long mc = static_cast<long long>(M) * C;
  const int err = idvs_gemm(x, w, y, nullptr, nullptr, nullptr,
                            splits > 1 ? y + mc : nullptr, M, C, C, C, 1, C,
                            1, splits, 0, 1, 1, 0, 0, dtype, stream);
  if (err) return err;
  return idvs_post_ln_rows(y, b, res, gamma, beta, out, ypre, M, C, eps,
                           drop_key, drop_thresh, drop_scale, dtype, stream);
}

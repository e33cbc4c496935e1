// The attention core of the windowed attention's backward (fused_mha_proj,
// fused_mha_proj_band): from the recomputed packed qkv and the context's
// cotangent to dqkv, the recomputed context and the bias gradient.
//
// Replaces idvs/morec_tpu/ops/pallas/attention.py _pbwd_kernel / _bbwd_kernel
// (:597-649, :873-933) with _attn_grads (:540-594). Nothing but x, the bias
// and the weights is saved by the forward, so the backward runs as
// (products in gemm.cu, rounding points as the TPU kernel's):
//   qkv   = cast(f32(x @ Wqkv) + bqkv)                        gemm
//   dctx  = cast(dout @ Wo^T)                                 gemm
//   per (window, head), this kernel:
//     p     = softmax_f32(q k^T / sqrt(dh) + bias[window % P, head])
//     ctx   = cast(cast(p) v)         (for dWo = ctx^T dout)
//     dv    = cast(p)^T dctx
//     dp    = dctx v^T
//     ds    = p * (dp - rowsum(dp * p))          float; -> dbias, unscaled
//     dsc   = cast(ds / sqrt(dh));  dq = dsc k;  dk = dsc^T q
//   dWo = ctx^T dout, dbo = colsum(dout)                      gemm, colsum
//   dWqkv = x^T dqkv, dbqkv = colsum(dqkv), dx = dqkv Wqkv^T  gemm, colsum
// The products around the core are row-wise, so they run on the rows as
// they lie: the window layout's (windows, T, C), or the band layout's
// (N, Hp, Wp, C) map. This kernel finds a window's tokens through the row
// index map of win_map.cuh (the forward's), so the band layout's backward
// never partitions x or dout into windows nor reverses dx.
//
// dbias (P, nh, T, T) sums the windows r with r % P = p (P = 1: every
// window; P = nW: the windows of one place in every image). The TPU kernel
// adds them into a resident buffer over a sequential grid. Here block
// (chunk, p, head) walks its share of those windows in order, keeps the sum
// on chip, and writes one partial plane; reduce.cuh adds the chunks in a
// fixed order, so two runs give the same bits. The chunks are chosen in
// one place, dbias_chunks (mha_mma.cuh), which idvs_win_attn_bwd_chunks
// reports to the wrapper for the scratch's size.
//
// Bound on the H100: bytes. Per (window, head) at T = 49, dh = 32 the core
// reads q, k, v and dctx and writes dq, dk, dv and ctx (6 (T, T, dh)
// products, about T operations a byte): 16 bytes a token and channel in
// bf16, 0.41 ms at Swin-T stage 0 for 288 images at 3.35 TB/s, half as
// much at each later stage.
//
// Both dtypes run fused_mha.cu's tensor-core backward, its dbias edition,
// shared through mha_mma.cuh in the kCtx edition that also stores ctx
// (one more P . V pass): bf16 tiles copied by cp.async and every product
// an mma.sync m16n8k16 tile with float accumulators
// (mha_bwd_mma_kernel<RG, true, true>), or float planes and every product
// as 3xTF32 on mma.sync m16n8k8 (mha_bwd_tf32_kernel<RG, true, true>); T
// padded to 16 with keys at -inf and dh zero-filled to 16s, the scores,
// softmax, dp and ds in registers, the dbias sums in registers (bf16) or a
// shared plane (float32, which also stages ds and pd through one plane:
// fewer registers and bytes a block, three blocks an SM at T = 49). Their
// blockings are that header's choose_blocking and choose_f32.
#include "mha_mma.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

// The chunks of the dtype's body at its blocking k (dbias_chunks), or a
// negative CUDA error: invalid value where k's tiles do not fit a block's
// shared memory (or T is above 128).
template <typename Plan>
int chunks_of(const Plan& k, int windows, int T_, int nh, int P) {
  if (T_ > 128 || k.smem > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  const cudaError_t err = dbias_slots<true>(k, &slots);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dbias_chunks(windows, P, nh, slots);
}

// Launches the dtype's body at its blocking k, then the fixed-order sum of
// the chunks' partial planes.
template <typename T, typename Plan>
int backward(const void* qkv, const float* bias, const void* dctx,
             void* dqkv, void* ctx, float* part, float* dbias, int windows,
             int chunks, const Geometry& g, const Plan& k,
             const TokenMap& map, cudaStream_t s) {
  if (g.T > 128 || k.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_bwd<true>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dctx),
      static_cast<T*>(dqkv), static_cast<T*>(ctx), part, windows, chunks, g,
      k, Drop{0u, 0u, 1.f}, map, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(part, dbias, chunks, g.P * g.nh * g.T * g.T, s));
}

}  // namespace
}  // namespace idvs

// qkv, dqkv: (rows, 3 * nh * dh) and dctx, ctx: (rows, nh * dh) in the
// compute dtype, their rows in the window layout (band = 0: window r's
// token t at row r * T + t) or the band layout (band = 1: images of nwr x
// nwc windows of w x w tokens; win_map.cuh). bias: float, element (window,
// head, i, j) at (window % P) * bias_sp + head * bias_sh + i * T + j,
// already rounded through the compute dtype by the wrapper. dbias: (P, nh,
// T, T) float; part: chunks * P * nh * T * T floats of scratch, chunks as
// idvs_win_attn_bwd_chunks gives them. cudaErrorInvalidValue for a geometry
// whose tiles do not fit a block's shared memory.
extern "C" int idvs_win_attn_bwd(const void* qkv, const void* bias,
                                 const void* dctx, void* dqkv, void* ctx,
                                 void* part, void* dbias, int windows, int T_,
                                 int nh, int dh, int P, int chunks,
                                 long long bias_sp, long long bias_sh,
                                 int band, int w, int nwc, int nwr,
                                 float scale, int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, 1, P, bias_sp, bias_sh, scale};
  const TokenMap map{band, w, nwc, nwr};
  if (windows < 1 || T_ < 1 || nh < 1 || dh < 1 || P < 1 || windows % P ||
      chunks < 1 || chunks > windows / P ||
      (band && (w * w != T_ || nwc < 1 || nwr < 1 ||
                windows % (nwc * nwr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return backward<float>(qkv, b, dctx, dqkv, ctx, pt, db, windows, chunks,
                           g, choose_f32(T_, dh, kBwdDbias, true), map, s);
  if (dtype == kBF16)
    return backward<bf16>(qkv, b, dctx, dqkv, ctx, pt, db, windows, chunks,
                          g, choose_blocking(T_, dh, kBwdDbias), map, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunks idvs_win_attn_bwd cuts each (bias row, head)'s windows / P
// windows into (dbias_chunks), or a negative CUDA error: invalid value for
// a geometry whose tiles do not fit a block's shared memory.
extern "C" int idvs_win_attn_bwd_chunks(int windows, int T_, int nh, int dh,
                                        int P, int dtype) {
  using namespace idvs;
  if (windows < 1 || P < 1 || windows % P || nh < 1 || T_ < 1 || dh < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return chunks_of(choose_f32(T_, dh, kBwdDbias, true), windows, T_, nh,
                     P);
  if (dtype == kBF16)
    return chunks_of(choose_blocking(T_, dh, kBwdDbias), windows, T_, nh, P);
  return -static_cast<int>(cudaErrorInvalidValue);
}

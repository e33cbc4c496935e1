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
// The band layout's windows are gathered and scattered by the wrapper, so
// one device body serves both layouts.
//
// dbias (P, nh, T, T) sums the windows r with r % P = p (P = 1: every
// window; P = nW: the windows of one place in every image). The TPU kernel
// adds them into a resident buffer over a sequential grid. Here block
// (chunk, p, head) walks its share of those windows in order, keeps the sum
// in shared memory (each element is owned by one thread), and writes one
// partial plane; reduce.cuh adds the chunks in a fixed order, so two runs
// give the same bits.
//
// Bound on the H100: six (T, T, dh) products a head at T = 49, dh = 32, all
// on the float FMA units out of shared memory; 12-25 % of the backward's
// operations, the rest being the projections in gemm.cu.
#include "common.cuh"
#include "mha_tile.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

constexpr int kThreads = 256;

struct Geometry {
  int windows, T, nh, dh, P, chunks;
  long long bias_sp, bias_sh;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    win_attn_bwd_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const T* __restrict__ dctx, T* __restrict__ dqkv,
                        T* __restrict__ ctx, float* __restrict__ dbias_part,
                        Geometry g) {
  extern __shared__ float smem[];
  const int T_ = g.T, dh = g.dh, ld = dh + 1, lds = T_ + 1;
  float* qs = smem;             // [T][dh + 1]
  float* ks = qs + T_ * ld;
  float* vs = ks + T_ * ld;
  float* os = vs + T_ * ld;     // [T][dh + 1]  dctx
  float* ps = os + T_ * ld;     // [T][T + 1]   p (float), then cast(p)
  float* ds = ps + T_ * lds;    // [T][T + 1]   dp, then cast(ds / sqrt(dh))
  float* da = ds + T_ * lds;    // [T][T]       the block's dbias sum

  const int h = blockIdx.x % g.nh;
  const int p = (blockIdx.x / g.nh) % g.P;
  const int chunk = blockIdx.x / (g.nh * g.P);
  const int per_slot = g.windows / g.P;            // windows of slot p
  const int per = (per_slot + g.chunks - 1) / g.chunks;
  const int i_end = min(per_slot, (chunk + 1) * per);
  const int H = g.nh * dh;
  const size_t row_stride = 3 * static_cast<size_t>(H);
  const float* bias_ph = bias + p * g.bias_sp + h * g.bias_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < T_ * T_; idx += kThreads) da[idx] = 0.f;

  for (int i = chunk * per; i < i_end; ++i) {
    const size_t r = static_cast<size_t>(i) * g.P + p;
    const T* base = qkv + r * T_ * row_stride + h * dh;
    __syncthreads();   // the last window's reads of the tiles are over
    load_head(base, row_stride, T_, dh, qs);
    load_head(base + H, row_stride, T_, dh, ks);
    load_head(base + 2 * H, row_stride, T_, dh, vs);
    load_head(dctx + r * T_ * H + h * dh, static_cast<size_t>(H), T_, dh, os);
    __syncthreads();
    // scores and dp = dctx . v^T, one (query, key) pair a thread
    for (int idx = threadIdx.x; idx < T_ * T_; idx += kThreads) {
      const int a = idx / T_, b = idx % T_;
      const float* qa = qs + a * ld;
      const float* kb = ks + b * ld;
      const float* oa = os + a * ld;
      const float* vb = vs + b * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qa[d], kb[d], s);
        dp = fmaf(oa[d], vb[d], dp);
      }
      ps[a * lds + b] = s * g.scale + bias_ph[idx];
      ds[a * lds + b] = dp;
    }
    __syncthreads();
    softmax_rows(ps, T_);
    // softmax backward in float, one warp a row (the rows softmax_rows gave
    // this warp); the unscaled ds goes to the bias sum, then p and ds are
    // replaced by their casts
    for (int a = warp; a < T_; a += kThreads >> 5) {
      float* pa = ps + a * lds;
      float* dsa = ds + a * lds;
      float dot = 0.f;
      for (int b = lane; b < T_; b += 32) dot = fmaf(dsa[b], pa[b], dot);
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(~0u, dot, o);
      for (int b = lane; b < T_; b += 32) {
        const float pv = pa[b];
        const float dsf = pv * (dsa[b] - dot);
        da[a * T_ + b] += dsf;
        dsa[b] = round_to<T>(dsf * g.scale);
        pa[b] = round_to<T>(pv);
      }
    }
    __syncthreads();
    // ctx = p . v, dq = ds . k, dk = ds^T . q, dv = p^T . dctx; thread
    // (t, d) owns all four
    T* gbase = dqkv + r * T_ * row_stride + h * dh;
    T* cbase = ctx + r * T_ * H + h * dh;
    for (int idx = threadIdx.x; idx < T_ * dh; idx += kThreads) {
      const int t = idx / dh, d = idx % dh;
      float c = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < T_; ++j) {
        c = fmaf(ps[t * lds + j], vs[j * ld + d], c);
        dq = fmaf(ds[t * lds + j], ks[j * ld + d], dq);
        dk = fmaf(ds[j * lds + t], qs[j * ld + d], dk);
        dv = fmaf(ps[j * lds + t], os[j * ld + d], dv);
      }
      cbase[static_cast<size_t>(t) * H + d] = from_f32<T>(c);
      T* row = gbase + t * row_stride + d;
      row[0] = from_f32<T>(dq);
      row[H] = from_f32<T>(dk);
      row[2 * H] = from_f32<T>(dv);
    }
  }
  // da's elements were written by the threads that own them in the row
  // loop above; the copy below reads across threads
  __syncthreads();
  float* out = dbias_part +
               ((static_cast<size_t>(chunk) * g.P + p) * g.nh + h) * T_ * T_;
  for (int idx = threadIdx.x; idx < T_ * T_; idx += kThreads)
    out[idx] = da[idx];
}

size_t smem_bytes(int T_, int dh) {
  return sizeof(float) * (4 * static_cast<size_t>(T_) * (dh + 1) +
                          2 * static_cast<size_t>(T_) * (T_ + 1) +
                          static_cast<size_t>(T_) * T_);
}

template <typename T>
cudaError_t launch(const void* qkv, const float* bias, const void* dctx,
                   void* dqkv, void* ctx, float* part, float* dbias,
                   const Geometry& g, size_t smem, cudaStream_t s) {
  auto kernel = win_attn_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<g.chunks * g.P * g.nh, kThreads, smem, s>>>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dctx),
      static_cast<T*>(dqkv), static_cast<T*>(ctx), part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, dbias, g.chunks, g.P * g.nh * g.T * g.T, s);
}

}  // namespace
}  // namespace idvs

// qkv, dqkv: (windows, T, 3 * nh * dh) and dctx, ctx: (windows, T, nh * dh)
// in the compute dtype. bias: float, element (window, head, i, j) at
// (window % P) * bias_sp + head * bias_sh + i * T + j, already rounded
// through the compute dtype by the wrapper. dbias: (P, nh, T, T) float;
// part: chunks * P * nh * T * T floats of scratch. P divides windows and
// 1 <= chunks <= windows / P. cudaErrorInvalidValue for a geometry whose
// tiles do not fit a block's shared memory.
extern "C" int idvs_win_attn_bwd(const void* qkv, const void* bias,
                                 const void* dctx, void* dqkv, void* ctx,
                                 void* part, void* dbias, int windows, int T_,
                                 int nh, int dh, int P, int chunks,
                                 long long bias_sp, long long bias_sh,
                                 float scale, int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{windows, T_, nh, dh, P, chunks, bias_sp, bias_sh, scale};
  if (windows < 1 || T_ < 1 || nh < 1 || dh < 1 || P < 1 || windows % P ||
      chunks < 1 || chunks > windows / P)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T_, dh);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        launch<float>(qkv, b, dctx, dqkv, ctx, pt, db, g, smem, s));
  if (dtype == kBF16)
    return static_cast<int>(
        launch<__nv_bfloat16>(qkv, b, dctx, dqkv, ctx, pt, db, g, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// bf16: fused_mha.cu's tensor-core backward, its dbias edition, shared
// through mha_mma.cuh (mha_bwd_mma_kernel<RG, true, true>, the kCtx
// edition that also stores ctx): bf16 tiles copied by cp.async, T padded
// to 16 with keys at -inf and dh zero-filled to 16s, every product an
// mma.sync m16n8k16 tile with float accumulators, scores, softmax, dp, ds
// and the dbias sums in registers, and one more P . V tile pass for ctx.
// Its blocking is that header's choose_blocking.
//
// float32: scalar float FMAs. One block (chunk, p, head) holds a window's
// q, k, v and dctx widened to float in shared memory with the (T, T)
// scores and dp, one (query, key) pair a thread for scores and dp and one
// (t, d) a thread looping over T for ctx, dq, dk and dv.
#include "mha_mma.cuh"
#include "mha_tile.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    win_attn_bwd_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ dctx,
                        float* __restrict__ dqkv, float* __restrict__ ctx,
                        float* __restrict__ dbias_part, int windows,
                        int chunks, Geometry g, TokenMap map) {
  extern __shared__ float smem[];
  const int T_ = g.T, dh = g.dh, ld = dh + 1, lds = T_ + 1;
  float* qs = smem;             // [T][dh + 1]
  float* ks = qs + T_ * ld;
  float* vs = ks + T_ * ld;
  float* os = vs + T_ * ld;     // [T][dh + 1]  dctx
  float* ps = os + T_ * ld;     // [T][T + 1]   p
  float* ds = ps + T_ * lds;    // [T][T + 1]   dp, then ds / sqrt(dh)
  float* da = ds + T_ * lds;    // [T][T]       the block's dbias sum
  int* off = reinterpret_cast<int*>(da + T_ * T_);   // [T] token offsets

  const int h = blockIdx.x % g.nh;
  const int p = (blockIdx.x / g.nh) % g.P;
  const int chunk = blockIdx.x / (g.nh * g.P);
  const int per_slot = windows / g.P;              // windows of slot p
  const int per = (per_slot + chunks - 1) / chunks;
  const int i_end = min(per_slot, (chunk + 1) * per);
  const int H = g.nh * dh;
  const size_t row_stride = 3 * static_cast<size_t>(H);
  const float* bias_ph = bias + p * g.bias_sp + h * g.bias_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < T_ * T_; idx += kThreads) da[idx] = 0.f;
  for (int t = threadIdx.x; t < T_; t += kThreads) off[t] = map.offset(t);

  for (int i = chunk * per; i < i_end; ++i) {
    const int r = i * g.P + p;
    const long long r0 = map.base(r, T_);
    // one head's (T, dh) tile of rows `stride` apart, widened
    auto load = [&](const float* src, size_t stride, float* dst) {
      for (int idx = threadIdx.x; idx < T_ * dh; idx += kThreads) {
        const int t = idx / dh, d = idx % dh;
        dst[t * ld + d] = src[(r0 + off[t]) * stride + d];
      }
    };
    __syncthreads();   // the last window's reads of the tiles are over
    load(qkv + h * dh, row_stride, qs);
    load(qkv + H + h * dh, row_stride, ks);
    load(qkv + 2 * H + h * dh, row_stride, vs);
    load(dctx + h * dh, static_cast<size_t>(H), os);
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
    // this warp); the unscaled ds goes to the bias sum
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
        dsa[b] = dsf * g.scale;
      }
    }
    __syncthreads();
    // ctx = p . v, dq = ds . k, dk = ds^T . q, dv = p^T . dctx; thread
    // (t, d) owns all four
    for (int idx = threadIdx.x; idx < T_ * dh; idx += kThreads) {
      const int t = idx / dh, d = idx % dh;
      float c = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < T_; ++j) {
        c = fmaf(ps[t * lds + j], vs[j * ld + d], c);
        dq = fmaf(ds[t * lds + j], ks[j * ld + d], dq);
        dk = fmaf(ds[j * lds + t], qs[j * ld + d], dk);
        dv = fmaf(ps[j * lds + t], os[j * ld + d], dv);
      }
      const long long row = r0 + off[t];
      ctx[row * H + h * dh + d] = c;
      float* out = dqkv + row * row_stride + h * dh + d;
      out[0] = dq;
      out[H] = dk;
      out[2 * H] = dv;
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

size_t f32_smem_bytes(int T_, int dh) {
  return sizeof(float) * (4 * static_cast<size_t>(T_) * (dh + 1) +
                          2 * static_cast<size_t>(T_) * (T_ + 1) +
                          static_cast<size_t>(T_) * T_) +
         sizeof(int) * T_;
}

// The shared memory a block of the dtype's body needs; 0 for a geometry the
// body does not take (bf16: T above 128).
size_t smem_bytes(int T_, int dh, int dtype) {
  if (dtype == kBF16)
    return T_ <= 128 ? choose_blocking(T_, dh, kBwdDbias).smem : 0;
  return f32_smem_bytes(T_, dh);
}

// The blocks the SMs hold at once of the bf16 body at its blocking, after
// opting the kernel into its shared memory.
cudaError_t bf16_slots(const Blocking& k, int* slots) {
  return with_rg(k.RG, [&](auto rg) {
    return resident(mha_bwd_mma_kernel<decltype(rg)::value, true, true>, k,
                    slots);
  });
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
  const size_t smem = smem_bytes(T_, dh, dtype);
  if (smem == 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = allow_smem(win_attn_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    win_attn_bwd_kernel<<<chunks * P * nh, kThreads, smem, s>>>(
        static_cast<const float*>(qkv), b, static_cast<const float*>(dctx),
        static_cast<float*>(dqkv), static_cast<float*>(ctx), pt, windows,
        chunks, g, map);
    err = cudaGetLastError();
  } else if (dtype == kBF16) {
    const Blocking k = choose_blocking(T_, dh, kBwdDbias);
    err = with_rg(k.RG, [&](auto rg) {
      auto kernel = mha_bwd_mma_kernel<decltype(rg)::value, true, true>;
      int slots = 0;
      cudaError_t e = resident(kernel, k, &slots);
      if (e != cudaSuccess) return e;
      kernel<<<chunks * P * nh, 32 * k.warps, k.smem, s>>>(
          static_cast<const bf16*>(qkv), b, static_cast<const bf16*>(dctx),
          static_cast<bf16*>(dqkv), static_cast<bf16*>(ctx), pt, windows,
          chunks, g, k, Drop{0u, 0u, 1.f}, map);
      return cudaGetLastError();
    });
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(pt, static_cast<float*>(dbias), chunks,
                                       P * nh * T_ * T_, s));
}

// The chunks idvs_win_attn_bwd cuts each (bias row, head)'s windows / P
// windows into (dbias_chunks), or a negative CUDA error: invalid value for
// a geometry whose tiles do not fit a block's shared memory.
extern "C" int idvs_win_attn_bwd_chunks(int windows, int T_, int nh, int dh,
                                        int P, int dtype) {
  using namespace idvs;
  if (windows < 1 || P < 1 || windows % P || nh < 1 || T_ < 1 || dh < 1 ||
      (dtype != kF32 && dtype != kBF16))
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(T_, dh, dtype);
  if (smem == 0 || smem > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  if (dtype == kBF16) {
    const cudaError_t err =
        bf16_slots(choose_blocking(T_, dh, kBwdDbias), &slots);
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return dbias_chunks(windows, P, nh, dtype, slots);
}

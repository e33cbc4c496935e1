// The pre-LN MLP's backward (fused_mlp, fused_mlp_res): the backward of
//   out = [x +] [s *] dense2(cast(act(dense1(cast(LN(x))))))
// with the rounding points of idvs/morec_tpu/ops/pallas/mlp.py _bwd_kernel
// (:134-210), which it replaces together with gemm.cu's products:
//   xn  = cast(LN_f32(x))            (x itself without the LayerNorm)
//   h   = f32(xn @ W1) + b1          (or the forward's saved cast(h))
//   dy  = cast(s[row] * dout)        (dout in the unit edition)
//   g   = cast(act(h)),  dg = f32(dy @ W2^T),  dh = cast(dg * act'(h))
//   dxn = f32(dh @ W1^T)
//   dx  = cast(LN_bwd_f32(dxn) [+ dout])          (cast(dxn [+ dout]))
//   dW2 = g^T dy, db2 = colsum(dy); dW1 = xn^T dh, db1 = colsum(dh);
//   dgamma = colsum(dxn * xhat), dbeta = colsum(dxn)
// The TPU kernel keeps a row block's h, g, dg and dh in VMEM and adds the
// weight gradients into resident buffers over a sequential grid. Three
// routes, chosen by premlp_bwd_plan (ops/cuda/mlp.py), the one place the
// route is decided; none is a fallback of another. Two are here; the
// third, "wg" (bf16 at C = 512, 768, 1024), is premlp_bwd_wg.cu's kernel
// between this file's row pass (ln_rows_kernel, dy too) and LayerNorm
// backward and gemm.cu's three products, that file's header.
//
// "fused" (bf16 at the widths premlp_bwd_mma_kernel is built for): one
// tensor-core kernel runs the row-local half and the three products along
// the rows, then gemm.cu runs dW2 = g^T dy and dW1 = xn^T dh over K = M
// (split, a fixed-order second pass). Bound on the H100: 10 M C F
// operations against 3 M C elements of traffic that the function needs,
// so bound by operations (0.337 ms a Swin-T stage for 288 images); the
// products route moved about 11.6 GB at stage 0 (h in float32 written
// once and read twice, dh three more round trips, dxn in float32), 3.5 ms
// at 3.35 TB/s alone, and launched 14 kernels. Design: a block of RW x WN
// warps owns BM = 16 RW rows. x and dout come in by cp.async into bf16
// [BM][C + 8] tiles (16 bytes of padding a row, as premlp.cu), where the
// LayerNorm runs in place (premlp.cu's forward arithmetic, each row's
// (mu, rstd) kept) and dout becomes dy. F is walked in chunks of FC = 32
// WN columns; the chunk's W1 columns [C][FC + 8] and W2 rows [FC][C + 8]
// sit in shared memory, one slot each: W2's slot is read first (dg) and
// refilled with the next chunk's rows while W1's slot serves h = xn W1c
// and, after the activation, dxn += dh W1c^T, so W1 crosses L2 once a
// block; then W1's slot is refilled while the next chunk's dg reads W2's.
// Warp (rw, wn) computes h and dg for its 16 rows and the chunk's 32
// columns from 32 wn (mma.sync m16n8k16 bf16, float accumulators,
// mma.cuh); the activation and its derivative run once an element on the
// accumulators (the activation a compile-time constant; GELU's erf as the
// TPU kernel's, mlp_mma.cuh's act_dact); g and dh are
// stored once as bf16 (M, F) for the weight gradients, through each warp's
// shared staging tile so that they leave as 16-byte pieces of rows (a
// first version stored the accumulators' 4-byte pairs, each warp store
// touching eight rows, and took 2.96 ms of device time at stage 0, where
// this one takes under 2, bench_swin and --profile, PERF.md); db1's
// column sums are taken
// from the cast dh by shuffles and, across the row warps, through shared
// memory. With WN = 1 the cast dh is packed straight into dxn's A
// fragments (premlp.cu's h); with WN > 1 it crosses the row group's warps
// through a bf16 [BM][FC + 8] tile and a named barrier. Two slots of each
// chunk's weights (one barrier a chunk) were tried at stage 0 and were
// slower; 64-row blocks, four an SM, beat 128-row blocks, two an SM, there
// (the blocks' barriers keep each block's warps in one phase, MMA or
// epilogue, and four blocks overlap them better). dxn accumulates in
// float registers, warp (rw, wn) owning C / WN of its rows' columns. The
// epilogue re-reads x (and dout for the residual) from device memory,
// takes the LayerNorm backward's row sums across the column warps through
// shared memory in a fixed order and stores dx; each block writes one
// partial row of (db2, dgamma, dbeta, db1), which two passes add in a
// fixed order (group_sums_kernel, then reduce.cuh's sum_partials): no
// atomics, so two runs give the same bits. xn (LN edition) and dy (scaled
// edition) are written once for the weight gradients.
//
// "products" (float32; bf16 at no width now: every bf16 width of
// PRE_F_CHUNK takes "fused" or "wg"): the row passes below
// around gemm.cu's products (as 3xTF32 in float32):
//   xn  = cast(LN_f32(x))                           ln_rows_kernel
//   h   = f32(xn @ W1) + b1                         gemm, float out
//   dy  = cast(s[row] * dout)                       ln_rows_kernel too
//   dW2 = cast(act(h))^T dy,  db2 = colsum(dy)      gemm (act on load)
//   dh  = cast((dy @ W2^T) * act'(h))               gemm (gate epilogue)
//   dW1 = xn^T dh,  db1 = colsum(dh)                gemm
//   dxn = f32(dh @ W1^T)                            gemm, float out
//   dx  = cast(LN_bwd_f32(dxn) [+ dout])            ln_bwd_rows_kernel
//   dgamma = colsum(dxn * xhat), dbeta = colsum(dxn)  ln_colsums_kernel
// These row passes are pure bandwidth: one warp a row, lanes striding the
// C columns, so any width goes; the column sums run a thread a column
// over row groups, then reduce.cuh adds the groups.
#include "mlp_mma.cuh"
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
// E[x^2] - E[x]^2 clamped at 0, as the forward (premlp.cu). With dy not
// null also dy = cast(scale[row] * dout) in the same pass (the scaled
// edition, which always has its LayerNorm).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ xn,
                   float2* __restrict__ stats, const T* __restrict__ dout,
                   const float* __restrict__ scale, T* __restrict__ dy,
                   int M, int C, float eps) {
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
    if (dy != nullptr) {
      const size_t base = static_cast<size_t>(row) * C;
      const float sc = scale[row];
      for (int k = lane; k < C; k += 32)
        dy[base + k] = from_f32<T>(to_f32(dout[base + k]) * sc);
    }
  }
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
                    void* xn, float2* stats, const void* dout,
                    const float* scale, void* dy, int M, int C, float eps,
                    cudaStream_t s) {
  ln_rows_kernel<T><<<row_blocks(M), kThreads, 0, s>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(xn), stats,
      static_cast<const T*>(dout), scale, static_cast<T*>(dy), M, C, eps);
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


// ---- the fused route: bf16 on the tensor cores -----------------------------

enum Res { kNoRes = 0, kUnit = 1, kScaled = 2 };

// bar.sync over `threads` threads of the block (a row group's warps)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The fused body's block plan at width C: RW x WN warps, BM = 16 RW rows,
// chunks of FC = 32 WN columns of F, MINB blocks an SM (the register cap of
// __launch_bounds__). Shared memory: the bf16 tiles Xs and Ds [BM][ldx],
// W1's slot [C][ld1], W2's slot [FC][ld2], with WN > 1 Hs [BM][ldh], and
// each warp's [16][ldst] staging tile of g (and of dh with WN = 1: with
// WN > 1 dh is in Hs); then the float rows' (mu, rstd) [BM] and db1's
// row-warp sums [RW][FC]. The epilogue's reductions alias the weight slots
// once the F walk is done.
template <int C_, int RW_, int WN_, int MINB_>
struct BwdCfg {
  static constexpr int C = C_, RW = RW_, WN = WN_, MINB = MINB_;
  static constexpr int BM = 16 * RW, threads = 32 * RW * WN, FC = 32 * WN;
  static constexpr int ldx = C + 8, ld1 = FC + 8, ld2 = C + 8, ldh = FC + 8;
  static constexpr int ldst = 32 + 8;
  static constexpr int NJ2 = C / WN / 8;   // dxn's n8 tiles a warp
  static constexpr int stage = (threads / 32) * 16 * ldst * (WN == 1 ? 2 : 1);
  static constexpr size_t tiles =
      sizeof(bf16) * (2 * BM * ldx + C * ld1 + FC * ld2 +
                      (WN > 1 ? BM * ldh : 0) + stage);
  static constexpr size_t smem =
      tiles + sizeof(float2) * BM + sizeof(float) * RW * FC;
  static_assert(C % 32 == 0 && NJ2 % 2 == 0, "whole k-steps, n8 pairs");
  static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
  // dgamma's and dbeta's row-warp sums [2][RW][C] in W1's slot, the
  // LayerNorm backward's row sums [2][WN][BM] in W2's
  static_assert(sizeof(float) * 2 * RW * C <= sizeof(bf16) * C * ld1,
                "column sums fit W1's slot");
  static_assert(sizeof(float) * 2 * WN * BM <= sizeof(bf16) * FC * ld2,
                "row sums fit W2's slot");
};

struct BwdArgs {
  const bf16 *x, *dout, *w1, *b1, *w2;
  const bf16* hsave;       // (M, F) the forward's cast(h), or null
  const float* scale;      // (M,) for kScaled
  const float *gamma, *beta;   // null: no LayerNorm
  bf16* dx;
  bf16* xn;                // (M, C) cast(LN(x)), LN edition only
  bf16* dy;                // (M, C) cast(s dout), kScaled only
  bf16 *g, *dh;            // (M, F) each
  float* part;             // (blocks, 3 C + F): db2, dgamma, dbeta, db1
  int M, F;
  float eps;
  int act, res;
};

// W2's rows [f0, f0 + FC), all C columns, into its slot [FC][ld2]
template <typename K>
__device__ __forceinline__ void load_w2(bf16* W2s, const bf16* w2, int f0) {
  constexpr int cpr = K::C / 8;
  for (int c = threadIdx.x; c < K::FC * cpr; c += K::threads) {
    const int n = c / cpr, k = c % cpr * 8;
    cp_async16(W2s + n * K::ld2 + k,
               w2 + static_cast<size_t>(f0 + n) * K::C + k);
  }
}

// W1's columns [f0, f0 + FC), all C rows, into its slot [C][ld1]
template <typename K>
__device__ __forceinline__ void load_w1(bf16* W1s, const bf16* w1, int F,
                                        int f0) {
  constexpr int cpr = K::FC / 8;
  for (int c = threadIdx.x; c < K::C * cpr; c += K::threads) {
    const int k = c / cpr, n = c % cpr * 8;
    cp_async16(W1s + k * K::ld1 + n, w1 + static_cast<size_t>(k) * F + f0 + n);
  }
}

// sum over the 8 lanes of a quad column (lanes q, q + 4, ..., q + 28): a
// 16-row column sum of one mma accumulator column, the same bits in each
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename K>
__global__ void __launch_bounds__(K::threads, K::MINB)
    premlp_bwd_mma_kernel(BwdArgs p) {
  constexpr int C = K::C, BM = K::BM, RW = K::RW, WN = K::WN, FC = K::FC;
  constexpr int NJ2 = K::NJ2;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* Xs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Ds = Xs + BM * K::ldx;
  bf16* W1s = Ds + BM * K::ldx;
  bf16* W2s = W1s + C * K::ld1;
  bf16* Hs = W2s + FC * K::ld2;
  // the warp's staging tiles of g and dh
  bf16* Gst = Hs + (WN > 1 ? BM * K::ldh : 0) + warp * 16 * K::ldst;
  bf16* Dst = Gst + (K::threads / 32) * 16 * K::ldst;
  float2* stats = reinterpret_cast<float2*>(bwd_smem + K::tiles);
  float* red1 = reinterpret_cast<float*>(stats + BM);
  const int rw = warp / WN, wn = warp % WN, g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * BM, M = p.M, F = p.F, nch = F / FC;
  const bool ln = p.gamma != nullptr;
  float* part = p.part + static_cast<size_t>(blockIdx.x) * (3 * C + F);

  // x's and dout's rows (zeros past M), then chunk 0's W2 and W1 slots,
  // three commit groups
  for (int c = tid; c < BM * (C / 8); c += K::threads) {
    const int r = c / (C / 8), k = c % (C / 8) * 8, row = row0 + r;
    const size_t off = row < M ? static_cast<size_t>(row) * C + k : 0;
    cp_async16_zfill(Xs + r * K::ldx + k, p.x + off, row < M ? 16 : 0);
    cp_async16_zfill(Ds + r * K::ldx + k, p.dout + off, row < M ? 16 : 0);
  }
  cp_async_commit();
  load_w2<K>(W2s, p.w2, 0);
  cp_async_commit();
  load_w1<K>(W1s, p.w1, F, 0);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  // in place: xn = cast(LN(x)) as premlp.cu's forward computes it (eight
  // lanes a row, the fast variance E[x^2] - E[x]^2 clamped at 0), each
  // row's (mu, rstd) kept; dy = cast(s[row] dout). Rows past M stay zeros.
  {
    const int sub = lane >> 3, sl = lane & 7;
    for (int r = 4 * warp + sub; r < BM; r += K::threads / 8) {
      const int row = row0 + r;
      if (ln) {
        bf16* xs = Xs + r * K::ldx;
        float sum = 0.f, sq = 0.f;
#pragma unroll 4
        for (int k = 2 * sl; k < C; k += 16) {
          const float2 v = pair_f32(xs + k);
          sum += v.x + v.y;
          sq += v.x * v.x + v.y * v.y;
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(~0u, sum, o);
          sq += __shfl_xor_sync(~0u, sq, o);
        }
        const float mu = sum / C;
        const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + p.eps);
        if (sl == 0) stats[r] = make_float2(mu, rstd);
        if (row < M) {
#pragma unroll 4
          for (int k = 2 * sl; k < C; k += 16) {
            const float2 v = pair_f32(xs + k);
            store_pair(xs + k, (v.x - mu) * rstd * p.gamma[k] + p.beta[k],
                       (v.y - mu) * rstd * p.gamma[k + 1] + p.beta[k + 1]);
          }
        }
      }
      if (p.res == kScaled && row < M) {
        const float s = p.scale[row];
        bf16* ds = Ds + r * K::ldx;
#pragma unroll 4
        for (int k = 2 * sl; k < C; k += 16) {
          const float2 v = pair_f32(ds + k);
          store_pair(ds + k, v.x * s, v.y * s);
        }
      }
    }
  }
  __syncthreads();
  // xn and dy once to device memory, for the weight gradients' products
  if (ln || p.res == kScaled) {
    for (int c = tid; c < BM * (C / 8); c += K::threads) {
      const int r = c / (C / 8), k = c % (C / 8) * 8, row = row0 + r;
      if (row >= M) continue;
      const size_t off = static_cast<size_t>(row) * C + k;
      if (ln)
        *reinterpret_cast<uint4*>(p.xn + off) =
            *reinterpret_cast<const uint4*>(Xs + r * K::ldx + k);
      if (p.res == kScaled)
        *reinterpret_cast<uint4*>(p.dy + off) =
            *reinterpret_cast<const uint4*>(Ds + r * K::ldx + k);
    }
  }

  const int pc = 32 * wn;          // the warp's 32 columns of a chunk
  const int oc = wn * (C / WN);    // and its C / WN columns of dxn
  const bf16* xa = Xs + (16 * rw + a_row(lane)) * K::ldx + a_col(lane);
  const bf16* da = Ds + (16 * rw + a_row(lane)) * K::ldx + a_col(lane);
  // the block's db1 partial of chunk f0's columns: the row warps' sums in
  // order
  auto db1_out = [&](int f0) {
    for (int t = tid; t < FC; t += K::threads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) s += red1[w * FC + t];
      part[3 * C + f0 + t] = s;
    }
  };
  float dxn[NJ2][4] = {};
  for (int ch = 0; ch < nch; ++ch) {
    const int f0 = ch * FC;
    // W2's slot has landed (W1's may be in flight)
    cp_async_wait<1>();
    __syncthreads();
    // dg = dy W2cᵀ: B(k = c, n = f) = W2s[n][k], an [n][k] tile
    float dg[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(da + kk));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(W2s + (pc + 16 * jp + bn_row(lane)) * K::ld2 +
                            kk + bn_col(lane)));
        mma_bf16(dg[2 * jp], a, b[0], b[1]);
        mma_bf16(dg[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // W1's slot has landed, every warp is done with W2's: refill it
    cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nch) load_w2<K>(W2s, p.w2, f0 + FC);
    cp_async_commit();
    // h = xn W1c: B(k = c, n = f) = W1s[k][n], a [k][n] tile
    float h[4][4] = {};
    if (p.hsave == nullptr) {
#pragma unroll
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(xa + kk));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(W1s + (kk + bk_row(lane)) * K::ld1 + pc +
                                16 * jp + bk_col(lane)));
          mma_bf16(h[2 * jp], a, b[0], b[1]);
          mma_bf16(h[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    // g = cast(act(h + b1)), dh = cast(dg act'(h + b1)), each stored once;
    // db1's column sums from the cast dh; dh as dxn's A fragments (k-step
    // ks: n8 tiles 2 ks and 2 ks + 1) or into Hs
    uint32_t ah[2][4];
    auto epi = [&](auto a_) {
      constexpr int A = decltype(a_)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = pc + 8 * j + 2 * q;
        float v[4];
        if (p.hsave == nullptr) {
          const float2 bb = pair_f32(p.b1 + f0 + col);
          v[0] = h[j][0] + bb.x;
          v[1] = h[j][1] + bb.y;
          v[2] = h[j][2] + bb.x;
          v[3] = h[j][3] + bb.y;
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 16 * rw + g + 8 * hh;
            const float2 hv =
                row < M ? pair_f32(p.hsave + static_cast<size_t>(row) * F +
                                   f0 + col)
                        : make_float2(0.f, 0.f);
            v[2 * hh] = hv.x;
            v[2 * hh + 1] = hv.y;
          }
        }
        float ga[4], da_[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) act_dact<A>(v[e], ga[e], da_[e]);
        const uint32_t dlo = pack_bf16(dg[j][0] * da_[0], dg[j][1] * da_[1]);
        const uint32_t dhi = pack_bf16(dg[j][2] * da_[2], dg[j][3] * da_[3]);
        const uint32_t glo = pack_bf16(ga[0], ga[1]);
        const uint32_t ghi = pack_bf16(ga[2], ga[3]);
        // g (and dh with one column warp; with more it goes to Hs below)
        // into the warp's staging tiles
        const int sc = g * K::ldst + 8 * j + 2 * q;
        *reinterpret_cast<uint32_t*>(Gst + sc) = glo;
        *reinterpret_cast<uint32_t*>(Gst + sc + 8 * K::ldst) = ghi;
        if constexpr (WN == 1) {
          *reinterpret_cast<uint32_t*>(Dst + sc) = dlo;
          *reinterpret_cast<uint32_t*>(Dst + sc + 8 * K::ldst) = dhi;
        }
        // the cast values (a bf16 is a float's high half); rows past M
        // hold dh = 0 (their dy is 0)
        const float c0 = col_sum(__uint_as_float(dlo << 16) +
                                 __uint_as_float(dhi << 16));
        const float c1 = col_sum(__uint_as_float(dlo & 0xffff0000u) +
                                 __uint_as_float(dhi & 0xffff0000u));
        if (g == 0) {
          red1[rw * FC + col] = c0;
          red1[rw * FC + col + 1] = c1;
        }
        if constexpr (WN == 1) {
          ah[j >> 1][(j & 1) * 2] = dlo;
          ah[j >> 1][(j & 1) * 2 + 1] = dhi;
        } else {
          bf16* hs = Hs + (16 * rw + g) * K::ldh + col;
          *reinterpret_cast<uint32_t*>(hs) = dlo;
          *reinterpret_cast<uint32_t*>(hs + 8 * K::ldh) = dhi;
        }
      }
    };
    if (p.act == kRelu)
      epi(std::integral_constant<int, kRelu>());
    else if (p.act == kQuickGelu)
      epi(std::integral_constant<int, kQuickGelu>());
    else
      epi(std::integral_constant<int, kGelu>());
    // the warp's 16 x 32 tiles of g and dh out as 16-byte pieces of rows
    // (a warp's 4-byte pairs would touch eight rows a store)
    __syncwarp();
    {
      const bf16* dsrc = WN == 1 ? Dst : Hs + 16 * rw * K::ldh + pc;
      constexpr int ldd = WN == 1 ? K::ldst : K::ldh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (lane >> 2) + 8 * i, c = (lane & 3) * 8;
        const int row = row0 + 16 * rw + r;
        if (row < M) {
          const size_t o = static_cast<size_t>(row) * F + f0 + pc + c;
          *reinterpret_cast<uint4*>(p.g + o) =
              *reinterpret_cast<const uint4*>(Gst + r * K::ldst + c);
          *reinterpret_cast<uint4*>(p.dh + o) =
              *reinterpret_cast<const uint4*>(dsrc + r * ldd + c);
        }
      }
    }
    if constexpr (WN > 1) named_barrier(1 + rw, 32 * WN);
    // dxn += dh W1cᵀ: k the chunk's FC columns, B(k = f, n = c) =
    // W1s[n][k], an [n][k] tile
#pragma unroll
    for (int ks = 0; ks < FC / 16; ++ks) {
      uint32_t a[4];
      if constexpr (WN == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ah[ks][i];
      } else {
        ldsm_x4(a, smem_u32(Hs + (16 * rw + a_row(lane)) * K::ldh + 16 * ks +
                            a_col(lane)));
      }
#pragma unroll
      for (int j = 0; j < NJ2; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(W1s + (oc + 8 * j + bn_row(lane)) * K::ld1 +
                            16 * ks + bn_col(lane)));
        mma_bf16(dxn[j], a, b[0], b[1]);
        mma_bf16(dxn[j + 1], a, b[2], b[3]);
      }
    }
    // every warp is done with W1's slot and Hs, red1 is whole: the
    // chunk's db1, then W1's refill
    __syncthreads();
    db1_out(f0);
    if (ch + 1 < nch) load_w1<K>(W1s, p.w1, F, f0 + FC);
    cp_async_commit();
  }

  // dx from dxn: the LayerNorm's backward, rstd (dxhat - mean(dxhat) -
  // xhat mean(dxhat xhat)) with dxhat = dxn gamma, xhat from x re-read;
  // the row sums over a lane's columns, the quad, then the column warps
  // through shared memory in a fixed order. The weight slots are free.
  float* redc = reinterpret_cast<float*>(W1s);   // [2][RW][C]
  float* redr = reinterpret_cast<float*>(W2s);   // [2][WN][BM]
  if (ln) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, mu[2], rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 st = stats[16 * rw + g + 8 * hh];
      mu[hh] = st.x;
      rs[hh] = st.y;
    }
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = oc + 8 * j + 2 * q;
      const float gm0 = p.gamma[col], gm1 = p.gamma[col + 1];
      float cg0 = 0.f, cg1 = 0.f, cb0 = 0.f, cb1 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 16 * rw + g + 8 * hh;
        float xh0 = 0.f, xh1 = 0.f;
        if (row < M) {
          const float2 xv = pair_f32(p.x + static_cast<size_t>(row) * C + col);
          xh0 = (xv.x - mu[hh]) * rs[hh];
          xh1 = (xv.y - mu[hh]) * rs[hh];
        }
        const float d0 = dxn[j][2 * hh], d1 = dxn[j][2 * hh + 1];
        const float e0 = d0 * gm0, e1 = d1 * gm1;
        s1[hh] += e0 + e1;
        s2[hh] += e0 * xh0 + e1 * xh1;
        cg0 += d0 * xh0;
        cg1 += d1 * xh1;
        cb0 += d0;
        cb1 += d1;
      }
      cg0 = col_sum(cg0);
      cg1 = col_sum(cg1);
      cb0 = col_sum(cb0);
      cb1 = col_sum(cb1);
      if (g == 0) {
        redc[rw * C + col] = cg0;
        redc[rw * C + col + 1] = cg1;
        redc[(RW + rw) * C + col] = cb0;
        redc[(RW + rw) * C + col + 1] = cb1;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[hh] += __shfl_xor_sync(~0u, s1[hh], o);
        s2[hh] += __shfl_xor_sync(~0u, s2[hh], o);
      }
    if constexpr (WN > 1) {
      if (q == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * rw + g + 8 * hh;
          redr[wn * BM + r] = s1[hh];
          redr[(WN + wn) * BM + r] = s2[hh];
        }
      }
    }
    __syncthreads();
    if constexpr (WN > 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * rw + g + 8 * hh;
        s1[hh] = s2[hh] = 0.f;
#pragma unroll
        for (int c = 0; c < WN; ++c) {
          s1[hh] += redr[c * BM + r];
          s2[hh] += redr[(WN + c) * BM + r];
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * rw + g + 8 * hh;
      if (row >= M) continue;
      const float m1 = s1[hh] / C, m2 = s2[hh] / C;
      const size_t base = static_cast<size_t>(row) * C;
#pragma unroll
      for (int j = 0; j < NJ2; ++j) {
        const int col = oc + 8 * j + 2 * q;
        const float2 xv = pair_f32(p.x + base + col);
        const float xh0 = (xv.x - mu[hh]) * rs[hh];
        const float xh1 = (xv.y - mu[hh]) * rs[hh];
        float v0 = rs[hh] * (dxn[j][2 * hh] * p.gamma[col] - m1 - xh0 * m2);
        float v1 =
            rs[hh] * (dxn[j][2 * hh + 1] * p.gamma[col + 1] - m1 - xh1 * m2);
        if (p.res != kNoRes) {
          const float2 dv = pair_f32(p.dout + base + col);
          v0 += dv.x;
          v1 += dv.y;
        }
        store_pair(p.dx + base + col, v0, v1);
      }
    }
  } else {
    // no LayerNorm: dx = cast(dxn [+ dout])
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * rw + g + 8 * hh;
      if (row >= M) continue;
      const size_t base = static_cast<size_t>(row) * C;
#pragma unroll
      for (int j = 0; j < NJ2; ++j) {
        const int col = oc + 8 * j + 2 * q;
        float v0 = dxn[j][2 * hh], v1 = dxn[j][2 * hh + 1];
        if (p.res != kNoRes) {
          const float2 dv = pair_f32(p.dout + base + col);
          v0 += dv.x;
          v1 += dv.y;
        }
        store_pair(p.dx + base + col, v0, v1);
      }
    }
  }
  // the block's partial row: db2 (the cast dy over its rows, in row
  // order), dgamma and dbeta (the row warps' sums, in order; 0 without a
  // LayerNorm)
  for (int t = tid; t < C; t += K::threads) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += __bfloat162float(Ds[r * K::ldx + t]);
    float sg = 0.f, sb = 0.f;
    if (ln) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        sg += redc[r * C + t];
        sb += redc[(RW + r) * C + t];
      }
    }
    part[t] = s;
    part[C + t] = sg;
    part[2 * C + t] = sb;
  }
}

// The block plan the launch passes (premlp_bwd_plan in ops/cuda/mlp.py)
struct BwdPlan {
  int rows, f_chunk, threads;
  long long smem;
};

template <typename K>
cudaError_t launch_bwd(const BwdArgs& p, const BwdPlan& plan, float* part2,
                       float* sums, int per, cudaStream_t s) {
  constexpr int C = K::C;
  if (p.F % K::FC != 0 || plan.rows != K::BM || plan.f_chunk != K::FC ||
      plan.threads != K::threads ||
      plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  auto kernel = premlp_bwd_mma_kernel<K>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  const int nb = (p.M + K::BM - 1) / K::BM, E = 3 * C + p.F;
  kernel<<<nb, K::threads, K::smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return group_sums(p.part, part2, sums, nb, E, per, s);
}

// (RW, WN, blocks an SM) by C, as premlp_bwd_plan gives them
cudaError_t dispatch_bwd(const BwdArgs& p, const BwdPlan& k, int C,
                         float* part2, float* sums, int per, cudaStream_t s) {
  switch (C) {
    case 32: return launch_bwd<BwdCfg<32, 4, 1, 4>>(p, k, part2, sums, per, s);
    case 64: return launch_bwd<BwdCfg<64, 4, 1, 4>>(p, k, part2, sums, per, s);
    case 96: return launch_bwd<BwdCfg<96, 4, 1, 4>>(p, k, part2, sums, per, s);
    case 128:
      return launch_bwd<BwdCfg<128, 8, 2, 1>>(p, k, part2, sums, per, s);
    case 192:
      return launch_bwd<BwdCfg<192, 8, 2, 1>>(p, k, part2, sums, per, s);
    case 256:
      return launch_bwd<BwdCfg<256, 4, 2, 1>>(p, k, part2, sums, per, s);
    case 384:
      return launch_bwd<BwdCfg<384, 4, 2, 1>>(p, k, part2, sums, per, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace idvs

// x, xn: (M, C) in the compute dtype; gamma, beta: (C,) float; stats:
// (M, 2) float, which receives each row's (mean, 1/std). dout, dy (M, C)
// in the compute dtype and scale (M,) float: dy = cast(scale[row] dout)
// in the same pass, or all three null.
extern "C" int idvs_premlp_ln_rows(const void* x, const void* gamma,
                                   const void* beta, void* xn, void* stats,
                                   const void* dout, const void* scale,
                                   void* dy, int M, int C, float eps,
                                   int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || C < 1 || (dout == nullptr) != (dy == nullptr) ||
      (scale == nullptr) != (dy == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* sc = static_cast<const float*>(scale);
  float2* st = static_cast<float2*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        ln_rows<float>(x, g, b, xn, st, dout, sc, dy, M, C, eps, s));
  if (dtype == kBF16)
    return static_cast<int>(ln_rows<__nv_bfloat16>(x, g, b, xn, st, dout, sc,
                                                   dy, M, C, eps, s));
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

// The fused route, bf16: x, dout, dx, xn, dy (M, C); w1 (C, F), w2 (F, C)
// in (in, out) layout, b1 (F,); hsave, g, dh (M, F); all bf16. gamma, beta
// (C,) float, or both null (then xn is null and dx = cast(dxn [+ dout])).
// res: 0 = fused_mlp, 1 = unit residual (dx adds dout), 2 = scaled (dy =
// cast(scale[row] dout), scale (M,) float, written to dy). hsave: the
// forward's cast(h) (the save_h edition) or null. activation: 0 GELU, 1
// ReLU, 2 x*sigmoid(1.702x). part: blocks * (3C + F) floats, part2:
// ceil(blocks / per) * (3C + F), sums: 3C + F floats = (db2, dgamma, dbeta,
// db1), blocks = ceil(M / rows). rows, f_chunk, threads, smem: the block
// plan (premlp_bwd_plan), which must be the one built for C; C one of 32,
// 64, 96, 128, 192, 256, 384 and F a multiple of f_chunk; operands 16-byte
// aligned.
extern "C" int idvs_premlp_bwd(
    const void* x, const void* dout, const void* scale, const void* gamma,
    const void* beta, const void* w1, const void* b1, const void* w2,
    const void* hsave, void* dx, void* xn, void* dy, void* g, void* dh,
    void* part, void* part2, void* sums, int M, int C, int F, float eps,
    int activation, int res, int per, int rows, int f_chunk, int threads,
    long long smem, int dtype, void* stream) {
  using namespace idvs;
  const bool ln = gamma != nullptr;
  if (dtype != kBF16 || M < 1 || F < 1 || per < 1 || activation < 0 ||
      activation > 2 || res < 0 || res > 2 || (beta != nullptr) != ln ||
      (xn != nullptr) != ln ||
      (res == kScaled) != (scale != nullptr && dy != nullptr) ||
      !x || !dout || !w1 || !b1 || !w2 || !dx || !g || !dh || !part ||
      !part2 || !sums)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs p{static_cast<const bf16*>(x),
                  static_cast<const bf16*>(dout),
                  static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(b1),
                  static_cast<const bf16*>(w2),
                  static_cast<const bf16*>(hsave),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<bf16*>(dx),
                  static_cast<bf16*>(xn),
                  static_cast<bf16*>(dy),
                  static_cast<bf16*>(g),
                  static_cast<bf16*>(dh),
                  static_cast<float*>(part),
                  M,
                  F,
                  eps,
                  activation,
                  res};
  const BwdPlan plan{rows, f_chunk, threads, smem};
  return static_cast<int>(dispatch_bwd(p, plan, C, static_cast<float*>(part2),
                                       static_cast<float*>(sums), per,
                                       static_cast<cudaStream_t>(stream)));
}

// The bf16 tensor-core chains of the port's FFN and projection kernels,
// shared by premlp.cu (the pre-LN MLP, premlp_mma_kernel), mlp_resln.cu
// (the post-LN FFN tail, mlp_resln_mma_kernel) and proj_resln.cu (the
// post-LN projection tail, proj_resln_mma_kernel): a block's rows of x in a
// bf16 [BM][C + 8] tile in shared memory, then over F in chunks of FC
// columns
//   h   = x @ W1[:, chunk]             mma.sync m16n8k16, float accumulators
//   g   = cast(act(h + b1))            once an element, act a constant
//   acc += g @ W2[chunk, :]            the block's (BM, C) output, registers
// with W1's [32][FC] slices and W2's [32][C] slices streamed through one
// ring of S cp.async stages in the order the products take them (the next
// chunk's W1 slices are in flight during this chunk's dense2). Warp
// (rw, wn) of RW x WN owns 16 rows: FC / WN columns of h and C / WN
// columns of acc. With WN = 1, g is packed from the dense1 accumulators
// straight into dense2's A fragments (mma.cuh), so it never leaves
// registers; with WN > 1 the cast chunk goes through a bf16 [BM][FC + 8]
// tile. The projection's chain (ProjChain) is the dense2 step alone with
// A taken from the x tile: acc += x @ W, W's [32][C] slices through the
// same ring. The caller's kernel owns the prologue (LayerNorm or none) and
// the epilogue on acc; the post-LN one (b, dropout, residual, cast, y_pre,
// LayerNorm, one store) is post_ln_epilogue below. premlp.cu's header has
// the measurements behind the layouts.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace idvs {
namespace {

enum Act { kGelu = 0, kRelu = 1, kQuickGelu = 2 };

__device__ __forceinline__ float act(float h, int a) {
  if (a == kRelu) return fmaxf(h, 0.f);
  if (a == kQuickGelu) return h / (1.f + expf(-1.702f * h));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// act(h) and act'(h) of one pre-activation, act a compile-time constant.
// ReLU and quick_gelu as act above and gemm.cu's dact; GELU's erf
// as the TPU kernel's _erf (Abramowitz-Stegun 7.1.26, |error| <= 5.3e-7,
// idvs/morec_tpu/ops/pallas/mlp.py:46-57), built from the exp(-h^2 / 2)
// that act' needs anyway: one fast exponential and one fast division an
// element, cheaper than erff and expf and measured faster at every Swin-T
// stage. g may then differ from the forward's cast(act(h)) (erff) in a
// rare rounding.
template <int A>
__device__ __forceinline__ void act_dact(float h, float& a, float& d) {
  if constexpr (A == kRelu) {
    a = fmaxf(h, 0.f);
    d = h > 0.f ? 1.f : 0.f;
  } else if constexpr (A == kQuickGelu) {
    const float e = expf(-1.702f * h);
    const float s = 1.f / (1.f + e);
    a = h / (1.f + e);
    d = s + h * 1.702f * s * (1.f - s);
  } else {
    const float t =
        __fdividef(1.f, 1.f + 0.3275911f * 0.70710678118654752f * fabsf(h));
    const float e = __expf(-0.5f * h * h);
    const float poly =
        t * (0.254829592f +
             t * (-0.284496736f +
                  t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    const float erf = copysignf(1.f - poly * e, h);
    a = 0.5f * h * (1.f + erf);
    d = 0.5f * (1.f + erf) + h * 0.39894228040143268f * e;
  }
}

using bf16 = __nv_bfloat16;

constexpr int kSlice = 32;   // rows of a weight slice: two 16-deep k-steps

// C columns, F chunks of FC, RW x WN warps, S stages of the weight ring;
// `extra`: bytes of shared memory the kernel adds after the chain's
template <int C_, int FC_, int RW_, int WN_, int S_, size_t extra = 0>
struct MmaCfg {
  static constexpr int C = C_, FC = FC_, RW = RW_, WN = WN_, S = S_;
  static constexpr int BM = 16 * RW, threads = 32 * RW * WN;
  static constexpr int ldx = C + 8, ldh = FC + 8;   // Xs and Hs rows
  static constexpr int ld1 = FC + 8, ld2 = C + 8;   // W1 and W2 slices
  static constexpr int slot = kSlice * (ld1 > ld2 ? ld1 : ld2);
  static constexpr int NJ1 = FC / WN / 8, NJ2 = C / WN / 8;   // n8 tiles
  static constexpr int n1 = C / kSlice, n2 = FC / kSlice;     // slices
  static constexpr size_t chain_smem =
      sizeof(bf16) * (BM * ldx + S * slot + (WN > 1 ? BM * ldh : 0));
  static constexpr size_t smem = chain_smem + extra;
  static_assert(C % kSlice == 0 && FC % kSlice == 0, "whole slices");
  static_assert(NJ1 % 2 == 0 && NJ2 % 2 == 0, "pairs of n8 tiles");
  static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
};

__device__ __forceinline__ float2 pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The chain of one block: its shared memory is Xs [BM][ldx], then the
// ring's S slots, then Hs [BM][ldh] when WN > 1.
template <typename K>
struct MlpChain {
  const bf16* w1;
  const bf16* b1;
  const bf16* w2;
  bf16* hsave;        // (M, F): cast(h + b1) for the backward, or null
  bf16* Xs;
  bf16* Ws;
  bf16* Hs;
  int M, F, row0, total, t;

  __device__ MlpChain(unsigned char* smem, const bf16* w1_, const bf16* b1_,
                      const bf16* w2_, bf16* hsave_, int M_, int F_)
      : w1(w1_), b1(b1_), w2(w2_), hsave(hsave_),
        Xs(reinterpret_cast<bf16*>(smem)), Ws(Xs + K::BM * K::ldx),
        Hs(Ws + K::S * K::slot), M(M_), F(F_),
        row0(blockIdx.x * K::BM),
        total(F_ / K::FC * (K::n1 + K::n2)), t(0) {}

  // slice u of the sequence into slot u % S: W1 rows [32 r, 32 r + 32) and
  // the chunk's FC columns, or W2's 32 rows r - n1 of the chunk, all C
  __device__ void issue(int u) const {
    constexpr int per = K::n1 + K::n2;
    if (u >= total) return;
    const int f0 = u / per * K::FC, r = u % per;
    bf16* dst = Ws + (u % K::S) * K::slot;
    if (r < K::n1) {
      constexpr int cpr = K::FC / 8;
      for (int c = threadIdx.x; c < kSlice * cpr; c += K::threads) {
        const int k = c / cpr, n = c % cpr * 8;
        cp_async16(dst + k * K::ld1 + n,
                   w1 + static_cast<size_t>(kSlice * r + k) * F + f0 + n);
      }
    } else {
      constexpr int cpr = K::C / 8;
      const int k0 = f0 + kSlice * (r - K::n1);
      for (int c = threadIdx.x; c < kSlice * cpr; c += K::threads) {
        const int k = c / cpr, n = c % cpr * 8;
        cp_async16(dst + k * K::ld2 + n,
                   w2 + static_cast<size_t>(k0 + k) * K::C + n);
      }
    }
  }

  // the block's rows of x into Xs (zeros past M), then the first S - 1
  // slices, each its own commit group (x's rows the first)
  __device__ void start(const bf16* x) const {
    for (int c = threadIdx.x; c < K::BM * (K::C / 8); c += K::threads) {
      const int r = c / (K::C / 8), k = c % (K::C / 8) * 8, row = row0 + r;
      cp_async16_zfill(Xs + r * K::ldx + k,
                       row < M ? x + static_cast<size_t>(row) * K::C + k : x,
                       row < M ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < K::S - 1; ++u) {
      issue(u);
      cp_async_commit();
    }
  }

  // the next slice of the ring: it has landed, every warp is done with
  // the slot the slice S - 1 ahead takes (and with Xs and Hs writes
  // before this point)
  __device__ const bf16* next() {
    cp_async_wait<K::S - 2>();
    __syncthreads();
    issue(t + K::S - 1);
    cp_async_commit();
    return Ws + (t++ % K::S) * K::slot;
  }

  // acc += cast(act(Xs @ W1 + b1)) @ W2 over all of F; Xs is ready
  __device__ void run(int act_code, float (&acc)[K::NJ2][4]) {
    constexpr int C = K::C, FC = K::FC, WN = K::WN;
    constexpr int NJ1 = K::NJ1, NJ2 = K::NJ2, n1 = K::n1, n2 = K::n2;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rw = warp / WN, wn = warp % WN, g = lane >> 2, q = lane & 3;
    const int hcol = wn * (FC / WN), ocol = wn * (C / WN);
    const bf16* xa = Xs + (16 * rw + a_row(lane)) * K::ldx + a_col(lane);
    for (int f0 = 0; f0 < F; f0 += FC) {
      // dense1: h = x @ W1[:, f0 + hcol ...] for the warp's 16 rows
      float h[NJ1][4] = {};
      for (int r = 0; r < n1; ++r) {
        const bf16* ws = next();
#pragma unroll
        for (int kk = 0; kk < kSlice; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, smem_u32(xa + kSlice * r + kk));
#pragma unroll
          for (int j = 0; j < NJ1; j += 2) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_u32(ws + (kk + bk_row(lane)) * K::ld1 + hcol +
                                  8 * j + bk_col(lane)));
            mma_bf16(h[j], a, b[0], b[1]);
            mma_bf16(h[j + 1], a, b[2], b[3]);
          }
        }
      }
      // g = cast(act(h + b1)), once an element: as dense2's A fragments
      // (k-step kb: n8 tiles 2 kb and 2 kb + 1, rows g and g + 8) or into
      // Hs (the activation a compile-time constant: a runtime one costs
      // the per-element code its branches and registers)
      uint32_t ah[WN == 1 ? FC / 16 : 1][4];
      auto cast_act = [&](auto a) {
        constexpr int A = decltype(a)::value;
#pragma unroll
        for (int j = 0; j < NJ1; ++j) {
          const int col = hcol + 8 * j + 2 * q;
          const float2 bb = pair_f32(b1 + f0 + col);
          const float v[4] = {h[j][0] + bb.x, h[j][1] + bb.y, h[j][2] + bb.x,
                              h[j][3] + bb.y};
          if (hsave != nullptr) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = row0 + 16 * rw + g + 8 * hh;
              if (row < M)
                store_pair(hsave + static_cast<size_t>(row) * F + f0 + col,
                           v[2 * hh], v[2 * hh + 1]);
            }
          }
          const uint32_t lo = pack_bf16(act(v[0], A), act(v[1], A));
          const uint32_t hi = pack_bf16(act(v[2], A), act(v[3], A));
          if constexpr (WN == 1) {
            ah[j / 2][(j & 1) * 2] = lo;
            ah[j / 2][(j & 1) * 2 + 1] = hi;
          } else {
            bf16* hs = Hs + (16 * rw + g) * K::ldh + col;
            *reinterpret_cast<uint32_t*>(hs) = lo;
            *reinterpret_cast<uint32_t*>(hs + 8 * K::ldh) = hi;
          }
        }
      };
      if (act_code == kRelu)
        cast_act(std::integral_constant<int, kRelu>());
      else if (act_code == kQuickGelu)
        cast_act(std::integral_constant<int, kQuickGelu>());
      else
        cast_act(std::integral_constant<int, kGelu>());
      // dense2: acc += g @ W2[f0 ..., ocol ...]; with WN > 1 the first
      // slice's barrier orders the Hs writes above before the reads below,
      // and the next chunk's dense1 barriers order these reads before its
      // writes
#pragma unroll
      for (int r2 = 0; r2 < n2; ++r2) {
        const bf16* ws = next();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          if constexpr (WN == 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = ah[2 * r2 + kk][i];
          } else {
            ldsm_x4(a, smem_u32(Hs + (16 * rw + a_row(lane)) * K::ldh +
                                kSlice * r2 + 16 * kk + a_col(lane)));
          }
#pragma unroll
          for (int j = 0; j < NJ2; j += 2) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_u32(ws + (16 * kk + bk_row(lane)) * K::ld2 +
                                  ocol + 8 * j + bk_col(lane)));
            mma_bf16(acc[j], a, b[0], b[1]);
            mma_bf16(acc[j + 1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
};

// The projection's chain at width C, RW x WN warps, S ring stages: Xs
// [BM][ldx], the ring's S slots of [32][C + 8], then the epilogue's
// [2][WN][BM] float row sums.
template <int C_, int RW_, int WN_, int S_>
struct ProjCfg {
  static constexpr int C = C_, RW = RW_, WN = WN_, S = S_;
  static constexpr int BM = 16 * RW, threads = 32 * RW * WN;
  static constexpr int ldx = C + 8, ld2 = C + 8, slot = kSlice * ld2;
  static constexpr int NJ2 = C / WN / 8, n = C / kSlice;
  static constexpr size_t chain_smem = sizeof(bf16) * (BM * ldx + S * slot);
  static constexpr size_t smem = chain_smem + sizeof(float) * 2 * WN * BM;
  static_assert(C % kSlice == 0 && NJ2 % 2 == 0, "whole slices and pairs");
  static_assert(smem <= kMaxSmem, "tile does not fit in shared memory");
};

// acc += Xs @ W for a block's BM rows: W's n slices of [32][C] through
// the ring, each warp's 16 rows times its C / WN columns. Its ring and its
// loop mirror MlpChain's x copy, next() and dense2 step: moved into helpers
// both chains called, they cost mlp_resln_mma_kernel 4-5 % of its device
// time at the text shape (PERF.md), so each chain keeps its own.
template <typename K>
struct ProjChain {
  const bf16* w;
  bf16* Xs;
  bf16* Ws;
  int M, row0, t;

  __device__ ProjChain(unsigned char* smem, const bf16* w_, int M_)
      : w(w_), Xs(reinterpret_cast<bf16*>(smem)), Ws(Xs + K::BM * K::ldx),
        M(M_), row0(blockIdx.x * K::BM), t(0) {}

  // W rows [32 u, 32 u + 32) into slot u % S
  __device__ void issue(int u) const {
    if (u >= K::n) return;
    constexpr int cpr = K::C / 8;
    bf16* dst = Ws + (u % K::S) * K::slot;
    for (int c = threadIdx.x; c < kSlice * cpr; c += K::threads) {
      const int k = c / cpr, col = c % cpr * 8;
      cp_async16(dst + k * K::ld2 + col,
                 w + static_cast<size_t>(kSlice * u + k) * K::C + col);
    }
  }

  // the block's rows of x (zeros past M), then the first S - 1 slices,
  // each a group
  __device__ void start(const bf16* x) const {
    for (int c = threadIdx.x; c < K::BM * (K::C / 8); c += K::threads) {
      const int r = c / (K::C / 8), k = c % (K::C / 8) * 8, row = row0 + r;
      cp_async16_zfill(Xs + r * K::ldx + k,
                       row < M ? x + static_cast<size_t>(row) * K::C + k : x,
                       row < M ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < K::S - 1; ++u) {
      issue(u);
      cp_async_commit();
    }
  }

  // the next slice of the ring, as MlpChain::next
  __device__ const bf16* next() {
    cp_async_wait<K::S - 2>();
    __syncthreads();
    issue(t + K::S - 1);
    cp_async_commit();
    return Ws + (t++ % K::S) * K::slot;
  }

  // MlpChain's dense2 step with A from the x tile
  __device__ void run(float (&acc)[K::NJ2][4]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rw = warp / K::WN, ocol = warp % K::WN * (K::C / K::WN);
    const bf16* xa = Xs + (16 * rw + a_row(lane)) * K::ldx + a_col(lane);
    for (int r = 0; r < K::n; ++r) {
      const bf16* ws = next();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(xa + kSlice * r + 16 * kk));
#pragma unroll
        for (int j = 0; j < K::NJ2; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(ws + (16 * kk + bk_row(lane)) * K::ld2 +
                                ocol + 8 * j + bk_col(lane)));
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    cp_async_wait<0>();
  }
};

// The post-LN epilogue on a block's (BM, C) float accumulators (warp
// (rw, wn): 16 rows, the C / WN columns from wn * C / WN, mma.cuh's C
// layout): y_pre = cast(dropout(acc + b) + resid) in place, the dropout at
// element row * C + col, stored to ypre when it is given (the training
// edition); the row sums by quad shuffles and, across the WN column warps,
// through red ([2][WN][BM] floats) in a fixed order; then out = LN(y_pre)
// (float gamma and beta, the fast variance clamped at 0, flax) and one
// store. resid(r, row, col) is the float pair of the residual at the
// block's row r (device row `row`), columns col and col + 1. Rows past M
// are never stored.
template <typename K, typename Resid>
__device__ __forceinline__ void post_ln_epilogue(
    float (&acc)[K::NJ2][4], const bf16* b, Resid resid, const float* gamma,
    const float* beta, bf16* out, bf16* ypre, Drop drop, int row0, int M,
    float eps, float* red) {
  constexpr int C = K::C, BM = K::BM, WN = K::WN, NJ2 = K::NJ2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / WN, wn = warp % WN, g = lane >> 2, q = lane & 3;
  const int ocol = wn * (C / WN);
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * rw + g + 8 * hh, row = row0 + r;
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = ocol + 8 * j + 2 * q;
      const float2 bb = pair_f32(b + col), xv = resid(r, row, col);
      const uint32_t index = static_cast<uint32_t>(row) * C + col;
      const float y0 = round_to<bf16>(
          drop.apply(acc[j][2 * hh] + bb.x, index) + xv.x);
      const float y1 = round_to<bf16>(
          drop.apply(acc[j][2 * hh + 1] + bb.y, index + 1) + xv.y);
      acc[j][2 * hh] = y0;
      acc[j][2 * hh + 1] = y1;
      sum[hh] += y0 + y1;
      sq[hh] += y0 * y0 + y1 * y1;
      if (ypre != nullptr && row < M)
        store_pair(ypre + static_cast<size_t>(row) * C + col, y0, y1);
    }
  }
  // a row's C columns: 2 NJ2 a lane, the quad's four lanes, the WN warps
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum[hh] += __shfl_xor_sync(~0u, sum[hh], o);
      sq[hh] += __shfl_xor_sync(~0u, sq[hh], o);
    }
  if constexpr (WN > 1) {
    if (q == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * rw + g + 8 * hh;
        red[wn * BM + r] = sum[hh];
        red[(WN + wn) * BM + r] = sq[hh];
      }
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * rw + g + 8 * hh;
      sum[hh] = sq[hh] = 0.f;
#pragma unroll
      for (int c = 0; c < WN; ++c) {
        sum[hh] += red[c * BM + r];
        sq[hh] += red[(WN + c) * BM + r];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * rw + g + 8 * hh;
    if (row >= M) continue;
    const float mu = sum[hh] / C;
    const float var = fmaxf(sq[hh] / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    bf16* orow = out + static_cast<size_t>(row) * C;
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = ocol + 8 * j + 2 * q;
      store_pair(orow + col,
                 (acc[j][2 * hh] - mu) * rstd * gamma[col] + beta[col],
                 (acc[j][2 * hh + 1] - mu) * rstd * gamma[col + 1] +
                     beta[col + 1]);
    }
  }
}

}  // namespace
}  // namespace idvs

// The pre-LN MLP sub-block (Swin; CLIP/MAE/OPT with other activations),
// forward:
//   xn  = cast(LN_f32(x; gamma, beta, eps))      (or x when there is no LN)
//   h   = f32(xn @ W1) + b1
//   g   = cast(act_f32(h))          act: exact GELU, ReLU or x*sigmoid(1.702x)
//   y   = f32(g @ W2) + b2
//   out = cast(y)                   fused_mlp
//       | cast(x + y)               fused_mlp_res, unit edition
//       | cast(x + s[row] * y)      fused_mlp_res with a per-row float scale
//
// Replaces idvs/morec_tpu/ops/pallas/mlp.py _fwd_kernel (reached through
// fused_mlp and, with res=True, fused_mlp_res), its save_h edition included:
// given a buffer, the kernel also stores cast(h) for the backward
// (premlp_bwd.cu), which otherwise recomputes it. GELU uses CUDA's erff; the
// Pallas kernel's polynomial erf was a Mosaic workaround.
//
// Bound on the H100: 4*C*F flops a row against 2*C elements of traffic, so
// at F = 4C it is bound by operations at every Swin width (236.8 GFLOP a
// Swin-T stage for 512 images: 0.239 ms at the 989 TFLOP/s bf16 rate, 1.44
// ms at 3xTF32's 165). The (M, F) intermediate is 4x the size of x and
// never leaves the block. Two bodies, chosen by the compute dtype, both on
// the tensor cores.
//
// bf16 (premlp_mma_kernel), on the tensor cores, its chain in mlp_mma.cuh
// (shared with mlp_resln.cu's post-LN tail): a block of RW x WN warps owns
// BM = 16 RW rows. Its rows of x come first, by cp.async, into a bf16
// [BM][C + 8] tile in shared memory (16 bytes more a row, so ldmatrix rows
// fall on distinct banks), where the LayerNorm runs in place, eight lanes a
// row. F is walked in chunks of FC columns; W1's [32][FC] slices and W2's
// [32][C] slices stream through one ring of kStages cp.async stages, in the
// order the products take them, so the next chunk's W1 slices are in
// flight during this chunk's dense2. dense1 is mma.sync m16n8k16 bf16 with
// float accumulators (mma.cuh): warp (rw, wn) computes h for its 16 rows
// and FC / WN columns of the chunk; bias, activation (erff once an element,
// the activation a compile-time constant) and the cast run on those
// accumulators, which with WN = 1 are packed to bf16 pairs as the A operand
// of dense2 (mma.cuh), so h never leaves registers (fused_mha.cu's P . V);
// with WN > 1 the warps of a row group each hold a part of the chunk's
// columns, so the cast chunk goes through a bf16 [BM][FC + 8] tile in
// shared memory. dense2 accumulates the block's (BM, C) output in
// registers, warp (rw, wn) owning C / WN columns; the residual and the
// per-row scale run on those accumulators before the one store. The plan
// (premlp_plan in ops/cuda/mlp.py, the one place it is decided; the launch
// checks it against the instantiation): at most 96 accumulator floats a
// thread; 8 warps with WN = 1 and BM = 128 up to C = 128, WN = 2 and BM =
// 64 at C = 192 and 256; from C = 384 on 16 warps (one block an SM), WN =
// 4 and BM = 64, or WN = 8 and BM = 32 at C = 768 and 1024. Each block
// streams all of W1 and W2 from L2 for its BM rows: 7.4 GB at Swin-T stage
// 3 for 512 images, which bounds that stage (the (BM, C) accumulator of a
// larger BM does not fit the registers). A first version with the
// activation as a runtime switch, one warp a row in the LayerNorm and one
// column warp at C = 192 took 2.74 ms at stage 0 against 1.97 (bench_swin,
// PERF.md); more ring stages, narrower chunks and the other warp layouts
// tried gained nothing.
//
// float32 (premlp_tf32_kernel), on the tensor cores as 3xTF32 (mma.sync
// m16n8k8 tf32, 495 TFLOP/s, 165 for three products): each operand value
// is split into big = tf32_rna(v) and small = v - big, and small.big +
// big.small + big.big of each slice (8 or 16 deep) goes into zeroed sums
// that float adds take to the running sums (mma.cuh tf32_slice; gemm.cu's
// header has why). The scalar body it replaces ran the products on the FMA
// units at 30 TFLOP/s (4.90 ms at OPT-125M's encode chunk, PERF.md), below
// cuBLAS's float32 SGEMM on the same products. Same chain as bf16 with
// float tiles: a block of 8 warps, RW x WN, owns BM rows; its rows of x
// come by cp.async into a float [BM][C + 8] tile (8 mod 32 floats a row:
// a fragment's float2 reads hit distinct banks), normalised in place; F
// is walked in chunks of FC columns, W1's [K1][FC] and W2's [K2][C] slices
// streaming raw through one ring of S stages of one size ([k][n + 4] rows,
// 4 mod 16: the B reads, rows 2q and 2q + 1 of a k-step, hit distinct
// banks). Each warp owns MT = 2 m16 tiles of rows (32 rows): every weight
// value it splits feeds two tiles' products, and every x value it splits
// the NJ n8 tiles of its columns, so each operand is split once a warp,
// not once a product (a float32 body that splits at every product is
// bound by issued instructions, PERF.md); x's values are split by every
// column warp, so the plan takes chunks as wide as the registers allow.
// The split is three operations: small is left unrounded, the tensor cores
// reading its upper 19 bits (mma.cuh split_tf32_fast). dense1's h (FC / WN
// columns a warp), b1 and the activation (erff, a compile-time constant)
// go to a float [BM][FC + 8] tile (and, for save_h, h + b1 to the float
// buffer), which dense2 reads as its A operand; dense2 accumulates the
// block's (BM, C) output in registers, C / WN columns a warp; the residual
// and the per-row scale run on those accumulators before the one store.
// The plan (premlp_plan(C, float32), checked at the launch) keeps at most
// 128 output floats and 48 h floats a thread, one block an SM: 128 rows a
// block up to C = 192, 64 at 256 and 384, 32 from 512 on, where the xn
// tile is half of the shared memory (at C = 768 W2's slices 8 deep and
// W1's 16, so that both fit one slot of three; at 1024 two stages of
// 8-deep slices). Each F chunk divides the one the scalar body took, so
// every F it took is still taken. At 32 rows a block each block streams
// all of W1 and W2 from L2 (9.1 GB at OPT's chunk, M = 15360): a larger
// row tile's (BM, C) float accumulator does not fit the registers.
#include <type_traits>

#include "mlp_mma.cuh"

namespace idvs {
namespace {

enum Res { kNoRes = 0, kUnit = 1, kScaled = 2 };

struct MlpArgs {
  const void *x, *w1, *b1, *w2, *b2;
  const float *gamma, *beta;   // null: no LayerNorm
  const float* scale;          // (M,) for kScaled
  void* out;
  void* hsave;                 // (M, F) compute dtype, or null
  int M, F;
  float eps;
  int act, res;
};

// The block plan the launch passes (premlp_plan in ops/cuda/mlp.py): rows a
// block, F chunk, threads and shared-memory bytes.
struct Plan {
  int rows, f_chunk, threads;
  long long smem;
};

// ---- float32: 3xTF32 on the tensor cores -----------------------------------

// C columns, F chunks of FC, RW x WN warps each owning MT m16 tiles of rows,
// W1 slices K1 deep and W2 slices K2 deep through a ring of S cp.async
// stages of one size
template <int C_, int FC_, int RW_, int WN_, int MT_, int K1_, int K2_,
          int S_>
struct Tf32Cfg {
  static constexpr int C = C_, FC = FC_, RW = RW_, WN = WN_, MT = MT_;
  static constexpr int K1 = K1_, K2 = K2_, S = S_;
  static constexpr int BM = 16 * MT * RW, threads = 32 * RW * WN;
  static constexpr int ldx = C + 8, ldh = FC + 8;   // Xs and Hs rows
  static constexpr int ld1 = FC + 4, ld2 = C + 4;   // W1 and W2 slices
  static constexpr int slot = K1 * ld1 > K2 * ld2 ? K1 * ld1 : K2 * ld2;
  static constexpr int NJ1 = FC / WN / 8, NJ2 = C / WN / 8;   // n8 tiles
  static constexpr int n1 = C / K1, n2 = FC / K2;             // slices
  static constexpr size_t smem =
      sizeof(float) * (BM * ldx + BM * ldh + S * slot);
  static_assert(K1 % 8 == 0 && K2 % 8 == 0 && C % K1 == 0 && FC % K2 == 0,
                "slices of whole k-steps");
  static_assert(FC % (8 * WN) == 0 && C % (8 * WN) == 0, "whole n8 tiles");
  static_assert(S >= 2 && smem <= kMaxSmem,
                "tile does not fit in shared memory");
};

template <typename K>
__global__ void __launch_bounds__(K::threads, 1)
    premlp_tf32_kernel(MlpArgs p) {
  constexpr int C = K::C, FC = K::FC, BM = K::BM, MT = K::MT, S = K::S;
  constexpr int K1 = K::K1, K2 = K::K2, NJ1 = K::NJ1, NJ2 = K::NJ2;
  constexpr int n1 = K::n1, n2 = K::n2, per = n1 + n2;
  extern __shared__ __align__(16) unsigned char premlp_f32_smem[];
  float* Xs = reinterpret_cast<float*>(premlp_f32_smem);   // [BM][ldx]
  float* Hs = Xs + BM * K::ldx;                            // [BM][ldh]
  float* Ws = Hs + BM * K::ldh;                            // S slots
  const float* x = static_cast<const float*>(p.x);
  const float* w1 = static_cast<const float*>(p.w1);
  const float* b1 = static_cast<const float*>(p.b1);
  const float* w2 = static_cast<const float*>(p.w2);
  const float* b2 = static_cast<const float*>(p.b2);
  float* out = static_cast<float*>(p.out);
  float* hsave = static_cast<float*>(p.hsave);
  const int M = p.M, F = p.F, row0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / K::WN, wn = warp % K::WN, g = lane >> 2, q = lane & 3;
  const int wrow = 16 * MT * rw;   // the warp's first row of the block
  const int hcol = wn * (FC / K::WN), ocol = wn * (C / K::WN);
  const int total = F / FC * per;

  // slice u of the sequence into slot u % S: W1 rows [K1 r, K1 r + K1) and
  // the chunk's FC columns, or W2's K2 rows r - n1 of the chunk, all C
  auto issue = [&](int u) {
    if (u >= total) return;
    const int f0 = u / per * FC, r = u % per;
    float* dst = Ws + (u % S) * K::slot;
    if (r < n1) {
      constexpr int cpr = FC / 4;
      for (int c = threadIdx.x; c < K1 * cpr; c += K::threads) {
        const int k = c / cpr, n = c % cpr * 4;
        cp_async16(dst + k * K::ld1 + n,
                   w1 + static_cast<size_t>(K1 * r + k) * F + f0 + n);
      }
    } else {
      constexpr int cpr = C / 4;
      const int k0 = f0 + K2 * (r - n1);
      for (int c = threadIdx.x; c < K2 * cpr; c += K::threads) {
        const int k = c / cpr, n = c % cpr * 4;
        cp_async16(dst + k * K::ld2 + n,
                   w2 + static_cast<size_t>(k0 + k) * C + n);
      }
    }
  };
  // the block's rows of x (zeros past M), then the first S - 1 slices, each
  // its own commit group (x's rows the first)
  for (int c = threadIdx.x; c < BM * (C / 4); c += K::threads) {
    const int r = c / (C / 4), k = c % (C / 4) * 4, row = row0 + r;
    cp_async16_zfill(Xs + r * K::ldx + k,
                     row < M ? x + static_cast<size_t>(row) * C + k : x,
                     row < M ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < S - 1; ++u) {
    issue(u);
    cp_async_commit();
  }
  // the next slice of the ring: it has landed, and every warp is done with
  // the slot the slice S - 1 ahead takes (and with the Xs and Hs writes
  // before this point)
  int t = 0;
  auto next = [&]() -> const float* {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue(t + S - 1);
    cp_async_commit();
    return Ws + (t++ % S) * K::slot;
  };

  // prologue in place, while the first slices land: eight lanes a row, four
  // rows a warp at a time, float statistics with the fast variance E[x^2] -
  // E[x]^2 clamped at 0 (flax nn.LayerNorm); rows past M stay zeros
  cp_async_wait<S - 1>();
  __syncthreads();
  if (p.gamma != nullptr) {
    const int sub = lane >> 3, sl = lane & 7;
    for (int r = 4 * warp + sub; r < BM; r += K::threads / 8) {
      float* xs = Xs + r * K::ldx;
      float sum = 0.f, sq = 0.f;
#pragma unroll 4
      for (int k = 4 * sl; k < C; k += 32) {
        const float4 v = *reinterpret_cast<const float4*>(xs + k);
        sum += (v.x + v.y) + (v.z + v.w);
        sq += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(~0u, sum, o);
        sq += __shfl_xor_sync(~0u, sq, o);
      }
      if (row0 + r >= M) continue;
      const float mu = sum / C;
      const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + p.eps);
#pragma unroll 4
      for (int k = 4 * sl; k < C; k += 32) {
        float4 v = *reinterpret_cast<const float4*>(xs + k);
        v.x = (v.x - mu) * rstd * p.gamma[k] + p.beta[k];
        v.y = (v.y - mu) * rstd * p.gamma[k + 1] + p.beta[k + 1];
        v.z = (v.z - mu) * rstd * p.gamma[k + 2] + p.beta[k + 2];
        v.w = (v.w - mu) * rstd * p.gamma[k + 3] + p.beta[k + 3];
        *reinterpret_cast<float4*>(xs + k) = v;
      }
    }
  }

  float acc[MT][NJ2][4] = {};
  for (int f0 = 0; f0 < F; f0 += FC) {
    // dense1: h = xn @ W1[:, f0 + hcol ...] for the warp's MT row tiles
    float h[MT][NJ1][4] = {};
    for (int r = 0; r < n1; ++r) {
      const float* ws = next();
      tf32_slice<MT, NJ1, K1 / 8>(h, Xs + wrow * K::ldx + K1 * r, K::ldx,
                                  ws + hcol, K::ld1);
    }
    // h + b1 (stored for the backward), act once an element into Hs (the
    // activation a compile-time constant); the previous chunk's reads of
    // Hs ended before this chunk's first slice's barrier
    auto act_store = [&](auto a) {
      constexpr int A = decltype(a)::value;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ1; ++j) {
          const int col = hcol + 8 * j + 2 * q;
          const float2 bb = *reinterpret_cast<const float2*>(b1 + f0 + col);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = wrow + 16 * i + g + 8 * hh;
            const float v0 = h[i][j][2 * hh] + bb.x;
            const float v1 = h[i][j][2 * hh + 1] + bb.y;
            if (hsave != nullptr && row0 + r < M)
              *reinterpret_cast<float2*>(
                  hsave + static_cast<size_t>(row0 + r) * F + f0 + col) =
                  make_float2(v0, v1);
            *reinterpret_cast<float2*>(Hs + r * K::ldh + col) =
                make_float2(act(v0, A), act(v1, A));
          }
        }
    };
    if (p.act == kRelu)
      act_store(std::integral_constant<int, kRelu>());
    else if (p.act == kQuickGelu)
      act_store(std::integral_constant<int, kQuickGelu>());
    else
      act_store(std::integral_constant<int, kGelu>());
    // dense2: acc += act(h) @ W2[f0 ..., ocol ...]; the first slice's
    // barrier orders the Hs writes above before these reads
    for (int r2 = 0; r2 < n2; ++r2) {
      const float* ws = next();
      tf32_slice<MT, NJ2, K2 / 8>(acc, Hs + wrow * K::ldh + K2 * r2, K::ldh,
                                  ws + ocol, K::ld2);
    }
  }
  cp_async_wait<0>();

  // y = acc + b2, the residual (and the row's scale) on it, one store
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + wrow + 16 * i + g + 8 * hh;
      if (row >= M) continue;
      const float s = p.res == kScaled ? p.scale[row] : 1.f;
      const size_t base = static_cast<size_t>(row) * C;
#pragma unroll
      for (int j = 0; j < NJ2; ++j) {
        const int col = ocol + 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
        float y0 = acc[i][j][2 * hh] + bb.x, y1 = acc[i][j][2 * hh + 1] + bb.y;
        if (p.res != kNoRes) {
          const float2 xv = *reinterpret_cast<const float2*>(x + base + col);
          y0 = xv.x + s * y0;
          y1 = xv.y + s * y1;
        }
        *reinterpret_cast<float2*>(out + base + col) = make_float2(y0, y1);
      }
    }
}

template <int C, int FC, int RW, int WN, int MT, int K1, int K2, int S>
cudaError_t launch_tf32(const MlpArgs& p, const Plan& plan, cudaStream_t s) {
  using K = Tf32Cfg<C, FC, RW, WN, MT, K1, K2, S>;
  if (p.F % FC != 0 || plan.rows != K::BM || plan.f_chunk != FC ||
      plan.threads != K::threads ||
      plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  auto kernel = premlp_tf32_kernel<K>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + K::BM - 1) / K::BM, K::threads, K::smem, s>>>(p);
  return cudaGetLastError();
}

// (FC, RW, WN, MT, W1 and W2 slice depths, stages) by C, as premlp_plan
// gives them
cudaError_t dispatch_f32(const MlpArgs& p, const Plan& k, int C,
                         cudaStream_t s) {
  switch (C) {
    case 32: return launch_tf32<32, 32, 4, 2, 2, 16, 16, 3>(p, k, s);
    case 64: return launch_tf32<64, 64, 4, 2, 2, 16, 16, 3>(p, k, s);
    case 96: return launch_tf32<96, 96, 4, 2, 2, 16, 16, 3>(p, k, s);
    case 128: return launch_tf32<128, 64, 4, 2, 2, 16, 16, 3>(p, k, s);
    case 192: return launch_tf32<192, 96, 4, 2, 2, 16, 16, 3>(p, k, s);
    case 256: return launch_tf32<256, 128, 2, 4, 2, 16, 16, 3>(p, k, s);
    case 384: return launch_tf32<384, 192, 2, 4, 2, 16, 16, 3>(p, k, s);
    case 512: return launch_tf32<512, 256, 1, 8, 2, 16, 16, 3>(p, k, s);
    case 768: return launch_tf32<768, 384, 1, 8, 2, 16, 8, 3>(p, k, s);
    case 1024: return launch_tf32<1024, 128, 1, 8, 2, 8, 8, 2>(p, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: mma.sync on the tensor cores (mlp_mma.cuh) -----------------------

template <typename K>
__global__ void __launch_bounds__(K::threads, K::threads <= 256 ? 2 : 1)
    premlp_mma_kernel(MlpArgs p) {
  constexpr int C = K::C, BM = K::BM, WN = K::WN, S = K::S, NJ2 = K::NJ2;
  extern __shared__ __align__(16) unsigned char premlp_smem[];
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* b2 = static_cast<const bf16*>(p.b2);
  bf16* out = static_cast<bf16*>(p.out);
  MlpChain<K> chain(premlp_smem, static_cast<const bf16*>(p.w1),
                    static_cast<const bf16*>(p.b1),
                    static_cast<const bf16*>(p.w2),
                    static_cast<bf16*>(p.hsave), p.M, p.F);
  bf16* Xs = chain.Xs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / WN, wn = warp % WN, g = lane >> 2, q = lane & 3;
  const int row0 = chain.row0;
  chain.start(x);

  // prologue in place, while the first slices land: eight lanes a row,
  // four rows a warp at a time, float statistics with the fast variance
  // E[x^2] - E[x]^2 clamped at 0 (flax nn.LayerNorm), the result cast;
  // rows past M stay zeros
  cp_async_wait<S - 1>();
  __syncthreads();
  if (p.gamma != nullptr) {
    const int sub = lane >> 3, sl = lane & 7;
    for (int r = 4 * warp + sub; r < BM; r += K::threads / 8) {
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
      if (row0 + r >= p.M) continue;
      const float mu = sum / C;
      const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + p.eps);
#pragma unroll 4
      for (int k = 2 * sl; k < C; k += 16) {
        const float2 v = pair_f32(xs + k);
        store_pair(xs + k, (v.x - mu) * rstd * p.gamma[k] + p.beta[k],
                   (v.y - mu) * rstd * p.gamma[k + 1] + p.beta[k + 1]);
      }
    }
  }

  float acc[NJ2][4] = {};
  chain.run(p.act, acc);

  // y = acc + b2, the residual (and the row's scale) on it, one cast
  const int ocol = wn * (C / WN);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * rw + g + 8 * hh;
    if (row >= p.M) continue;
    const float s = p.res == kScaled ? p.scale[row] : 1.f;
    const size_t base = static_cast<size_t>(row) * C;
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = ocol + 8 * j + 2 * q;
      const float2 bb = pair_f32(b2 + col);
      float y0 = acc[j][2 * hh] + bb.x, y1 = acc[j][2 * hh + 1] + bb.y;
      if (p.res != kNoRes) {
        const float2 xv = pair_f32(x + base + col);
        y0 = xv.x + s * y0;
        y1 = xv.y + s * y1;
      }
      store_pair(out + base + col, y0, y1);
    }
  }
}

template <int C, int FC, int RW, int WN, int S>
cudaError_t launch_mma(const MlpArgs& p, const Plan& plan, cudaStream_t s) {
  using K = MmaCfg<C, FC, RW, WN, S>;
  if (p.F % FC != 0 || plan.rows != K::BM || plan.f_chunk != FC ||
      plan.threads != K::threads ||
      plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  auto kernel = premlp_mma_kernel<K>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + K::BM - 1) / K::BM, K::threads, K::smem, s>>>(p);
  return cudaGetLastError();
}

// (FC, RW, WN, stages) by C, as premlp_plan gives them
cudaError_t dispatch_bf16(const MlpArgs& p, const Plan& k, int C,
                          cudaStream_t s) {
  switch (C) {
    case 32: return launch_mma<32, 32, 8, 1, 3>(p, k, s);
    case 64: return launch_mma<64, 64, 8, 1, 3>(p, k, s);
    case 96: return launch_mma<96, 96, 8, 1, 3>(p, k, s);
    case 128: return launch_mma<128, 64, 8, 1, 3>(p, k, s);
    case 192: return launch_mma<192, 96, 4, 2, 3>(p, k, s);
    case 256: return launch_mma<256, 128, 4, 2, 3>(p, k, s);
    case 384: return launch_mma<384, 192, 4, 4, 3>(p, k, s);
    case 512: return launch_mma<512, 256, 4, 4, 3>(p, k, s);
    case 768: return launch_mma<768, 384, 2, 8, 3>(p, k, s);
    case 1024: return launch_mma<1024, 256, 2, 8, 2>(p, k, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace idvs

// x, out: (M, C); w1: (C, F) and w2: (F, C) in (in, out) layout; b1: (F,),
// b2: (C,) in the compute dtype. gamma, beta: (C,) float, or both null for
// no LayerNorm. activation: 0 = exact GELU, 1 = ReLU, 2 = x*sigmoid(1.702x).
// res: 0 = out is the MLP alone, 1 = x + mlp, 2 = x + scale[row] * mlp with
// scale (M,) float. h: (M, F) in the compute dtype, which receives
// cast(xn @ w1 + b1) for the backward, or null. C must be 32, 64, 96, 128,
// 192, 256, 384, 512, 768 or 1024, F a multiple of the plan's chunk.
// rows, f_chunk, threads, smem: the block plan (premlp_plan), which must be
// the one built for C and the dtype; bf16 operands 16-byte aligned.
extern "C" int idvs_premlp_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* gamma, const void* beta,
                               const void* scale, void* out, void* h, int M,
                               int C, int F, float eps, int activation, int res,
                               int rows, int f_chunk, int threads,
                               long long smem, int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || F < 1 || activation < 0 || activation > 2 || res < 0 ||
      res > 2 || (res == kScaled && scale == nullptr) ||
      ((gamma == nullptr) != (beta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs p{x, w1, b1, w2, b2, static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<const float*>(scale), out, h, M, F, eps,
                  activation, res};
  const Plan plan{rows, f_chunk, threads, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(dispatch_f32(p, plan, C, s));
  if (dtype == kBF16) return static_cast<int>(dispatch_bf16(p, plan, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

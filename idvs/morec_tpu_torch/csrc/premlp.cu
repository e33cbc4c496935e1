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
// Swin-T stage for 512 images: 0.239 ms at the 989 TFLOP/s bf16 rate). The
// (M, F) intermediate is 4x the size of x and never leaves the block. Two
// bodies, chosen by the compute dtype.
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
// float32 (premlp_kernel): no TF32, for parity, so the products run on the
// float FMA units. The tile grid of tile.cuh fits widths that are no
// multiple of 128: a 256-thread block owns BM = 4 * (256 / TX) rows (128
// at C = 96, 32 from C = 384 on), normalises them once into a transposed
// tile in shared memory, and walks F in chunks of FC columns: dense1 into
// a 4 x 4NG1 register tile, bias, activation and cast parked transposed in
// shared memory, then folded into the block's 4 x 4NG dense2 accumulator
// (all C columns). Weight slices are double-buffered with the next
// slice's loads in flight during the FMAs; the residual and the per-row
// scale run on the accumulator before the single (M, C) store.
#include "mlp_mma.cuh"
#include "tile.cuh"

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

template <int TX, int NG, int NG1, int KB>
struct Cfg {
  static constexpr int C = 4 * TX * NG, FC = 4 * TX * NG1;
  static constexpr int TY = 256 / TX, BM = 4 * TY, lda = BM + 4;
  static constexpr size_t smem =
      sizeof(float) * ((C + FC) * lda + 2 * KB * C);
};

template <typename T, int TX, int NG, int NG1, int KB>
__global__ void __launch_bounds__(256) premlp_kernel(MlpArgs p) {
  using K = Cfg<TX, NG, NG1, KB>;
  constexpr int C = K::C, FC = K::FC, BM = K::BM, lda = K::lda;
  constexpr int kQ1 = (KB * FC / 4 + 255) / 256;
  constexpr int kQ2 = (KB * C / 4 + 255) / 256;
  extern __shared__ float4 smem4[];
  float* Xt = reinterpret_cast<float*>(smem4);   // [C][lda]   xn, transposed
  float* Ht = Xt + C * lda;                      // [FC][lda]  act(h) chunk
  float* Ws = Ht + FC * lda;                     // 2 x [KB][C] weight slices
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* b2 = static_cast<const T*>(p.b2);
  T* out = static_cast<T*>(p.out);
  T* hsave = static_cast<T*>(p.hsave);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, F = p.F;

  // prologue: one warp a row; float statistics with the fast variance
  // E[x^2] - E[x]^2 clamped at 0 (flax nn.LayerNorm), the result cast
  for (int r = warp; r < BM; r += 8) {
    const int row = row0 + r;
    if (row >= p.M) {
      for (int k = lane; k < C; k += 32) Xt[k * lda + r] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(row) * C;
    if (p.gamma == nullptr) {
      for (int k = lane; k < C; k += 32) Xt[k * lda + r] = to_f32(xr[k]);
      continue;
    }
    float sum = 0.f, sq = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float v = to_f32(xr[k]);
      sum += v;
      sq += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(~0u, sum, o);
      sq += __shfl_xor_sync(~0u, sq, o);
    }
    const float mu = sum / C;
    const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + p.eps);
    for (int k = lane; k < C; k += 32)
      Xt[k * lda + r] = round_to<T>((to_f32(xr[k]) - mu) * rstd * p.gamma[k] +
                                    p.beta[k]);
  }

  float acc[4][4 * NG] = {};
  tile::WSlice<T, KB, kQ1> s1;
  tile::WSlice<T, KB, kQ2> s2;
  s1.init(F, FC, FC, 0, 0);
  s2.init(C, C, C, 0, 0);
  int buf = 0;   // the weight-slice buffer alternates across both products
  for (int f0 = 0; f0 < F; f0 += FC) {
    // dense1: h = xn @ W1[:, f0:f0+FC]
    float h[4][4 * NG1] = {};
    s1.load(w1 + f0, F, 0);
    for (int t = 0; t < C / KB; ++t) {
      float* ws = Ws + buf * KB * C;
      buf ^= 1;
      s1.store(ws);
      __syncthreads();
      if (t + 1 < C / KB) s1.load(w1 + f0, F, (t + 1) * KB);
      tile::fma_tile<NG1, KB>(h, Xt + t * KB * lda, lda, ws, FC, 4 * ty,
                              4 * tx, 4 * TX);
    }
    // cast(act(h + b1)) into the chunk buffer; the previous chunk's reads
    // of Ht ended before the first barrier of the loop above
#pragma unroll
    for (int j = 0; j < NG1; ++j) {
      const int col = 4 * tx + 4 * TX * j;
      const float4 bv = tile::load4(b1 + f0 + col);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      if (hsave != nullptr) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + 4 * ty + r;
          if (row < p.M)
            tile::store4(hsave + static_cast<size_t>(row) * F + f0 + col,
                         make_float4(h[r][4 * j + 0] + bb[0],
                                     h[r][4 * j + 1] + bb[1],
                                     h[r][4 * j + 2] + bb[2],
                                     h[r][4 * j + 3] + bb[3]));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(Ht + (col + c) * lda + 4 * ty) =
            make_float4(round_to<T>(act(h[0][4 * j + c] + bb[c], p.act)),
                        round_to<T>(act(h[1][4 * j + c] + bb[c], p.act)),
                        round_to<T>(act(h[2][4 * j + c] + bb[c], p.act)),
                        round_to<T>(act(h[3][4 * j + c] + bb[c], p.act)));
    }
    // dense2: acc += g @ W2[f0:f0+FC, :]
    const T* w2f = w2 + static_cast<size_t>(f0) * C;
    s2.load(w2f, C, 0);
    for (int t = 0; t < FC / KB; ++t) {
      float* ws = Ws + buf * KB * C;
      buf ^= 1;
      s2.store(ws);
      __syncthreads();
      if (t + 1 < FC / KB) s2.load(w2f, C, (t + 1) * KB);
      tile::fma_tile<NG, KB>(acc, Ht + t * KB * lda, lda, ws, C, 4 * ty,
                             4 * tx, 4 * TX);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * ty + r;
    if (row >= p.M) continue;
    const float s = p.res == kScaled ? p.scale[row] : 1.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * tx + 4 * TX * j;
      const float4 bv = tile::load4(b2 + col);
      float4 y = make_float4(acc[r][4 * j + 0] + bv.x, acc[r][4 * j + 1] + bv.y,
                             acc[r][4 * j + 2] + bv.z,
                             acc[r][4 * j + 3] + bv.w);
      if (p.res != kNoRes) {
        const float4 xv = tile::load4(x + static_cast<size_t>(row) * C + col);
        y = make_float4(xv.x + s * y.x, xv.y + s * y.y, xv.z + s * y.z,
                        xv.w + s * y.w);
      }
      tile::store4(out + static_cast<size_t>(row) * C + col, y);
    }
  }
}

// The block plan the launch passes (premlp_plan in ops/cuda/mlp.py): rows a
// block, F chunk, threads and shared-memory bytes.
struct Plan {
  int rows, f_chunk, threads;
  long long smem;
};

template <typename T, int TX, int NG, int NG1, int KB>
cudaError_t launch(const MlpArgs& p, const Plan& plan, cudaStream_t s) {
  using K = Cfg<TX, NG, NG1, KB>;
  static_assert(K::smem <= kMaxSmem, "tile does not fit in shared memory");
  static_assert(K::C % KB == 0 && K::FC % KB == 0, "slices must divide");
  if (p.F % K::FC != 0 || plan.rows != K::BM || plan.f_chunk != K::FC ||
      plan.threads != 256 || plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  auto kernel = premlp_kernel<T, TX, NG, NG1, KB>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + K::BM - 1) / K::BM, 256, K::smem, s>>>(p);
  return cudaGetLastError();
}

// (TX, NG, NG1, KB) by C; F must be a multiple of FC = 4 * TX * NG1
cudaError_t dispatch_f32(const MlpArgs& p, const Plan& k, int C,
                         cudaStream_t s) {
  switch (C) {
    case 32: return launch<float, 8, 1, 1, 16>(p, k, s);
    case 64: return launch<float, 16, 1, 1, 16>(p, k, s);
    case 96: return launch<float, 8, 3, 3, 16>(p, k, s);
    case 128: return launch<float, 32, 1, 1, 16>(p, k, s);
    case 192: return launch<float, 16, 3, 3, 16>(p, k, s);
    case 256: return launch<float, 32, 2, 2, 16>(p, k, s);
    case 384: return launch<float, 32, 3, 3, 16>(p, k, s);
    case 512: return launch<float, 32, 4, 2, 16>(p, k, s);
    case 768: return launch<float, 32, 6, 3, 8>(p, k, s);
    case 1024: return launch<float, 32, 8, 2, 4>(p, k, s);
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

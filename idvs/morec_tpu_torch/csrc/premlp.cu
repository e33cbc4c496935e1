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
// at F = 4C it is bound by operations at every Swin width; in float32 (no
// TF32, for parity) and, for now, in bf16 too (widened to float) by the
// float FMA rate. The (M, F) intermediate is 4x the size of x and never
// leaves the block. Design: unlike the post-LN tails (rowtile.cuh) the
// LayerNorm is a prologue on x, so the tile grid of tile.cuh fits widths
// that are no multiple of 128: a 256-thread block owns BM = 4 * (256 / TX)
// rows (128 at C = 96, 32 from C = 384 on), normalises them once into a
// transposed tile in shared memory, and walks F in chunks of FC columns:
// dense1 into a 4 x 4NG1 register tile, bias, activation and cast parked
// transposed in shared memory, then folded into the block's 4 x 4NG dense2
// accumulator (all C columns). Weight slices are double-buffered with the
// next slice's loads in flight during the FMAs; the residual and the
// per-row scale run on the accumulator before the single (M, C) store.
#include "tile.cuh"

namespace idvs {
namespace {

enum Act { kGelu = 0, kRelu = 1, kQuickGelu = 2 };
enum Res { kNoRes = 0, kUnit = 1, kScaled = 2 };

__device__ __forceinline__ float act(float h, int a) {
  if (a == kRelu) return fmaxf(h, 0.f);
  if (a == kQuickGelu) return h / (1.f + expf(-1.702f * h));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

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

template <typename T, int TX, int NG, int NG1, int KB>
cudaError_t launch(const MlpArgs& p, cudaStream_t s) {
  using K = Cfg<TX, NG, NG1, KB>;
  static_assert(K::smem <= kMaxSmem, "tile does not fit in shared memory");
  static_assert(K::C % KB == 0 && K::FC % KB == 0, "slices must divide");
  if (p.F % K::FC != 0) return cudaErrorInvalidValue;
  auto kernel = premlp_kernel<T, TX, NG, NG1, KB>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + K::BM - 1) / K::BM, 256, K::smem, s>>>(p);
  return cudaGetLastError();
}

// (TX, NG, NG1, KB) by C; F must be a multiple of FC = 4 * TX * NG1
template <typename T>
cudaError_t dispatch(const MlpArgs& p, int C, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 8, 1, 1, 16>(p, s);
    case 64: return launch<T, 16, 1, 1, 16>(p, s);
    case 96: return launch<T, 8, 3, 3, 16>(p, s);
    case 128: return launch<T, 32, 1, 1, 16>(p, s);
    case 192: return launch<T, 16, 3, 3, 16>(p, s);
    case 256: return launch<T, 32, 2, 2, 16>(p, s);
    case 384: return launch<T, 32, 3, 3, 16>(p, s);
    case 512: return launch<T, 32, 4, 2, 16>(p, s);
    case 768: return launch<T, 32, 6, 3, 8>(p, s);
    case 1024: return launch<T, 32, 8, 2, 4>(p, s);
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
// cast(xn @ w1 + b1) for the backward, or null. C must be 32, 64, 96, 128, 192, 256, 384, 512, 768 or
// 1024, F a multiple of min(C, 384) (of 256 at C = 512 and 1024).
extern "C" int idvs_premlp_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* gamma, const void* beta,
                               const void* scale, void* out, void* h, int M,
                               int C, int F, float eps, int activation, int res,
                               int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || F < 1 || activation < 0 || activation > 2 || res < 0 ||
      res > 2 || (res == kScaled && scale == nullptr) ||
      ((gamma == nullptr) != (beta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs p{x, w1, b1, w2, b2, static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<const float*>(scale), out, h, M, F, eps,
                  activation, res};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(dispatch<float>(p, C, s));
  if (dtype == kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(p, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// in bf16. Three bodies:
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
// float32 at C = 128, 256, 512 (mlp_resln_kernel): no TF32, for parity, so
// the float FMA units; one 256-thread block per 32-row tile keeps its x
// tile resident in shared memory and walks F in chunks (256 wide at C =
// 512): h = act(x @ W1[:, chunk] + b1), cast, parked in shared memory and
// folded into the block's (32, C) dense2 accumulator (an 8 x 8 tile per
// thread, rowtile.cuh), weight slices double-buffered; the epilogue is
// rowtile.cuh's ln_epilogue.
//
// C = 2048, both dtypes: a block cannot hold a (rows, 2048) float
// accumulator for more than 8 rows, and 8-row blocks each streamed all of
// W1 and W2 from L2 (10.7 GB at M = 640 in float32; M = 10 filled 2 SMs).
// So h goes through device memory (10 MB in bf16 at M = 640 beside 67 MB of
// weights) and the two products are gemm.cu's, split over M, N and K to
// fill the card whatever M: h = f32(x @ W1) + b1 (bias epilogue, float
// out), g = cast(act(h)) (gemm.cu's act pre-pass in bf16, on load in
// float32), y = f32(g @ W2) split over K with a fixed-order sum; then
// post_ln_rows_kernel, one block a row: b2, dropout, residual, cast, y_pre
// and the LN. The wrapper (ops/cuda/mlp.py) composes them; the other split,
// blocks of (rows, F slice) writing float partial sums of dense2, was not
// built (PERF.md).
#include "mlp_mma.cuh"
#include "rowtile.cuh"

namespace idvs {
namespace {

using rowtile::BSlice;
using rowtile::fma_slice;
using rowtile::kThreads;
using rowtile::Layout;
using rowtile::ln_epilogue;
using rowtile::load4;
using rowtile::store4;

// ---- float32 at C <= 512: the scalar FMA body ------------------------------

// F is walked in chunks of FC = 128 * WC columns: in dense1 every lane owns
// one 4-column group of the chunk (a TR x 4 tile of h).
template <int C>
__host__ __device__ constexpr int f_chunk() { return 128 * Layout<C>::WC; }

template <int C>
constexpr size_t mlp_smem_floats() {
  using Lay = Layout<C>;
  return C * Lay::LDA + f_chunk<C>() * Lay::LDA + 2 * Lay::BK * C +
         Lay::kRedFloats;
}

template <int C, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_resln_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     float* __restrict__ ypre, float* __restrict__ hsave,
                     int M, int F, float eps, Drop drop) {
  using Lay = Layout<C>;
  constexpr int TR = Lay::TR, FC = f_chunk<C>();
  constexpr int kBM = Lay::BM, kBK = Lay::BK, kLdA = Lay::LDA;
  constexpr int kSlices1 = C / kBK, kSlices2 = FC / kBK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Xt = smem;                // [C][kLdA]      x tile, transposed
  float* Ht = Xt + C * kLdA;       // [FC][kLdA]     act(h) chunk, transposed
  float* Ws = Ht + FC * kLdA;      // 2 x [kBK][C]   W1 or W2 slices
  float* red = Ws + 2 * kBK * C;   // [Lay::kRedFloats]
  const int row0 = blockIdx.x * kBM;
  const int l = threadIdx.x & 31;
  const int row_off = Lay::wr() * TR;
  const int col1 = Lay::wc() * 128;            // dense1 column span
  const int col2 = Lay::wc() * 128 * Lay::NG;  // dense2 column span

  // the x tile stays resident for the whole F walk
  for (int i = threadIdx.x; i < kBM * C / 4; i += kThreads) {
    const int r = i / (C / 4), k = 4 * (i % (C / 4));
    const int row = row0 + r;
    const float4 v = row < M ? load4(x + static_cast<size_t>(row) * C + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    Xt[(k + 0) * kLdA + r] = v.x;
    Xt[(k + 1) * kLdA + r] = v.y;
    Xt[(k + 2) * kLdA + r] = v.z;
    Xt[(k + 3) * kLdA + r] = v.w;
  }

  float acc[TR][4 * Lay::NG] = {};
  for (int f0 = 0; f0 < F; f0 += FC) {
    // dense1: h = x @ W1[:, f0:f0+FC], double-buffered over K = C
    float h[TR][4] = {};
    BSlice<float, FC, kBK> s1;
    s1.load(w1, F, 0, f0);
    for (int t = 0; t < kSlices1; ++t) {
      float* ws = Ws + (t & 1) * kBK * C;
      s1.store(ws);
      __syncthreads();
      if (t + 1 < kSlices1) s1.load(w1, F, (t + 1) * kBK, f0);
      fma_slice<TR, 1, FC, kBK, kLdA>(h, Xt + t * kBK * kLdA, ws, row_off,
                                      col1);
    }
    // act(h + b1) into the chunk buffer; the previous chunk's reads of Ht
    // ended before the first barrier of the loop above
    const float4 bv = load4(b1 + f0 + col1 + 4 * l);
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
    if (hsave != nullptr) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = row0 + row_off + r;
        if (row < M)
          store4(hsave + static_cast<size_t>(row) * F + f0 + col1 + 4 * l,
                 make_float4(h[r][0] + bb[0], h[r][1] + bb[1],
                             h[r][2] + bb[2], h[r][3] + bb[3]));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < TR; ++r)
        Ht[(col1 + 4 * l + c) * kLdA + row_off + r] = act(h[r][c] + bb[c],
                                                          ACT);
    // dense2: acc += h @ W2[f0:f0+FC, :], double-buffered over K = FC
    BSlice<float, C, kBK> s2;
    s2.load(w2, C, f0, 0);
    for (int t = 0; t < kSlices2; ++t) {
      float* ws = Ws + (t & 1) * kBK * C;
      s2.store(ws);
      __syncthreads();
      if (t + 1 < kSlices2) s2.load(w2, C, f0 + (t + 1) * kBK, 0);
      fma_slice<TR, Lay::NG, C, kBK, kLdA>(acc, Ht + t * kBK * kLdA, ws,
                                           row_off, col2);
    }
  }
  ln_epilogue<float, C>(acc, b2, x, gamma, beta, out, row0, M, eps, red,
                        drop, ypre);
}

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
  constexpr int C = K::C, BM = K::BM, WN = K::WN, NJ2 = K::NJ2;
  extern __shared__ __align__(16) unsigned char post_smem[];
  const bf16* b2 = static_cast<const bf16*>(p.b2);
  bf16* ypre = static_cast<bf16*>(p.ypre);
  MlpChain<K> chain(post_smem, static_cast<const bf16*>(p.w1),
                    static_cast<const bf16*>(p.b1),
                    static_cast<const bf16*>(p.w2),
                    static_cast<bf16*>(p.hsave), p.M, p.F);
  float* red = reinterpret_cast<float*>(post_smem + K::chain_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / WN, wn = warp % WN, g = lane >> 2, q = lane & 3;
  chain.start(static_cast<const bf16*>(p.x));
  float acc[NJ2][4] = {};
  chain.run(p.act, acc);

  // y_pre = cast(dropout(acc + b2) + x) in place, its row sums
  const int ocol = wn * (C / WN);
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * rw + g + 8 * hh, row = chain.row0 + r;
    const bf16* xs = chain.Xs + r * K::ldx;
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = ocol + 8 * j + 2 * q;
      const float2 bb = pair_f32(b2 + col), xv = pair_f32(xs + col);
      const uint32_t index = static_cast<uint32_t>(row) * C + col;
      const float y0 = round_to<bf16>(
          p.drop.apply(acc[j][2 * hh] + bb.x, index) + xv.x);
      const float y1 = round_to<bf16>(
          p.drop.apply(acc[j][2 * hh + 1] + bb.y, index + 1) + xv.y);
      acc[j][2 * hh] = y0;
      acc[j][2 * hh + 1] = y1;
      sum[hh] += y0 + y1;
      sq[hh] += y0 * y0 + y1 * y1;
      if (ypre != nullptr && row < p.M)
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
    const int row = chain.row0 + 16 * rw + g + 8 * hh;
    if (row >= p.M) continue;
    const float mu = sum[hh] / C;
    const float var = fmaxf(sq[hh] / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + p.eps);
    bf16* orow = static_cast<bf16*>(p.out) + static_cast<size_t>(row) * C;
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const int col = ocol + 8 * j + 2 * q;
      store_pair(orow + col,
                 (acc[j][2 * hh] - mu) * rstd * p.gamma[col] + p.beta[col],
                 (acc[j][2 * hh + 1] - mu) * rstd * p.gamma[col + 1] +
                     p.beta[col + 1]);
    }
  }
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

template <int C, int ACT>
cudaError_t launch_f32(const PostArgs& p, const Plan& plan, cudaStream_t s) {
  constexpr int kBM = Layout<C>::BM;
  const size_t smem = sizeof(float) * mlp_smem_floats<C>();
  if (p.F % f_chunk<C>() != 0 || plan.rows != kBM ||
      plan.f_chunk != f_chunk<C>() || plan.threads != kThreads ||
      plan.smem != static_cast<long long>(smem))
    return cudaErrorInvalidValue;
  auto kernel = mlp_resln_kernel<C, ACT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  kernel<<<(p.M + kBM - 1) / kBM, kThreads, smem, s>>>(
      f(p.x), f(p.w1), f(p.b1), f(p.w2), f(p.b2), p.gamma, p.beta,
      static_cast<float*>(p.out), static_cast<float*>(p.ypre),
      static_cast<float*>(p.hsave), p.M, p.F, p.eps, p.drop);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t dispatch_f32_c(const PostArgs& p, const Plan& k, int C,
                           cudaStream_t s) {
  switch (C) {
    case 128: return launch_f32<128, ACT>(p, k, s);
    case 256: return launch_f32<256, ACT>(p, k, s);
    case 512: return launch_f32<512, ACT>(p, k, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(const PostArgs& p, const Plan& k, int C,
                         cudaStream_t s) {
  if (p.act == kRelu) return dispatch_f32_c<kRelu>(p, k, C, s);
  if (p.act == kQuickGelu) return dispatch_f32_c<kQuickGelu>(p, k, C, s);
  return dispatch_f32_c<kGelu>(p, k, C, s);
}

// ---- C = 2048: the row pass after gemm.cu's two products ------------------

constexpr int kRowThreads = 256;

// One block a row of C = 2048 columns, 8 a thread in two 4-column groups
// 1024 apart: y_pre = cast(dropout(y + b2) + x), stored when asked, then
// the LN of y_pre with the row's sums added in a fixed order (lanes by
// xor shuffles, then the 8 warps in order through shared memory).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    post_ln_rows_kernel(const float* __restrict__ y, const T* __restrict__ b2,
                        const T* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out,
                        T* __restrict__ ypre, float eps, Drop drop) {
  constexpr int C = 2048, NG = C / (4 * kRowThreads);
  __shared__ float red[2][kRowThreads / 32];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[NG][4];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int col = 4 * threadIdx.x + 4 * kRowThreads * j;
    const float4 a = load4(y + row * C + col), b = load4(b2 + col);
    const float4 r = load4(x + row * C + col);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    const float rv[4] = {r.x, r.y, r.z, r.w};
    const uint32_t index = static_cast<uint32_t>(row * C + col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[j][c] = round_to<T>(drop.apply(av[c] + bv[c], index + c) + rv[c]);
      sum += v[j][c];
      sq += v[j][c] * v[j][c];
    }
    if (ypre != nullptr)
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
  sum = sq = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) {
    sum += red[0][w];
    sq += red[1][w];
  }
  const float mu = sum / C;
  const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int col = 4 * threadIdx.x + 4 * kRowThreads * j;
    const float4 g4 = load4(gamma + col), be = load4(beta + col);
    store4(out + row * C + col,
           make_float4((v[j][0] - mu) * rstd * g4.x + be.x,
                       (v[j][1] - mu) * rstd * g4.y + be.y,
                       (v[j][2] - mu) * rstd * g4.z + be.z,
                       (v[j][3] - mu) * rstd * g4.w + be.w));
  }
}

template <typename T>
cudaError_t launch_rows(const float* y, const void* b2, const void* x,
                        const float* gamma, const float* beta, void* out,
                        void* ypre, int M, float eps, Drop drop,
                        cudaStream_t s) {
  post_ln_rows_kernel<T><<<M, kRowThreads, 0, s>>>(
      y, static_cast<const T*>(b2), static_cast<const T*>(x), gamma, beta,
      static_cast<T*>(out), static_cast<T*>(ypre), eps, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// x, out: (M, C); w1: (C, F) and w2: (F, C) in (in, out) layout; b1: (F,),
// b2: (C,) in the compute dtype; gamma, beta: (C,) float. C must be 128,
// 256 or 512, F a multiple of the plan's chunk; rows, f_chunk, threads,
// smem: the block plan (mlp_resln_plan), which must be the one built for C
// and the dtype. activation: 0 = exact GELU, 1 = ReLU, 2 = quick_gelu.
// ypre (M, C) and h (M, F), in the compute dtype, are both given (training
// edition) or both null. Dropout: drop_key = mix32(seed), drop_thresh = 0
// for none (dropout.cuh). bf16 operands 16-byte aligned.
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
  if (dtype == kF32) return static_cast<int>(dispatch_f32(p, plan, C, s));
  if (dtype == kBF16) return static_cast<int>(dispatch_bf16(p, plan, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row pass of the C = 2048 tail: y (M, 2048) float, the sum of the two
// products before b2; b2, x, out and ypre (null outside training) in the
// compute dtype, gamma and beta float. out = LN(cast(dropout(y + b2) + x))
// and ypre = cast(dropout(y + b2) + x), the dropout at element row * 2048
// + col.
extern "C" int idvs_post_ln_rows(const void* y, const void* b2,
                                 const void* x, const void* gamma,
                                 const void* beta, void* out, void* ypre,
                                 int M, int C, float eps, unsigned drop_key,
                                 unsigned drop_thresh, float drop_scale,
                                 int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || C != 2048) return static_cast<int>(cudaErrorInvalidValue);
  const Drop d{drop_key, drop_thresh, drop_scale};
  const float* yf = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        launch_rows<float>(yf, b2, x, g, bt, out, ypre, M, eps, d, s));
  if (dtype == kBF16)
    return static_cast<int>(launch_rows<__nv_bfloat16>(yf, b2, x, g, bt, out,
                                                       ypre, M, eps, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

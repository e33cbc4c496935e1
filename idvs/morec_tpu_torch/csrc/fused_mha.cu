// Multi-head self-attention over packed (B, T, 3H) QKV for short sequences
// (T <= 128), one block per (row, head): the forward and its backward, and
// the backward's dbias edition for a trainable additive bias.
//
// Replaces idvs/morec_tpu/ops/pallas/attention.py _fwd_kernel and
// _bwd_kernel (reached through fused_mha), with the in-kernel dropout of the
// attention probabilities and, for Swin's relative-position table
// (bias_grad), the bias gradient.
//
// Forward, as the Pallas kernel:
//   s    = f32(q . k) * (1/sqrt(dh))
//   s   += (1 - mask[key]) * -1e9              (mode 0, BERT key mask)
//       or bias[row % P, head, query, key]     (mode 1, additive bias)
//   p    = softmax_f32(s), cast to the compute dtype
//   pd   = keep ? cast(p * 1/(1-drop)) : 0     (dropout.cuh; pd = p at 0)
//   out  = f32-accumulated pd . v, cast to the compute dtype
// Backward (recomputes p from q, k and the mask; _bwd_kernel :213-269):
//   dv   = pdᵀ . dout
//   dp   = dout . vᵀ, dropped like pd (keep ? * 1/(1-drop) : 0)
//   ds   = p_f32 * (dp - rowsum(dp * p_f32)), then * 1/sqrt(dh), cast to
//          the compute dtype (:253)
//   dq   = ds . k,  dk = dsᵀ . q          -> packed (B, T, 3H) dqkv
//   dbias[p, h] = sum over rows r with r % P = p of the unscaled f32 ds
//          (:241-252), in the dbias edition only
// A row whose keys are all masked sees every score at -1e9 and comes out
// uniform and finite, in both directions, as in the Pallas kernel.
//
// Bound on the H100: at T = 20..49 a head's tile is tiny (q, k, v of 49 x 32
// floats for Swin), so the work is the qkv read plus a few thousand float
// FMAs per head; the kernels are latency- and bandwidth-bound, not
// tensor-core-bound. Design: one block holds one head's tiles in shared
// memory (rows padded by one float to keep the column walks conflict-free),
// reads qkv and dout in their natural layouts with no head transpose, and
// writes the context or the packed dqkv directly. SASRec's dh = 256 at
// T = 20 needs ~82 KB in backward (q, k, v, dout and two (T, T) tiles), so
// both kernels opt into dynamic shared memory above 48 KB.
// dbias: the TPU kernel adds every block's ds into a resident buffer over
// its sequential grid. Here blocks run in no order, so the dbias edition
// gives block (chunk, p, head) a share of the rows r with r % P = p, walks
// them in order with the sum in a (T, T) shared plane, and writes one
// partial plane; idvs_sum_partials adds the chunks in a fixed order. No
// atomics: two runs give the same bits.
#include "common.cuh"
#include "dropout.cuh"
#include "mha_tile.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

constexpr int kMhaThreads = 128;

struct Geometry {
  int T, nh, dh, mode, P;
  long long bias_sp, bias_sh;
  float scale;
};

// s[i][j] = scaled q_i . k_j plus the mask or bias, for the block's head
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       float* ss, const float* bias, int b,
                                       int h, const Geometry& g) {
  const int ld = g.dh + 1, lds = g.T + 1;
  const float* bias_bh =
      g.mode == 0 ? bias + static_cast<size_t>(b) * g.T
                  : bias + (b % g.P) * g.bias_sp + h * g.bias_sh;
  for (int idx = threadIdx.x; idx < g.T * g.T; idx += blockDim.x) {
    const int i = idx / g.T, j = idx % g.T;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
    for (int d = 0; d < g.dh; ++d) acc = fmaf(qi[d], kj[d], acc);
    float s = acc * g.scale;
    if (g.mode == 0)
      s += (1.f - bias_bh[j]) * -1e9f;
    else
      s += bias_bh[i * g.T + j];
    ss[i * lds + j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMhaThreads)
    mha_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                   T* __restrict__ out, Geometry g, Drop drop) {
  extern __shared__ float smem[];
  const int T_ = g.T, dh = g.dh, ld = dh + 1, lds = T_ + 1;
  float* qs = smem;             // [T][dh + 1]
  float* ks = qs + T_ * ld;     // [T][dh + 1]
  float* vs = ks + T_ * ld;     // [T][dh + 1]
  float* ss = vs + T_ * ld;     // [T][T + 1]  scores, then probabilities

  const int b = blockIdx.x / g.nh, h = blockIdx.x % g.nh;
  const int H = g.nh * dh;
  const size_t row_stride = 3 * static_cast<size_t>(H);
  const T* base = qkv + static_cast<size_t>(b) * T_ * row_stride + h * dh;
  load_head(base, row_stride, T_, dh, qs);
  load_head(base + H, row_stride, T_, dh, ks);
  load_head(base + 2 * H, row_stride, T_, dh, vs);
  __syncthreads();
  scores(qs, ks, ss, bias, b, h, g);
  __syncthreads();
  softmax_rows(ss, T_);
  __syncthreads();
  // cast, then dropout on the cast probabilities (attention.py:166-170)
  const uint32_t plane = static_cast<uint32_t>(blockIdx.x) * T_ * T_;
  for (int idx = threadIdx.x; idx < T_ * T_; idx += blockDim.x) {
    const int i = idx / T_, j = idx % T_;
    float* s = ss + i * lds + j;
    *s = round_to<T>(drop.apply(round_to<T>(*s), plane + idx));
  }
  __syncthreads();

  T* obase = out + static_cast<size_t>(b) * T_ * H + h * dh;
  for (int idx = threadIdx.x; idx < T_ * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx % dh;
    const float* pi = ss + i * lds;
    float acc = 0.f;
    for (int j = 0; j < T_; ++j) acc = fmaf(pi[j], vs[j * ld + d], acc);
    obase[static_cast<size_t>(i) * H + d] = from_f32<T>(acc);
  }
}

// One (row b, head h) tile of the backward: dqkv of the tile and, when da
// is not null, the unscaled f32 ds added into the (T, T) plane da (each
// element of da always owned by the same thread). The caller has made sure
// the previous tile's reads of shared memory are over.
template <typename T>
__device__ __forceinline__ void bwd_tile(const T* __restrict__ qkv,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ dout,
                                         T* __restrict__ dqkv,
                                         const Geometry& g, const Drop& drop,
                                         int b, int h, float* smem,
                                         float* da) {
  const int T_ = g.T, dh = g.dh, ld = dh + 1, lds = T_ + 1;
  float* qs = smem;             // [T][dh + 1]
  float* ks = qs + T_ * ld;
  float* vs = ks + T_ * ld;
  float* os = vs + T_ * ld;     // [T][dh + 1]  dout
  float* ps = os + T_ * ld;     // [T][T + 1]   p (f32), then dropped pd
  float* ds = ps + T_ * lds;    // [T][T + 1]   dp, then ds

  const int H = g.nh * dh;
  const size_t row_stride = 3 * static_cast<size_t>(H);
  const T* base = qkv + static_cast<size_t>(b) * T_ * row_stride + h * dh;
  load_head(base, row_stride, T_, dh, qs);
  load_head(base + H, row_stride, T_, dh, ks);
  load_head(base + 2 * H, row_stride, T_, dh, vs);
  load_head(dout + static_cast<size_t>(b) * T_ * H + h * dh,
            static_cast<size_t>(H), T_, dh, os);
  __syncthreads();
  scores(qs, ks, ps, bias, b, h, g);
  __syncthreads();
  softmax_rows(ps, T_);

  // dp = dout . vᵀ, dropped with the forward's mask
  const uint32_t plane =
      static_cast<uint32_t>(b * g.nh + h) * static_cast<uint32_t>(T_ * T_);
  for (int idx = threadIdx.x; idx < T_ * T_; idx += blockDim.x) {
    const int i = idx / T_, j = idx % T_;
    const float* oi = os + i * ld;
    const float* vj = vs + j * ld;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(oi[d], vj[d], acc);
    ds[i * lds + j] = drop.apply(acc, plane + idx);
  }
  __syncthreads();

  // softmax backward in f32, one warp per row; the row's p is then
  // replaced by the forward's dropped, cast probabilities
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < T_; i += blockDim.x >> 5) {
    float* pi = ps + i * lds;
    float* di = ds + i * lds;
    float dot = 0.f;
    for (int j = lane; j < T_; j += 32) dot = fmaf(di[j], pi[j], dot);
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(~0u, dot, o);
    for (int j = lane; j < T_; j += 32) {
      const float p = pi[j];
      const float dsf = p * (di[j] - dot);
      if (da != nullptr) da[i * T_ + j] += dsf;
      di[j] = round_to<T>(dsf * g.scale);
      pi[j] = round_to<T>(drop.apply(round_to<T>(p), plane + i * T_ + j));
    }
  }
  __syncthreads();

  // dq = ds . k, dk = dsᵀ . q, dv = pdᵀ . dout; thread (t, d) owns all three
  T* gbase = dqkv + static_cast<size_t>(b) * T_ * row_stride + h * dh;
  for (int idx = threadIdx.x; idx < T_ * dh; idx += blockDim.x) {
    const int t = idx / dh, d = idx % dh;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < T_; ++j) {
      dq = fmaf(ds[t * lds + j], ks[j * ld + d], dq);
      dk = fmaf(ds[j * lds + t], qs[j * ld + d], dk);
      dv = fmaf(ps[j * lds + t], os[j * ld + d], dv);
    }
    T* row = gbase + t * row_stride + d;
    row[0] = from_f32<T>(dq);
    row[H] = from_f32<T>(dk);
    row[2 * H] = from_f32<T>(dv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMhaThreads)
    mha_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                   const T* __restrict__ dout, T* __restrict__ dqkv,
                   Geometry g, Drop drop) {
  extern __shared__ float smem[];
  bwd_tile(qkv, bias, dout, dqkv, g, drop, blockIdx.x / g.nh,
           blockIdx.x % g.nh, smem, nullptr);
}

// The dbias edition (mode 1 only): block (chunk, p, h) walks, in order, its
// share of the rows r with r % P = p, sums their ds in a shared (T, T)
// plane and writes it as one partial plane: at ((chunk * P + p) * nh + h)
// for a bias per head, at ((chunk * nh + h) * P + p) for a bias shared by
// the heads, so that sum_partials over the leading index gives (P, nh, T,
// T) or (P, 1, T, T).
template <typename T>
__global__ void __launch_bounds__(kMhaThreads)
    mha_bwd_dbias_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout, T* __restrict__ dqkv,
                         float* __restrict__ part, int B, int chunks,
                         Geometry g, Drop drop) {
  extern __shared__ float smem[];
  const int T_ = g.T;
  float* da = smem + 4 * T_ * (g.dh + 1) + 2 * T_ * (T_ + 1);   // [T][T]
  const int h = blockIdx.x % g.nh;
  const int p = (blockIdx.x / g.nh) % g.P;
  const int chunk = blockIdx.x / (g.nh * g.P);
  const int per_slot = B / g.P;                    // rows of slot p
  const int per = (per_slot + chunks - 1) / chunks;
  const int i_end = min(per_slot, (chunk + 1) * per);
  for (int idx = threadIdx.x; idx < T_ * T_; idx += blockDim.x) da[idx] = 0.f;
  for (int i = chunk * per; i < i_end; ++i) {
    __syncthreads();   // the last tile's reads of shared memory are over
    bwd_tile(qkv, bias, dout, dqkv, g, drop, i * g.P + p, h, smem, da);
  }
  __syncthreads();     // da's elements were written by their owners
  const size_t slot = g.bias_sh == 0
                          ? (static_cast<size_t>(chunk) * g.nh + h) * g.P + p
                          : (static_cast<size_t>(chunk) * g.P + p) * g.nh + h;
  float* out = part + slot * T_ * T_;
  for (int idx = threadIdx.x; idx < T_ * T_; idx += blockDim.x)
    out[idx] = da[idx];
}

size_t fwd_smem_bytes(int T_, int dh) {
  return sizeof(float) * (3 * static_cast<size_t>(T_) * (dh + 1) +
                          static_cast<size_t>(T_) * (T_ + 1));
}

size_t bwd_smem_bytes(int T_, int dh) {
  return sizeof(float) * (4 * static_cast<size_t>(T_) * (dh + 1) +
                          2 * static_cast<size_t>(T_) * (T_ + 1));
}

size_t dbias_smem_bytes(int T_, int dh) {
  return bwd_smem_bytes(T_, dh) + sizeof(float) * T_ * T_;
}

bool valid(int B, const Geometry& g, size_t smem) {
  return B >= 1 && g.T >= 1 && g.T <= 128 && g.nh >= 1 && g.dh >= 1 &&
         smem <= kMaxSmem && (g.mode == 0 || (g.mode == 1 && g.P >= 1));
}

template <typename T>
cudaError_t launch_fwd(const void* qkv, const float* bias, void* out, int B,
                       const Geometry& g, Drop drop, size_t smem,
                       cudaStream_t stream) {
  auto kernel = mha_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * g.nh, kMhaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<T*>(out), g, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* qkv, const float* bias, const void* dout,
                       void* dqkv, int B, const Geometry& g, Drop drop,
                       size_t smem, cudaStream_t stream) {
  auto kernel = mha_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * g.nh, kMhaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), g, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dbias(const void* qkv, const float* bias,
                             const void* dout, void* dqkv, float* part, int B,
                             int chunks, const Geometry& g, Drop drop,
                             size_t smem, cudaStream_t stream) {
  auto kernel = mha_bwd_dbias_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<chunks * g.P * g.nh, kMhaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), part, B, chunks, g, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// bias: mode 0 -> (B, T) key mask; mode 1 -> additive bias whose element
// (row, head, i, j) sits at (row % P) * bias_sp + head * bias_sh + i * T + j
// (bias_sh = 0 shares one (T, T) plane across heads). Float either way: the
// wrapper has already rounded it through the compute dtype. Dropout:
// drop_key = mix32(seed), drop_thresh = 0 for none (dropout.cuh); the
// element index of probability (row, head, i, j) is ((row*nh + head)*T +
// i)*T + j.
extern "C" int idvs_fused_mha_fwd(const void* qkv, const void* bias,
                                  void* out, int B, int T_, int nh, int dh,
                                  int mode, int P, long long bias_sp,
                                  long long bias_sh, float scale,
                                  unsigned drop_key, unsigned drop_thresh,
                                  float drop_scale, int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, mode, P, bias_sp, bias_sh, scale};
  const Drop drop{drop_key, drop_thresh, drop_scale};
  const size_t smem = fwd_smem_bytes(T_, dh);
  if (!valid(B, g, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_fwd<float>(qkv, b, out, B, g, drop, smem,
                                              s));
  if (dtype == kBF16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(qkv, b, out, B, g,
                                                      drop, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout: (B, T, H); dqkv: (B, T, 3H), both in the compute dtype. The other
// arguments as for idvs_fused_mha_fwd, which must have used the same drop.
extern "C" int idvs_fused_mha_bwd(const void* qkv, const void* bias,
                                  const void* dout, void* dqkv, int B, int T_,
                                  int nh, int dh, int mode, int P,
                                  long long bias_sp, long long bias_sh,
                                  float scale, unsigned drop_key,
                                  unsigned drop_thresh, float drop_scale,
                                  int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, mode, P, bias_sp, bias_sh, scale};
  const Drop drop{drop_key, drop_thresh, drop_scale};
  const size_t smem = bwd_smem_bytes(T_, dh);
  if (!valid(B, g, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_bwd<float>(qkv, b, dout, dqkv, B, g, drop,
                                              smem, s));
  if (dtype == kBF16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(qkv, b, dout, dqkv, B,
                                                      g, drop, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dbias edition of idvs_fused_mha_bwd, additive bias (mode 1) only: also
// writes the partial planes of the unscaled f32 softmax backward summed over
// the rows r with r % P = p, chunks * nh * P * T * T floats into part (see
// mha_bwd_dbias_kernel for their order); idvs_sum_partials then adds the
// chunks in a fixed order. P divides B and 1 <= chunks <= B / P.
extern "C" int idvs_fused_mha_bwd_dbias(const void* qkv, const void* bias,
                                        const void* dout, void* dqkv,
                                        void* part, int B, int T_, int nh,
                                        int dh, int P, int chunks,
                                        long long bias_sp, long long bias_sh,
                                        float scale, unsigned drop_key,
                                        unsigned drop_thresh, float drop_scale,
                                        int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, 1, P, bias_sp, bias_sh, scale};
  const Drop drop{drop_key, drop_thresh, drop_scale};
  const size_t smem = dbias_smem_bytes(T_, dh);
  if (!valid(B, g, smem) || B % P || chunks < 1 || chunks > B / P)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_bwd_dbias<float>(qkv, b, dout, dqkv, pt, B,
                                                    chunks, g, drop, smem, s));
  if (dtype == kBF16)
    return static_cast<int>(launch_bwd_dbias<__nv_bfloat16>(
        qkv, b, dout, dqkv, pt, B, chunks, g, drop, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[e] = sum over k < nb, in order, of part[k * E + e] (reduce.cuh): the
// second pass of the dbias edition.
extern "C" int idvs_sum_partials(const void* part, void* out, int nb, int E,
                                 void* stream) {
  using namespace idvs;
  if (nb < 1 || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sum_partials(static_cast<const float*>(part),
                                       static_cast<float*>(out), nb, E,
                                       static_cast<cudaStream_t>(stream)));
}

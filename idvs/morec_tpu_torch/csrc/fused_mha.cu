// Multi-head self-attention over packed (B, T, 3H) QKV for short sequences
// (T <= 128): the forward and its backward, and the backward's dbias
// edition for a trainable additive bias. Two bodies, chosen by the compute
// dtype in each entry point: bf16 on the tensor cores (mha_*_mma_kernel),
// float32 in scalar float FMAs (mha_fwd_kernel, mha_bwd_kernel,
// mha_bwd_dbias_kernel).
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
// Bound on the H100: bytes. A (row, head) tile is small (Swin 49 x 32 for
// each of q, k and v; BERT 30 x 64; SASRec 20 x 256 and 10 x 1024), and its
// (T, T, dh) products do about T operations for every byte the tile reads
// and writes, far below the ~295 at which bf16 tensor cores become the
// limit. At Swin-T stage 0 (288 images) the forward moves 0.69 GB (0.207 ms
// at 3.35 TB/s) for 17 GFLOP (0.017 ms at 989 TFLOP/s). What costs time is
// getting every tile's bytes in flight and the latency between a tile's
// load and its store.
//
// The bf16 body:
// - Operands stay bf16 in shared memory. 16-byte cp.async copies bring q,
//   k, v (and dout) straight from the (B, T, 3H) / (B, T, H) layouts into
//   [Tp][Dp + 8] tiles: T and dh padded to multiples of 16 with zeros that
//   stay zero, each row 16 bytes longer so that ldmatrix rows fall on
//   distinct banks. Nothing is widened to float in shared memory.
// - Every product is mma.sync m16n8k16 bf16 with float32 accumulators:
//   S = q kᵀ and pd v forward; S, dp = dout vᵀ, dq = ds k, dk = dsᵀ q and
//   dv = pdᵀ dout backward. wgmma is not used: its 64-row tiles would be
//   mostly padding at T <= 128, and the work is bound by bytes, so what
//   counts is keeping many small tiles in flight.
// - A warp owns 16 query rows. Scores, the softmax (row max and sum by quad
//   shuffles), the dropout (dropout.cuh's hash at the element index with
//   the unpadded T) and the bf16 probabilities stay in registers; the
//   score accumulators are repacked as the A operand of pd v. Padded key
//   columns get -inf before the max (exactly zero probability), so a row
//   whose real keys are all at -1e9 stays uniform over the T real keys.
//   Padded query rows are never stored and never reach dk, dv or dbias.
// - Backward: dp, the float32 softmax backward and ds stay in registers;
//   dq takes ds * scale rounded to bf16 as its A operand; ds and pd go
//   through shared memory only for the two transposed products, dk and dv.
// - Blocking (choose_blocking, the one place it is decided): a tile has
//   Tp / 16 row groups, one warp each; a tile of fewer than four row groups
//   with heads of 128 or more columns (SASRec) splits each row group
//   KS ways, over the head dimension for the scores (partial sums added
//   in a fixed order through shared memory) and over the output columns
//   of the other products. Blocks are persistent, one wave of what the SMs
//   hold, and each walks many tiles with the next tile's copy in flight
//   while it computes the current one (two operand buffers where they fit
//   in half of an SM's shared memory).
// - dbias: the TPU kernel adds every block's ds into a resident buffer over
//   its sequential grid. Here blocks run in no order, so block (chunk, p,
//   head) walks its share of the rows r with r % P = p in order; each
//   thread keeps the unscaled f32 ds of its fragment's fixed (i, j) in
//   registers (in a shared plane, each element owned by one thread, above
//   T = 64) and the block writes one partial plane; idvs_sum_partials adds
//   the chunks in a fixed order. No atomics: two runs give the same bits.
//
// The float32 body: one block holds one (row, head) tile of q, k, v (and
// dout) and the (T, T) scores in shared memory (rows padded by one float to
// keep the column walks conflict-free), reads qkv and dout in their natural
// layouts with no head transpose, and writes the context or the packed
// dqkv directly, in scalar float FMAs with a __syncthreads between stages.
// Its dbias edition walks the rows of block (chunk, p, head) as above with
// the sum in a shared (T, T) plane. SASRec's dh = 256 at T = 20 needs ~82 KB
// in backward, so these kernels opt into dynamic shared memory above 48 KB.
#include <algorithm>
#include <climits>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"
#include "mha_tile.cuh"
#include "mma.cuh"
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

// ---- the bf16 body: tensor-core tiles --------------------------------------

using bf16 = __nv_bfloat16;

enum Edition { kFwd = 0, kBwd = 1, kBwdDbias = 2 };

// How a bf16 launch is cut; sizes in elements unless named bytes.
struct Blocking {
  int Tp, Dp;          // T and dh rounded up to multiples of 16
  int ld, ldt;         // row strides of the operand tiles and (T, T) planes
  int RG, KS, warps;   // row groups of 16 query rows, splits of each, warps
  int buffers;         // operand buffers (2: the next tile's copy in flight)
  int operand_elems;   // one buffer: the q, k, v (and dout) tiles
  size_t smem;         // dynamic shared memory of a block, bytes
};

__host__ __device__ inline size_t partial_bytes(const Blocking& k,
                                                int edition) {
  // [KS][RG][Tp / 8 tiles][32 lanes][4] partial scores (and dp)
  return k.KS > 1 ? sizeof(float) * (edition == kFwd ? 1 : 2) * k.KS * k.RG *
                        16 * k.Tp
                  : 0;
}

Blocking choose_blocking(int T, int dh, int edition) {
  Blocking k;
  k.Tp = (T + 15) / 16 * 16;
  k.Dp = (dh + 15) / 16 * 16;
  k.ld = k.Dp + 8;   // 16 more bytes a row: ldmatrix's 8 rows hit 8 bank groups
  k.ldt = k.Tp + 8;
  k.RG = k.Tp / 16;
  // fewer than four row groups of wide heads (SASRec): four warps a tile
  k.KS = k.RG < 4 && k.Dp >= 128 ? std::min(4 / k.RG, k.Dp / 16) : 1;
  k.warps = k.RG * k.KS;
  k.operand_elems = (edition == kFwd ? 3 : 4) * k.Tp * k.ld;
  size_t rest = partial_bytes(k, edition);
  if (edition != kFwd) rest += sizeof(bf16) * 2 * k.Tp * k.ldt;  // ds, pd
  if (edition == kBwdDbias && k.RG > 4) rest += sizeof(float) * k.Tp * k.Tp;
  const size_t one = sizeof(bf16) * k.operand_elems;
  k.buffers = 2 * one + rest <= kMaxSmem / 2 ? 2 : 1;
  k.smem = k.buffers * one + rest;
  return k;
}

// The block's shared memory: operand buffers, partial scores, the staged
// ds and pd planes, the dbias plane above T = 64.
struct MmaSmem {
  bf16* ops;
  float* red;
  bf16* ds;
  bf16* pd;
  float* da;
};

__device__ __forceinline__ MmaSmem carve(unsigned char* base,
                                         const Blocking& k, int edition) {
  MmaSmem s;
  s.ops = reinterpret_cast<bf16*>(base);
  base += sizeof(bf16) * k.buffers * k.operand_elems;
  s.red = reinterpret_cast<float*>(base);
  base += partial_bytes(k, edition);
  s.ds = reinterpret_cast<bf16*>(base);
  s.pd = s.ds + k.Tp * k.ldt;
  if (edition != kFwd) base += sizeof(bf16) * 2 * k.Tp * k.ldt;
  s.da = reinterpret_cast<float*>(base);
  return s;
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies row b's head h of q, k, v (and dout when given) into one operand
// buffer, [Tp][ld] tiles in that order. Rows >= T and columns >= dh are
// never written: they keep the zeros the kernel put there first.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ dout,
                                          int b, int h, const Geometry& g,
                                          const Blocking& k, bf16* dst,
                                          bool vec) {
  const int H = g.nh * g.dh, planes = dout != nullptr ? 4 : 3;
  const size_t row = static_cast<size_t>(b) * g.T;
  auto src = [&](int p, int t) {
    return p < 3 ? qkv + (row + t) * 3 * H + p * H + h * g.dh
                 : dout + (row + t) * H + h * g.dh;
  };
  const int cpr = g.dh / 8;   // 16-byte chunks a row
  if (vec && static_cast<int>(blockDim.x) % cpr == 0) {
    // each thread copies one chunk column of every step-th row
    const int c = threadIdx.x % cpr, step = blockDim.x / cpr;
    for (int p = 0; p < planes; ++p)
      for (int t = threadIdx.x / cpr; t < g.T; t += step)
        cp_async16(dst + (p * k.Tp + t) * k.ld + c * 8, src(p, t) + c * 8);
  } else if (vec) {   // dh % 8 == 0 and 16-byte aligned operands
    const int n = planes * g.T * cpr;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int c = idx % cpr, t = idx / cpr % g.T, p = idx / (cpr * g.T);
      cp_async16(dst + (p * k.Tp + t) * k.ld + c * 8, src(p, t) + c * 8);
    }
  } else {
    const int n = planes * g.T * g.dh;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int d = idx % g.dh, t = idx / g.dh % g.T, p = idx / (g.dh * g.T);
      dst[(p * k.Tp + t) * k.ld + d] = src(p, t)[d];
    }
  }
}

// Walks the block's items it = first, first + step, ... < end: the next
// item's copy is issued before the current one is worked on when there
// are two buffers, after it otherwise. work(it, buffer) runs between two
// __syncthreads.
template <typename Load, typename Work>
__device__ __forceinline__ void walk(int first, int end, int step,
                                     const Blocking& k, bf16* ops, Load load,
                                     Work work) {
  if (first >= end) return;
  int cur = 0;
  load(first, ops);
  cp_async_commit();
  for (int it = first; it < end; it += step) {
    const int nxt = it + step;
    if (k.buffers == 2 && nxt < end) {
      load(nxt, ops + (cur ^ 1) * k.operand_elems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    work(it, ops + cur * k.operand_elems);
    __syncthreads();
    if (k.buffers == 2) {
      cur ^= 1;
    } else if (nxt < end) {
      load(nxt, ops);
      cp_async_commit();
    }
  }
}

__device__ __forceinline__ const float* bias_row(const float* bias, int b,
                                                 int h, const Geometry& g) {
  return g.mode == 0 ? bias + static_cast<size_t>(b) * g.T
                     : bias + (b % g.P) * g.bias_sp + h * g.bias_sh;
}

// Fragment element (n, e) of a thread in row group rg: row i0 + 8 (e / 2)
// with i0 = 16 rg + lane / 4, column 8 n + 2 (lane % 4) + e % 2. Key tiles
// n >= live = ceil(T / 8) hold no real key: they are skipped, and their
// probabilities and ds are zero.

__device__ __forceinline__ int live_tiles(const Geometry& g) {
  return (g.T + 7) / 8;
}

// s = rows [16 rg, 16 rg + 16) of A times Bᵀ over the 16-column k-steps
// [k0, k1) and the live key tiles; A and B are [Tp][ld] tiles (q and k,
// or dout and v)
template <int RG>
__device__ __forceinline__ void scores_mma(const bf16* A, const bf16* B,
                                           int ld, int rg, int k0, int k1,
                                           int live, float (&s)[2 * RG][4]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const uint32_t a0 = smem_u32(A + (16 * rg + a_row(l)) * ld + a_col(l));
  const uint32_t b0 = smem_u32(B + bn_row(l) * ld + bn_col(l));
  for (int kk = k0; kk < k1; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a0 + kk * 32);
#pragma unroll
    for (int n2 = 0; n2 < RG; ++n2) {
      if (2 * n2 < live) {
        uint32_t b[4];
        ldsm_x4(b, b0 + (n2 * 16 * ld + kk * 16) * 2);
        mma_bf16(s[2 * n2], a, b[0], b[1]);
        if (2 * n2 + 1 < live) mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
}

// KS > 1: the KS warps of row group rg write their partial s, and after the
// barrier each adds all KS partials in order 0..KS-1, so all of them hold
// the same sums. red: [KS][RG][2 RG][32][4]
template <int RG>
__device__ __forceinline__ void write_partial(const float (&s)[2 * RG][4],
                                              float* red, int rg, int ks) {
  float4* r = reinterpret_cast<float4*>(red) + (ks * RG + rg) * 2 * RG * 32 +
              (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n)
    r[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
}

template <int RG>
__device__ __forceinline__ void read_sum(float (&s)[2 * RG][4],
                                         const float* red, int rg, int KS) {
  const float4* r = reinterpret_cast<const float4*>(red) + rg * 2 * RG * 32 +
                    (threadIdx.x & 31);
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < KS; ++q) {
      const float4 v = r[(q * RG * 2 * RG + n) * 32];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    s[n][0] = a.x;
    s[n][1] = a.y;
    s[n][2] = a.z;
    s[n][3] = a.w;
  }
}

// scores to probabilities in place: s * scale + the mask or bias of the
// tile's bias row `row`, -inf in padded key columns, a float32 softmax
// over each row (a quad's four lanes hold a row). Padded query rows take
// row T - 1's bias: their probabilities are finite and never used.
template <int RG>
__device__ __forceinline__ void softmax_frag(float (&s)[2 * RG][4],
                                             const float* __restrict__ row,
                                             int i0, const Geometry& g) {
  const int q = threadIdx.x & 3, live = live_tiles(g);
  const float* rows[2] = {row, row};
  if (g.mode == 1) {
    rows[0] = row + min(i0, g.T - 1) * g.T;
    rows[1] = row + min(i0 + 8, g.T - 1) * g.T;
  }
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) {
    if (n >= live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + 2 * q + (e & 1);
      float v = -INFINITY;
      if (j < g.T) {
        const float x = __ldg(rows[e >> 1] + j);
        v = s[n][e] * g.scale + (g.mode == 0 ? (1.f - x) * -1e9f : x);
      }
      s[n][e] = v;
      m[e >> 1] = fmaxf(m[e >> 1], v);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(~0u, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(~0u, m[r], 2));
  }
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) {
    if (n >= live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __expf(s[n][e] - m[e >> 1]);
      s[n][e] = x;
      sum[e >> 1] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(~0u, sum[r], 1);
    sum[r] += __shfl_xor_sync(~0u, sum[r], 2);
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = n < live ? s[n][e] * sum[e >> 1] : 0.f;
}

// the forward's dropped probability pd of p at (i, j): cast, dropout,
// cast again by the caller; zero in padded query rows
__device__ __forceinline__ float dropped(float p, int i, int j,
                                         uint32_t plane, const Geometry& g,
                                         const Drop& drop) {
  if (i >= g.T) return 0.f;
  const float v = round_to<bf16>(p);
  return j < g.T ? drop.apply(v, plane + i * g.T + j) : v;
}

// pd as the bf16 A fragments of the 16-key k-steps: register r of k-step
// kb holds tile 2 kb + r / 2, row half r % 2 (zero in dead tiles)
template <int RG>
__device__ __forceinline__ void prob_frags(uint32_t (&a)[RG][4],
                                           const float (&p)[2 * RG][4],
                                           int i0, uint32_t plane,
                                           const Geometry& g,
                                           const Drop& drop) {
  const int q = threadIdx.x & 3, live = live_tiles(g);
#pragma unroll
  for (int kb = 0; kb < RG; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 2 * kb + (r >> 1), hh = r & 1;
      const int i = i0 + 8 * hh, j = 8 * n + 2 * q;
      a[kb][r] =
          n < live
              ? pack_bf16(dropped(p[n][2 * hh], i, j, plane, g, drop),
                          dropped(p[n][2 * hh + 1], i, j + 1, plane, g, drop))
              : 0u;
    }
}

// a pair of neighbouring outputs of one row, where they are real
__device__ __forceinline__ void store_pair(bf16* row, int col, float x,
                                           float y, int cols) {
  if (col + 1 < cols && (reinterpret_cast<uintptr_t>(row + col) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < cols) row[col] = __float2bfloat16(x);
    if (col + 1 < cols) row[col + 1] = __float2bfloat16(y);
  }
}

// rows [16 grp, 16 grp + 16) of A . B for the output columns of the 16-wide
// blocks [nb0, nb1): A as bf16 fragments over the Tp-long k dimension, B a
// [Tp][ld] tile ([k][n]); stored as bf16 at dst + row * rs + column for
// rows < rows and columns < cols, 64 columns at a time
template <int RG>
__device__ __forceinline__ void product_store(const uint32_t (&a)[RG][4],
                                              const bf16* B, int ld, int nb0,
                                              int nb1, int grp,
                                              bf16* __restrict__ dst,
                                              size_t rs, int rows, int cols) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const uint32_t b0 = smem_u32(B + bk_row(l) * ld + bk_col(l));
  for (int c0 = nb0; c0 < nb1; c0 += 4) {
    float o[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c0 + c < nb1) {
#pragma unroll
        for (int kb = 0; kb < RG; ++kb) {
          uint32_t b[4];
          ldsm_x4_t(b, b0 + (kb * 16 * ld + (c0 + c) * 16) * 2);
          mma_bf16(o[2 * c], a[kb], b[0], b[1]);
          mma_bf16(o[2 * c + 1], a[kb], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (c0 + t / 2 < nb1) {
        const int col = c0 * 16 + 8 * t + 2 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * grp + g + 8 * hh;
          if (r < rows)
            store_pair(dst + r * rs, col, o[t][2 * hh], o[t][2 * hh + 1],
                       cols);
        }
      }
    }
  }
}

// A fragments of rows [16 grp, 16 grp + 16) of Pᵀ, P a [Tp][ldt] plane
template <int RG>
__device__ __forceinline__ void transposed_frags(uint32_t (&a)[RG][4],
                                                 const bf16* P, int ldt,
                                                 int grp) {
  const int l = threadIdx.x & 31;
  const uint32_t base = smem_u32(P + bn_row(l) * ldt + 16 * grp + bn_col(l));
#pragma unroll
  for (int kb = 0; kb < RG; ++kb) ldsm_x4_t(a[kb], base + kb * 16 * ldt * 2);
}

// One (row b, head h) tile of the forward; warp (rg, ks) holds row group
// rg's scores and stores its share ks of the output columns.
template <int RG>
__device__ __forceinline__ void fwd_tile_mma(const bf16* ops, float* red,
                                             const float* __restrict__ bias,
                                             bf16* __restrict__ out, int b,
                                             int h, const Geometry& g,
                                             const Blocking& k,
                                             const Drop& drop) {
  const int warp = threadIdx.x >> 5, rg = warp / k.KS, ks = warp % k.KS;
  const int i0 = 16 * rg + ((threadIdx.x & 31) >> 2);
  const int tile = k.Tp * k.ld, steps = k.Dp / 16;
  float s[2 * RG][4];
  scores_mma<RG>(ops, ops + tile, k.ld, rg, ks * steps / k.KS,
                 (ks + 1) * steps / k.KS, live_tiles(g), s);
  if (k.KS > 1) {
    write_partial<RG>(s, red, rg, ks);
    __syncthreads();
    read_sum<RG>(s, red, rg, k.KS);
  }
  softmax_frag<RG>(s, bias_row(bias, b, h, g), i0, g);
  uint32_t a[RG][4];
  const uint32_t plane = static_cast<uint32_t>(b * g.nh + h) *
                         static_cast<uint32_t>(g.T * g.T);
  prob_frags<RG>(a, s, i0, plane, g, drop);
  const int H = g.nh * g.dh;
  product_store<RG>(a, ops + 2 * tile, k.ld, ks * steps / k.KS,
                    (ks + 1) * steps / k.KS, rg,
                    out + static_cast<size_t>(b) * g.T * H + h * g.dh, H,
                    g.T, g.dh);
}

// One (row b, head h) tile of the backward (one body for both editions):
// warp (rg, ks) recomputes row group rg's probabilities and dp, forms ds,
// adds its unscaled f32 value into the dbias accumulators (ks == 0 in the
// dbias edition: acc in registers, sm.da above T = 64), stores its column
// share of dq, stages ds and pd, then stores its share of dk and dv for
// the key rows of group rg.
template <int RG, bool kDbias>
__device__ __forceinline__ void bwd_tile_mma(const bf16* ops,
                                             const MmaSmem& sm,
                                             float (&acc)[2 * RG][4],
                                             const float* __restrict__ bias,
                                             bf16* __restrict__ dqkv, int b,
                                             int h, const Geometry& g,
                                             const Blocking& k,
                                             const Drop& drop) {
  const int warp = threadIdx.x >> 5, rg = warp / k.KS, ks = warp % k.KS;
  const int q = threadIdx.x & 3, i0 = 16 * rg + ((threadIdx.x & 31) >> 2);
  const int tile = k.Tp * k.ld, steps = k.Dp / 16, live = live_tiles(g);
  const int k0 = ks * steps / k.KS, k1 = (ks + 1) * steps / k.KS;
  const bf16* Q = ops;
  const bf16* K = ops + tile;
  const bf16* V = ops + 2 * tile;
  const bf16* O = ops + 3 * tile;
  float s[2 * RG][4], dp[2 * RG][4];
  scores_mma<RG>(Q, K, k.ld, rg, k0, k1, live, s);
  scores_mma<RG>(O, V, k.ld, rg, k0, k1, live, dp);
  if (k.KS > 1) {
    float* red_dp = sm.red + k.KS * k.RG * 16 * k.Tp;
    write_partial<RG>(s, sm.red, rg, ks);
    write_partial<RG>(dp, red_dp, rg, ks);
    __syncthreads();
    read_sum<RG>(s, sm.red, rg, k.KS);
    read_sum<RG>(dp, red_dp, rg, k.KS);
  }
  softmax_frag<RG>(s, bias_row(bias, b, h, g), i0, g);
  const uint32_t plane = static_cast<uint32_t>(b * g.nh + h) *
                         static_cast<uint32_t>(g.T * g.T);
  // dp dropped with the forward's mask, and dot = rowsum(dp * p); bit
  // 4 n + e of `dropped_bits` marks a dropped element, for pd below
  float dot[2] = {0.f, 0.f};
  uint64_t dropped_bits = 0;
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) {
    if (n >= live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, j = 8 * n + 2 * q + (e & 1);
      if (drop.on() && i < g.T && j < g.T) {
        if (drop.keep(plane + i * g.T + j)) {
          dp[n][e] *= drop.scale;
        } else {
          dp[n][e] = 0.f;
          dropped_bits |= 1ull << (4 * n + e);
        }
      }
      dot[e >> 1] = fmaf(dp[n][e], s[n][e], dot[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dot[r] += __shfl_xor_sync(~0u, dot[r], 1);
    dot[r] += __shfl_xor_sync(~0u, dot[r], 2);
  }
  // ds = p (dp - dot): into dbias unscaled, as dq's A operand * scale in
  // bf16; ds and pd staged for the transposed products (dead key tiles:
  // zero operands, nothing staged, their columns only reach key rows that
  // are never stored)
  uint32_t a[RG][4];
#pragma unroll
  for (int kb = 0; kb < RG; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 2 * kb + (r >> 1), hh = r & 1, i = i0 + 8 * hh;
      a[kb][r] = 0u;
      if (n >= live) continue;
      float x[2], y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * hh + c, j = 8 * n + 2 * q + c;
        const float ds = i < g.T ? s[n][e] * (dp[n][e] - dot[hh]) : 0.f;
        if (kDbias && ks == 0) {
          if constexpr (RG <= 4)
            acc[n][e] += ds;
          else
            sm.da[i * k.Tp + j] += ds;
        }
        x[c] = ds * g.scale;
        // pd: cast, dropped as dp was, cast again (zero in padded rows)
        const float v =
            round_to<bf16>(s[n][e]) * (drop.on() ? drop.scale : 1.f);
        y[c] = i >= g.T || (dropped_bits >> (4 * n + e) & 1) ? 0.f : v;
      }
      a[kb][r] = pack_bf16(x[0], x[1]);
      if (ks == 0) {
        const int at = i * k.ldt + 8 * n + 2 * q;
        *reinterpret_cast<uint32_t*>(sm.ds + at) = a[kb][r];
        *reinterpret_cast<uint32_t*>(sm.pd + at) = pack_bf16(y[0], y[1]);
      }
    }
  const int H = g.nh * g.dh, c0 = k0, c1 = k1;   // column share = k share
  const size_t rs = 3 * static_cast<size_t>(H);
  bf16* base = dqkv + static_cast<size_t>(b) * g.T * rs + h * g.dh;
  product_store<RG>(a, K, k.ld, c0, c1, rg, base, rs, g.T, g.dh);   // dq
  __syncthreads();   // ds and pd staged
  transposed_frags<RG>(a, sm.ds, k.ldt, rg);
  product_store<RG>(a, Q, k.ld, c0, c1, rg, base + H, rs, g.T, g.dh);   // dk
  transposed_frags<RG>(a, sm.pd, k.ldt, rg);
  product_store<RG>(a, O, k.ld, c0, c1, rg, base + 2 * H, rs, g.T,
                    g.dh);   // dv
}

// grid: persistent blocks walking tiles t = b * nh + h with stride gridDim.x
template <int RG>
__global__ void __launch_bounds__(32 * (RG > 4 ? RG : 4))
    mha_fwd_mma_kernel(const bf16* __restrict__ qkv,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int B, Geometry g, Blocking k, Drop drop) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const MmaSmem sm = carve(mma_smem, k, kFwd);
  const bool vec = g.dh % 8 == 0 && aligned16(qkv);
  zero_smem(sm.ops, sizeof(bf16) * k.buffers * k.operand_elems);
  __syncthreads();
  walk(
      blockIdx.x, B * g.nh, gridDim.x, k, sm.ops,
      [&](int t, bf16* dst) {
        load_tile(qkv, nullptr, t / g.nh, t % g.nh, g, k, dst, vec);
      },
      [&](int t, const bf16* ops) {
        fwd_tile_mma<RG>(ops, sm.red, bias, out, t / g.nh, t % g.nh, g, k,
                         drop);
      });
}

// grid: persistent blocks walking tiles as the forward's; the dbias
// edition: block (chunk, p, h) walks rows i * P + p for i in its chunk's
// share of the B / P rows, in order, and writes its partial plane at
// ((chunk * P + p) * nh + h) for a bias per head, at ((chunk * nh + h) * P
// + p) for a bias shared by the heads (as mha_bwd_dbias_kernel)
template <int RG, bool kDbias>
__global__ void __launch_bounds__(32 * (RG > 4 ? RG : 4),
                                  kDbias && RG <= 4 ? 3 : 1)
    mha_bwd_mma_kernel(const bf16* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                       float* __restrict__ part, int B, int chunks,
                       Geometry g, Blocking k, Drop drop) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const MmaSmem sm = carve(mma_smem, k, kDbias ? kBwdDbias : kBwd);
  const bool vec = g.dh % 8 == 0 && aligned16(qkv) && aligned16(dout);
  int first = blockIdx.x, end = B * g.nh, step = gridDim.x;
  int hd = 0, p = 0, chunk = 0;
  if (kDbias) {
    hd = blockIdx.x % g.nh;
    p = blockIdx.x / g.nh % g.P;
    chunk = blockIdx.x / (g.nh * g.P);
    const int rows = B / g.P, per = (rows + chunks - 1) / chunks;
    first = chunk * per;
    end = min(rows, first + per);
    step = 1;
  }
  auto row_of = [&](int it) { return kDbias ? it * g.P + p : it / g.nh; };
  auto head_of = [&](int it) { return kDbias ? hd : it % g.nh; };
  zero_smem(sm.ops, sizeof(bf16) * k.buffers * k.operand_elems);
  if (kDbias && RG > 4) zero_smem(sm.da, sizeof(float) * k.Tp * k.Tp);
  float acc[2 * RG][4];
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  __syncthreads();
  walk(
      first, end, step, k, sm.ops,
      [&](int it, bf16* dst) {
        load_tile(qkv, dout, row_of(it), head_of(it), g, k, dst, vec);
      },
      [&](int it, const bf16* ops) {
        bwd_tile_mma<RG, kDbias>(ops, sm, acc, bias, dqkv, row_of(it),
                                 head_of(it), g, k, drop);
      });
  if (!kDbias) return;
  const size_t slot =
      g.bias_sh == 0 ? (static_cast<size_t>(chunk) * g.nh + hd) * g.P + p
                     : (static_cast<size_t>(chunk) * g.P + p) * g.nh + hd;
  float* out = part + slot * g.T * g.T;
  if constexpr (RG <= 4) {
    // the warps of split 0 own every (i, j) of their row groups
    const int warp = threadIdx.x >> 5, q = threadIdx.x & 3;
    if (warp % k.KS) return;
    const int i0 = 16 * (warp / k.KS) + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int n = 0; n < 2 * RG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e >> 1) * 8, j = 8 * n + 2 * q + (e & 1);
        if (i < g.T && j < g.T) out[i * g.T + j] = acc[n][e];
      }
  } else {
    // every element of sm.da was last written before walk's final barrier
    for (int idx = threadIdx.x; idx < g.T * g.T; idx += blockDim.x)
      out[idx] = sm.da[idx / g.T * k.Tp + idx % g.T];
  }
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

// the shared memory a block of the dtype's body needs
size_t smem_bytes(int T_, int dh, int edition, int dtype) {
  if (dtype == kBF16) return choose_blocking(T_, dh, edition).smem;
  return edition == kFwd   ? fwd_smem_bytes(T_, dh)
         : edition == kBwd ? bwd_smem_bytes(T_, dh)
                           : dbias_smem_bytes(T_, dh);
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

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return std::max(n, 1);
}

// f(std::integral_constant<int, RG>) for RG = 1..8, the tile's row groups
template <typename F>
cudaError_t with_rg(int RG, F f) {
  switch (RG) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

// Opts the kernel into its shared memory and gives the blocks all SMs hold
// at once, the persistent grid's one wave; remembered for each (kernel,
// shared memory), so that a launch makes no more runtime queries than it
// must (the library's kernels run on device 0). A kernel's opt-in is one
// value for all its launches: it only ever grows, to the largest shared
// memory asked for, or a launch remembered earlier would be refused.
template <typename K>
cudaError_t resident(K kernel, const Blocking& k, int* slots) {
  struct Seen {
    const void* fn;
    size_t smem;
    int slots;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t opted = k.smem;
  for (int e = 0; e < n_seen; ++e) {
    if (seen[e].fn != fn) continue;
    if (seen[e].smem == k.smem) {
      *slots = seen[e].slots;
      return cudaSuccess;
    }
    opted = std::max(opted, seen[e].smem);
  }
  cudaError_t err = allow_smem(kernel, opted);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * k.warps, k.smem);
  if (err != cudaSuccess) return err;
  *slots = std::max(per_sm, 1) * sm_count();
  if (n_seen < 64) seen[n_seen++] = {fn, k.smem, *slots};
  return cudaSuccess;
}

cudaError_t launch_fwd_mma(const void* qkv, const float* bias, void* out,
                           int B, const Geometry& g, const Blocking& k,
                           Drop drop, cudaStream_t stream) {
  return with_rg(k.RG, [&](auto rg) {
    auto kernel = mha_fwd_mma_kernel<decltype(rg)::value>;
    int slots = 0;
    cudaError_t err = resident(kernel, k, &slots);
    if (err != cudaSuccess) return err;
    kernel<<<std::min(B * g.nh, slots), 32 * k.warps, k.smem, stream>>>(
        static_cast<const bf16*>(qkv), bias, static_cast<bf16*>(out), B, g,
        k, drop);
    return cudaGetLastError();
  });
}

// chunks = 0: the edition without dbias, a persistent grid over the tiles
cudaError_t launch_bwd_mma(const void* qkv, const float* bias,
                           const void* dout, void* dqkv, float* part, int B,
                           int chunks, const Geometry& g, const Blocking& k,
                           Drop drop, cudaStream_t stream) {
  return with_rg(k.RG, [&](auto rg) {
    constexpr int R = decltype(rg)::value;
    auto kernel = chunks > 0 ? mha_bwd_mma_kernel<R, true>
                             : mha_bwd_mma_kernel<R, false>;
    int slots = 0;
    cudaError_t err = resident(kernel, k, &slots);
    if (err != cudaSuccess) return err;
    const int grid = chunks > 0 ? chunks * g.P * g.nh
                                : std::min(B * g.nh, slots);
    kernel<<<grid, 32 * k.warps, k.smem, stream>>>(
        static_cast<const bf16*>(qkv), bias, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), part, B, chunks, g, k, drop);
    return cudaGetLastError();
  });
}

// the non-empty shares of `rows` rows that `chunks` asks for
int normalised(int rows, int chunks) {
  const int per = (rows + chunks - 1) / chunks;
  return (rows + per - 1) / per;
}

// Chunks of the dbias edition: how many shares the B / P rows of each
// (bias row, head) are cut into, one block each. bf16: the count that
// minimises waves x (rows a block walks + 2), the 2 standing for the
// partial plane it writes and the sum reads back (about two rows' bytes),
// with `slots` the blocks the SMs hold at once. float32: about eight waves
// of the four blocks an SM holds, as before.
int dbias_chunks(int B, int P, int nh, int dtype, int slots) {
  const int rows = B / P, cells = P * nh;
  if (dtype != kBF16)
    return normalised(
        rows, std::max(1, std::min(rows, (32 * sm_count() + cells - 1) /
                                             cells)));
  int best = 1;
  long long best_cost = LLONG_MAX;
  const int most = std::min(rows, std::max(1, 16 * slots / cells));
  for (int c = 1; c <= most; ++c) {
    if (normalised(rows, c) != c) continue;
    const long long per = (rows + c - 1) / c;
    const long long waves =
        (static_cast<long long>(c) * cells + slots - 1) / slots;
    if (waves * (per + 2) < best_cost) {
      best_cost = waves * (per + 2);
      best = c;
    }
  }
  return best;
}

}  // namespace
}  // namespace idvs

// bias: mode 0 -> (B, T) key mask; mode 1 -> additive bias whose element
// (row, head, i, j) sits at (row % P) * bias_sp + head * bias_sh + i * T + j
// (bias_sh = 0 shares one (T, T) plane across heads). Float either way: the
// wrapper has already rounded it through the compute dtype. Dropout:
// drop_key = mix32(seed), drop_thresh = 0 for none (dropout.cuh); the
// element index of probability (row, head, i, j) is ((row*nh + head)*T +
// i)*T + j. dtype picks the body: float32 scalar, bf16 tensor cores.
extern "C" int idvs_fused_mha_fwd(const void* qkv, const void* bias,
                                  void* out, int B, int T_, int nh, int dh,
                                  int mode, int P, long long bias_sp,
                                  long long bias_sh, float scale,
                                  unsigned drop_key, unsigned drop_thresh,
                                  float drop_scale, int dtype, void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, mode, P, bias_sp, bias_sh, scale};
  const Drop drop{drop_key, drop_thresh, drop_scale};
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const size_t smem = fwd_smem_bytes(T_, dh);
    if (!valid(B, g, smem)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_fwd<float>(qkv, b, out, B, g, drop, smem,
                                              s));
  }
  if (dtype == kBF16) {
    const Blocking k = choose_blocking(T_, dh, kFwd);
    if (!valid(B, g, k.smem)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_fwd_mma(qkv, b, out, B, g, k, drop, s));
  }
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
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const size_t smem = bwd_smem_bytes(T_, dh);
    if (!valid(B, g, smem)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bwd<float>(qkv, b, dout, dqkv, B, g, drop,
                                              smem, s));
  }
  if (dtype == kBF16) {
    const Blocking k = choose_blocking(T_, dh, kBwd);
    if (!valid(B, g, k.smem)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bwd_mma(qkv, b, dout, dqkv, nullptr, B, 0,
                                           g, k, drop, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dbias edition of idvs_fused_mha_bwd, additive bias (mode 1) only: also
// writes the partial planes of the unscaled f32 softmax backward summed over
// the rows r with r % P = p, chunks * nh * P * T * T floats into part (see
// mha_bwd_dbias_kernel for their order); idvs_sum_partials then adds the
// chunks in a fixed order. P divides B, and chunks is
// idvs_fused_mha_dbias_chunks' for the same arguments.
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
  const size_t smem = smem_bytes(T_, dh, kBwdDbias, dtype);
  if (!valid(B, g, smem) || B % P || chunks < 1 || chunks > B / P)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_bwd_dbias<float>(qkv, b, dout, dqkv, pt, B,
                                                    chunks, g, drop, smem, s));
  if (dtype == kBF16)
    return static_cast<int>(launch_bwd_mma(
        qkv, b, dout, dqkv, pt, B, chunks, g,
        choose_blocking(T_, dh, kBwdDbias), drop, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of shared memory a block of edition (0 forward, 1 backward, 2 the
// dbias edition) needs at (T, dh) in the dtype's body (INT_MAX at most);
// the wrapper refuses what does not fit 227 KB.
extern "C" int idvs_fused_mha_smem(int T_, int dh, int edition, int dtype) {
  using namespace idvs;
  if (T_ < 1 || dh < 1 || edition < kFwd || edition > kBwdDbias) return -1;
  return static_cast<int>(
      std::min<size_t>(smem_bytes(T_, dh, edition, dtype), INT_MAX));
}

// The chunks the dbias edition cuts each (bias row, head)'s B / P rows
// into (dbias_chunks), or a negative CUDA error.
extern "C" int idvs_fused_mha_dbias_chunks(int B, int T_, int nh, int dh,
                                           int P, int dtype) {
  using namespace idvs;
  if (B < 1 || P < 1 || B % P || nh < 1 || T_ < 1 || T_ > 128 || dh < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  if (dtype == kBF16) {
    const Blocking k = choose_blocking(T_, dh, kBwdDbias);
    if (k.smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = with_rg(k.RG, [&](auto rg) {
      return resident(mha_bwd_mma_kernel<decltype(rg)::value, true>, k,
                      &slots);
    });
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return dbias_chunks(B, P, nh, dtype, slots);
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

// Multi-head self-attention over packed (B, T, 3H) QKV for short sequences
// (T <= 128): the forward and its backward, and the backward's dbias
// edition for a trainable additive bias. The bodies are chosen by the
// compute dtype in each entry point: bf16 on the tensor cores
// (mha_*_mma_kernel); float32 forward on the tensor cores as 3xTF32
// (mha_fwd_tf32_kernel); float32 backward in scalar float FMAs
// (mha_bwd_kernel, mha_bwd_dbias_kernel).
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
// The bf16 body (its device code in mha_mma.cuh, which win_attn_bwd.cu
// shares for the windowed attention's backward):
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
// The float32 forward (text encode and both recommends serve in float32):
// bf16's structure with float tiles, and both products as 3xTF32 on
// mma.sync m16n8k8 (mma.cuh: each operand split into big + small tf32
// terms, small.big + big.small + big.big; plain TF32's 10 mantissa bits
// are too few for the float32 parity held here). Each k-step's three
// products go into zeroed sums that are added to the running sums by float
// adds, as gemm.cu's float32 body does. The work is bound by bytes at every
// main-path shape (text encode: 0.014 ms of operations at 67 TFLOP/s
// against 0.038 ms of bytes), so what counts is what the bf16 body fixed:
// - q, k and v as float [T][Dp + 8] planes copied by 16-byte cp.async (or
//   plain loads where a row is not 16-byte aligned), rows past T not kept
//   (a fragment read of such a row gives zeros) and columns past dh zeros,
//   so a tile takes at most 12 (Dp + 8) bytes a token: every (T, dh) the
//   scalar body it replaced launched still fits. A row of 8 mod 16
//   floats keeps the float2 fragment reads of q and k conflict-free; v's
//   reads walk rows 2q and 2q + 1, which an XOR of column bit 3 by row bit
//   2 spreads over the banks.
// - A warp owns 16 query rows; the scores, the softmax (expf), the dropout
//   (dropout.cuh's hash at the element index) and the probabilities stay in
//   registers, and the score accumulators are pd v's A operand as they
//   are: key 2q of a k-step is fragment column q and key 2q + 1 column
//   q + 4, so B reads v's rows 2q and 2q + 1 (q k's columns are paired the
//   same way, one float2 a fragment pair).
// - Blocking (choose_f32): Tp / 16 row groups; fewer than eight of wide
//   heads (SASRec, dh 256 and 1024) split each KS ways as bf16 does, up to
//   eight warps. Blocks are persistent, one wave, one buffer each; each
//   tile is two copy groups, q and k then v, so the scores start while v
//   lands, the next q and k go out once the scores are done and the next v
//   once the output is stored. At text encode's shape (T 30, dh 64) that
//   beat two buffers, the bf16 body's way, 0.073 ms to 0.103 (PERF.md):
//   the smaller block lets twice the blocks onto an SM. Where three planes
//   do not fit (T 64 at dh 256), v is copied into q's plane after the
//   scores.
// The float32 backward (only the float32 gradient checks reach it) stays
// on the scalar body: one block holds one (row, head) tile of q, k, v and
// dout and the (T, T) planes in shared memory (rows padded by one float to
// keep the column walks conflict-free), reads qkv and dout in their
// natural layouts and writes the packed dqkv directly, in scalar float
// FMAs with a __syncthreads between stages. It recomputes p in its own
// sums, which differ from the forward's 3xTF32 sums in the last bits,
// within float32's tolerance. Its dbias edition walks the rows of block
// (chunk, p, head) as above with the sum in a shared (T, T) plane.
// SASRec's dh = 256 at T = 20 needs ~82 KB in backward, so these kernels
// opt into dynamic shared memory above 48 KB.
#include <initializer_list>

#include "mha_mma.cuh"
#include "mha_tile.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

constexpr int kMhaThreads = 128;

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

// ---- float32 forward on the tensor cores (3xTF32) --------------------------

// How a float32 forward launch is cut (choose_f32, the one place it is
// decided); sizes in floats unless named bytes.
struct F32Blocking {
  int Tp, Dp;         // T rounded up to 16 (row groups), dh to 16 (k-steps)
  int ld;             // row stride of a plane: Dp + 8, 8 mod 16 floats
  int RG, KS, warps;  // row groups of 16 query rows, splits of each, warps
  int planes;         // 3: q, k, v; 2: v copied into q's plane after the scores
  int plane;          // floats of one [T][ld] plane (rows past T not kept)
  int vsw;            // v's column swizzle: 8 with three planes, else 0
  size_t smem;        // dynamic shared memory of a block, bytes
};

constexpr int kF32Warps = 8;   // at most, RG * KS

F32Blocking choose_f32(int T, int dh) {
  F32Blocking k;
  k.Tp = (T + 15) / 16 * 16;
  k.Dp = (dh + 15) / 16 * 16;
  k.ld = k.Dp + 8;
  k.RG = k.Tp / 16;
  k.plane = T * k.ld;
  // fewer than eight row groups of wide heads (SASRec): up to eight warps a
  // tile, each at least 32 columns of the head
  const int want =
      k.RG < kF32Warps && k.Dp >= 128 ? std::min(kF32Warps / k.RG, k.Dp / 32)
                                      : 1;
  for (int ks : {want, 1}) {
    k.KS = ks;
    k.warps = k.RG * ks;
    // [KS][RG][Tp / 8 tiles][32 lanes][4] partial scores
    const size_t rest = ks > 1 ? sizeof(float) * ks * k.RG * 16 * k.Tp : 0;
    k.planes = sizeof(float) * 3 * k.plane + rest <= kMaxSmem ? 3 : 2;
    k.smem = sizeof(float) * k.planes * k.plane + rest;
    if (k.smem <= kMaxSmem) break;
  }
  k.vsw = k.planes == 3 ? 8 : 0;
  return k;
}

// Copies plane p (0 q, 1 k, 2 v) of tile (row b, head h) into dst, a [T][ld]
// plane, column d of token t at t * ld + (d ^ sw(t)), sw(t) = vsw on rows
// with bit 2 set: 16-byte cp.async copies where every row is 16-byte
// aligned (vec), else plain loads. Columns >= dh are never written.
__device__ __forceinline__ void copy_plane(const float* __restrict__ qkv,
                                           int b, int h, int p, float* dst,
                                           int vsw, const Geometry& g,
                                           const F32Blocking& k, bool vec) {
  const int H = g.nh * g.dh;
  const float* src =
      qkv + static_cast<size_t>(b) * g.T * 3 * H + p * H + h * g.dh;
  const int cpr = g.dh / 4;   // 16-byte chunks a row
  if (vec && static_cast<int>(blockDim.x) % cpr == 0) {
    // each thread copies one chunk column of every step-th row
    const int c = threadIdx.x % cpr * 4, step = blockDim.x / cpr;
    for (int t = threadIdx.x / cpr; t < g.T; t += step)
      cp_async16(dst + t * k.ld + (c ^ (t & 4 ? vsw : 0)),
                 src + static_cast<size_t>(t) * 3 * H + c);
  } else if (vec) {
    for (int idx = threadIdx.x; idx < g.T * cpr; idx += blockDim.x) {
      const int t = idx / cpr, c = idx % cpr * 4;
      cp_async16(dst + t * k.ld + (c ^ (t & 4 ? vsw : 0)),
                 src + static_cast<size_t>(t) * 3 * H + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < g.T * g.dh; idx += blockDim.x) {
      const int t = idx / g.dh, d = idx % g.dh;
      dst[t * k.ld + (d ^ (t & 4 ? vsw : 0))] =
          src[static_cast<size_t>(t) * 3 * H + d];
    }
  }
}

// a float2 of a plane's row, zeros past the T rows it keeps
__device__ __forceinline__ float2 row_pair(const float* plane, int row,
                                           int col, int T, int ld) {
  return row < T ? *reinterpret_cast<const float2*>(plane + row * ld + col)
                 : make_float2(0.f, 0.f);
}

// The 3xTF32 product of one m16n8k8 step into the running sums c: the
// step's small.big + big.small + big.big into zeroed sums d (the tensor
// cores' accumulation is no float sum, gemm.cu's header), then c += d by
// float adds
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// s = rows [16 rg, 16 rg + 16) of q times kᵀ over the 8-column k-steps
// [k0, k1) and the live key tiles. Within a k-step, fragment column q
// (lane % 4) is the head's column 2q and column q + 4 is 2q + 1, for A and
// B alike, so each is one float2 (the sum over the head's columns does
// not mind their order); ld = 8 mod 16 keeps those loads conflict-free.
template <int RG>
__device__ __forceinline__ void scores_tf32(const float* Q, const float* K,
                                            int ld, int T, int rg, int k0,
                                            int k1, int live,
                                            float (&s)[2 * RG][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const int r0 = 16 * rg + g;
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = k0; kk < k1; ++kk) {
    const int col = 8 * kk + 2 * q;
    const float2 lo = row_pair(Q, r0, col, T, ld);
    const float2 hi = row_pair(Q, r0 + 8, col, T, ld);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
    for (int n = 0; n < 2 * RG; ++n) {
      if (n < live) {
        const float2 kv = row_pair(K, 8 * n + g, col, T, ld);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
        mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// out = pd v for the output columns of the 8-wide tiles [c0, c1), 4 tiles
// at a time: pd (the probabilities after dropout, zero in padded rows and
// keys) is A straight from the score accumulators, key 2q of a k-step's 8
// as fragment column q and key 2q + 1 as column q + 4, so B reads v's
// rows 2q and 2q + 1 (v's column swizzle keeps those reads conflict-free
// in a three-plane buffer). Row i of the tile stored at out + i * H.
template <int RG>
__device__ __forceinline__ void product_store_tf32(
    const float (&p)[2 * RG][4], const float* V, const F32Blocking& k,
    int T, int live, int rg, int c0, int c1, float* __restrict__ out, int H,
    int dh) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const int i0 = 16 * rg + g;
  const bool pairs = dh % 2 == 0;
  for (int cb = c0; cb < c1; cb += 4) {
    float o[4][4] = {};
#pragma unroll
    for (int kb = 0; kb < 2 * RG; ++kb) {
      if (kb >= live) continue;
      const float a[4] = {p[kb][0], p[kb][2], p[kb][1], p[kb][3]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
      const int j = 8 * kb + 2 * q, sw = j & 4 ? k.vsw : 0;
      const float* v0 = V + j * k.ld;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (cb + t < c1) {
          const int col = (8 * (cb + t) + g) ^ sw;
          const float x0 = j < T ? v0[col] : 0.f;
          const float x1 = j + 1 < T ? v0[k.ld + col] : 0.f;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(x0, bb0, bs0);
          split_tf32(x1, bb1, bs1);
          mma_3xtf32(o[t], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = 8 * (cb + t) + 2 * q;
      if (cb + t >= c1 || col >= dh) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i >= T) continue;
        float* row = out + static_cast<size_t>(i) * H + col;
        if (pairs) {
          *reinterpret_cast<float2*>(row) =
              make_float2(o[t][2 * hh], o[t][2 * hh + 1]);
        } else {
          row[0] = o[t][2 * hh];
          if (col + 1 < dh) row[1] = o[t][2 * hh + 1];
        }
      }
    }
  }
}

// grid: persistent blocks walking tiles t = b * nh + h with stride
// gridDim.x; warp (rg, ks) holds row group rg's scores over its share ks
// of the head's columns (the KS partial sums added in a fixed order
// through shared memory), then computes and stores its share of the
// output columns. One buffer, two copy groups a tile in flight: with three
// planes the next tile's q and k go out once this tile's scores are done
// and its v once this tile's output is stored, so the scores start while
// v lands and each tile's copies overlap the last one's work; with two
// planes v goes into q's plane once the scores are done.
template <int RG>
__global__ void __launch_bounds__(32 * kF32Warps)
    mha_fwd_tf32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int B, Geometry g,
                        F32Blocking k, Drop drop) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* Q = reinterpret_cast<float*>(f32_smem);
  float* K = Q + k.plane;
  float* V = k.planes == 3 ? K + k.plane : Q;
  float* red = Q + k.planes * k.plane;
  const int end = B * g.nh;
  int it = blockIdx.x;
  if (it >= end) return;
  const bool vec = g.dh % 4 == 0 && aligned16(qkv);
  const int warp = threadIdx.x >> 5, rg = warp / k.KS, ks = warp % k.KS;
  const int i0 = 16 * rg + ((threadIdx.x & 31) >> 2), q = threadIdx.x & 3;
  const int steps = k.Dp / 8, live = live_tiles(g), H = g.nh * g.dh;
  const int k0 = ks * steps / k.KS, k1 = (ks + 1) * steps / k.KS;
  zero_smem(Q, sizeof(float) * k.planes * k.plane);
  __syncthreads();
  auto copy_qk = [&](int t) {
    copy_plane(qkv, t / g.nh, t % g.nh, 0, Q, 0, g, k, vec);
    copy_plane(qkv, t / g.nh, t % g.nh, 1, K, 0, g, k, vec);
    cp_async_commit();
  };
  auto copy_v = [&](int t) {
    copy_plane(qkv, t / g.nh, t % g.nh, 2, V, k.vsw, g, k, vec);
    cp_async_commit();
  };
  copy_qk(it);
  if (k.planes == 3) copy_v(it);
  for (; it < end; it += gridDim.x) {
    const int nxt = it + gridDim.x, b = it / g.nh, h = it % g.nh;
    if (k.planes == 3)
      cp_async_wait<1>();   // this tile's q and k; its v may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    float s[2 * RG][4];
    scores_tf32<RG>(Q, K, k.ld, g.T, rg, k0, k1, live, s);
    if (k.KS > 1) write_partial<RG>(s, red, rg, ks);
    __syncthreads();        // q and k read, the partials written
    if (k.KS > 1) read_sum<RG>(s, red, rg, k.KS);
    if (k.planes == 2)
      copy_v(it);
    else if (nxt < end)
      copy_qk(nxt);
    softmax_frag<RG, true>(s, bias_row(bias, b, h, g), i0, g);
    // dropout on the probabilities at their element index; padded query
    // rows zero (padded keys are zero already)
    const uint32_t plane = static_cast<uint32_t>(it) *
                           static_cast<uint32_t>(g.T * g.T);
#pragma unroll
    for (int n = 0; n < 2 * RG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1), j = 8 * n + 2 * q + (e & 1);
        if (i >= g.T)
          s[n][e] = 0.f;
        else if (n < live && j < g.T)
          s[n][e] = drop.apply(s[n][e], plane + i * g.T + j);
      }
    if (k.planes == 3 && nxt < end)
      cp_async_wait<1>();   // this tile's v; the next q and k may fly on
    else
      cp_async_wait<0>();
    __syncthreads();
    product_store_tf32<RG>(s, V, k, g.T, live, rg, k0, k1,
                           out + static_cast<size_t>(b) * g.T * H + h * g.dh,
                           H, g.dh);
    __syncthreads();        // this tile's planes read
    if (nxt < end) {
      if (k.planes == 3)
        copy_v(nxt);
      else
        copy_qk(nxt);
    }
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

// One (row b, head h) tile of the forward; warp (rg, ks) holds row group
// rg's scores and stores its share ks of the output columns.
template <int RG>
__device__ __forceinline__ void fwd_tile_mma(const bf16* ops, float* red,
                                             const float* __restrict__ bias,
                                             bf16* __restrict__ out,
                                             const int* off, int b, int h,
                                             const Geometry& g,
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
                    (ks + 1) * steps / k.KS, rg, out + h * g.dh, H,
                    static_cast<long long>(b) * g.T, off, g.T, g.dh);
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
  const TokenMap rows{};   // a tile is T consecutive rows
  fill_offsets(sm.off, rows, g, k);
  zero_smem(sm.ops, sizeof(bf16) * k.buffers * k.operand_elems);
  __syncthreads();
  walk(
      blockIdx.x, B * g.nh, gridDim.x, k, sm.ops,
      [&](int t, bf16* dst) {
        load_tile(qkv, nullptr, t / g.nh, t % g.nh, g, k, dst, vec, rows,
                  sm.off);
      },
      [&](int t, const bf16* ops) {
        fwd_tile_mma<RG>(ops, sm.red, bias, out, sm.off, t / g.nh, t % g.nh,
                         g, k, drop);
      });
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
  return edition == kFwd   ? choose_f32(T_, dh).smem
         : edition == kBwd ? bwd_smem_bytes(T_, dh)
                           : dbias_smem_bytes(T_, dh);
}

bool valid(int B, const Geometry& g, size_t smem) {
  return B >= 1 && g.T >= 1 && g.T <= 128 && g.nh >= 1 && g.dh >= 1 &&
         smem <= kMaxSmem && (g.mode == 0 || (g.mode == 1 && g.P >= 1));
}

cudaError_t launch_fwd_tf32(const void* qkv, const float* bias, void* out,
                            int B, const Geometry& g, const F32Blocking& k,
                            Drop drop, cudaStream_t stream) {
  return with_rg(k.RG, [&](auto rg) {
    auto kernel = mha_fwd_tf32_kernel<decltype(rg)::value>;
    int slots = 0;
    cudaError_t err = resident(kernel, k, &slots);
    if (err != cudaSuccess) return err;
    kernel<<<std::min(B * g.nh, slots), 32 * k.warps, k.smem, stream>>>(
        static_cast<const float*>(qkv), bias, static_cast<float*>(out), B, g,
        k, drop);
    return cudaGetLastError();
  });
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
        static_cast<bf16*>(dqkv), nullptr, part, B, chunks, g, k, drop,
        TokenMap{});
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace idvs

// bias: mode 0 -> (B, T) key mask; mode 1 -> additive bias whose element
// (row, head, i, j) sits at (row % P) * bias_sp + head * bias_sh + i * T + j
// (bias_sh = 0 shares one (T, T) plane across heads). Float either way: the
// wrapper has already rounded it through the compute dtype. Dropout:
// drop_key = mix32(seed), drop_thresh = 0 for none (dropout.cuh); the
// element index of probability (row, head, i, j) is ((row*nh + head)*T +
// i)*T + j. dtype picks the body: float32 as 3xTF32, bf16, both on the
// tensor cores.
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
    const F32Blocking k = choose_f32(T_, dh);
    if (!valid(B, g, k.smem)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_fwd_tf32(qkv, b, out, B, g, k, drop, s));
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

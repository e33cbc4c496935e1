// Multi-head self-attention over packed (B, T, 3H) QKV for short sequences
// (T <= 128): the forward and its backward, and the backward's dbias
// edition for a trainable additive bias, all on the tensor cores. The
// compute dtype picks the body in each entry point: bf16 as mma.sync
// m16n8k16 tiles (mha_fwd_mma_kernel, mha_bwd_mma_kernel), float32 as
// 3xTF32 on mma.sync m16n8k8 (mha_fwd_tf32_kernel, mha_bwd_tf32_kernel).
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
// The float32 bodies (text encode and both recommends serve in float32, the
// two-stage steps' SASRec and the float32 gradient checks train in it):
// bf16's structure with float planes, every product as 3xTF32 on mma.sync
// m16n8k8 (mma.cuh: each operand split into big + small tf32 terms,
// small.big + big.small + big.big; plain TF32's 10 mantissa bits are too
// few for the float32 parity held here). Each k-step's three products go
// into zeroed sums that are added to the running sums by float adds, as
// gemm.cu's float32 body does. The work is bound by bytes at every
// main-path shape (text encode: 0.014 ms of operations at 67 TFLOP/s
// against 0.038 ms of bytes), so what counts is what the bf16 body fixed.
// The device code is mha_mma.cuh's, which win_attn_bwd.cu shares too; the
// float32 backward's launches sit in fused_mha_f32.cu, which nvcc compiles
// beside this file:
// - q, k, v (and dout) as float [T][Dp + 8] planes copied by 16-byte
//   cp.async (or plain loads where a row is not 16-byte aligned), rows past
//   T not kept (a fragment read of such a row gives zeros) and columns past
//   dh zeros. A row of 8 mod 16 floats keeps float2 row reads
//   conflict-free; reads of rows 2q and 2q + 1 at one column (the B operand
//   of a product over the keys or the queries) hit distinct banks through
//   an XOR of column bit 3 by row bit 2.
// - A warp owns 16 query rows; the scores, the softmax (expf), the dropout
//   (dropout.cuh's hash at the element index with the unpadded T) and the
//   probabilities stay in registers, and score-shaped accumulators are the
//   A operand of a product over the keys as they lie: key 2q of a k-step
//   is fragment column q and key 2q + 1 column q + 4 (the head's columns
//   of q k are paired the same way, one float2 a fragment pair).
// - Backward: the scores, the softmax, dp, the float32 softmax backward,
//   the dropout and ds form in registers; then, once every read of v is
//   over, ds * scale and pd go to float planes in v's region (grown to hold
//   them), and all three products read their A operand there (dq its rows,
//   dk and dv their transposes), so that neither array holds registers
//   during the products. Above four row groups, and in the window core's
//   edition, one plane takes ds, then pd; the window core also keeps its
//   dbias sums in a shared plane (as every edition does above T = 64; bf16
//   and the others keep them in registers). Those choices
//   (mha_mma.cuh staged_planes, acc_in_smem) let three of the window
//   core's blocks onto an SM at T = 49.
// - Blocking (choose_f32, the one place it is decided for every edition):
//   Tp / 16 row groups; fewer than eight of wide heads (SASRec, dh 256 and
//   1024) split each KS ways as bf16 does, up to eight warps, or none where
//   that does not fit. Blocks are persistent, one wave, one buffer each.
//   A k-step's 3xTF32 products go four independent tiles at a time
//   (tf32_rounds), so that no chain of three dependent products stalls the
//   tensor cores. The backward's blocks of up to four row groups are held
//   to 128 registers a thread (two blocks of eight warps an SM): at Swin-T's
//   T = 49 that lets three four-warp blocks onto an SM, which measured
//   faster than two blocks of unbounded registers (PERF.md, PR 20).
//   The forward copies each tile in two groups, q and k then v, so the
//   scores start while v lands, the next q and k go out once the scores are
//   done and the next v once the output is stored; at text encode's shape
//   (T 30, dh 64) that beat two buffers, the bf16 body's way, 0.073 ms to
//   0.103 (PERF.md): the smaller block lets twice the blocks onto an SM.
//   Where three planes do not fit (T 64 at dh 256), v is copied into q's
//   plane after the scores. The backward copies the next tile's four
//   planes once this tile is done. A tile takes at most 12 (forward) or 16
//   (backward) (Dp + 8) bytes a token. Where the backward's four planes do
//   not fit so (dh of 417 and more at T 16-33), it pads dh to 8 columns
//   only, its rows 4 or 0 floats further apart, unswizzled (mha_mma.cuh
//   kBwdLayouts): every (T, dh) that the scalar float32 bodies these
//   replaced took launches, the widest heads with bank conflicts.
#include "mha_mma.cuh"
#include "reduce.cuh"

namespace idvs {
namespace {

// The float32 forward. grid: persistent blocks walking tiles t = b * nh +
// h with stride gridDim.x; warp (rg, ks) holds row group rg's scores over
// its share ks of the head's columns (the KS partial sums added in a fixed order
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
  const size_t rs = 3 * static_cast<size_t>(H);
  // plane p (0 q, 1 k, 2 v) of tile t into dst
  auto copy = [&](int t, int p, float* dst, int sw) {
    copy_plane(qkv + p * H + t % g.nh * g.dh, rs,
               static_cast<long long>(t / g.nh) * g.T, nullptr, dst, sw, g.T,
               g.dh, k.Dp, k.ld, vec);
  };
  auto copy_qk = [&](int t) {
    copy(t, 0, Q, 0);
    copy(t, 1, K, 0);
    cp_async_commit();
  };
  auto copy_v = [&](int t) {
    copy(t, 2, V, k.vsw);
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
    scores_tf32<RG>(Q, K, k.ld, 0, g.T, rg, k0, k1, live, s);
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
    product_store_f32<RG>(RegFrags<RG>{s}, V, k.ld, k.vsw, g.T, live, rg, k0,
                          k1, out + h * g.dh, H,
                          static_cast<long long>(b) * g.T, nullptr, g.dh);
    __syncthreads();        // this tile's planes read
    if (nxt < end) {
      if (k.planes == 3)
        copy_v(nxt);
      else
        copy_qk(nxt);
    }
  }
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

// the shared memory a block of the dtype's body needs
size_t smem_bytes(int T_, int dh, int edition, int dtype) {
  return dtype == kBF16 ? choose_blocking(T_, dh, edition).smem
                        : choose_f32(T_, dh, edition).smem;
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

}  // namespace
}  // namespace idvs

// The float32 backward's entries, in fused_mha_f32.cu
extern "C" int idvs_fused_mha_bwd_f32(const void* qkv, const void* bias,
                                      const void* dout, void* dqkv,
                                      void* part, int B, int T_, int nh,
                                      int dh, int mode, int P, int chunks,
                                      long long bias_sp, long long bias_sh,
                                      float scale, unsigned drop_key,
                                      unsigned drop_thresh, float drop_scale,
                                      void* stream);
extern "C" int idvs_fused_mha_dbias_chunks_f32(int B, int T_, int nh, int dh,
                                               int P);

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
    const F32Blocking k = choose_f32(T_, dh, kFwd);
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
  if (dtype == kF32)
    return idvs_fused_mha_bwd_f32(qkv, bias, dout, dqkv, nullptr, B, T_, nh,
                                  dh, mode, P, 0, bias_sp, bias_sh, scale,
                                  drop_key, drop_thresh, drop_scale, stream);
  if (dtype == kBF16)
    return fused_mha_backward<bf16>(qkv, b, dout, dqkv, nullptr, B, 0, g,
                                    choose_blocking(T_, dh, kBwd), drop, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dbias edition of idvs_fused_mha_bwd, additive bias (mode 1) only: also
// writes the partial planes of the unscaled f32 softmax backward summed over
// the rows r with r % P = p, chunks * nh * P * T * T floats into part (see
// mha_bwd_mma_kernel for their order); idvs_sum_partials then adds the
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
  if (B < 1 || P < 1 || B % P || chunks < 1 || chunks > B / P)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return idvs_fused_mha_bwd_f32(qkv, bias, dout, dqkv, part, B, T_, nh, dh,
                                  1, P, chunks, bias_sp, bias_sh, scale,
                                  drop_key, drop_thresh, drop_scale, stream);
  if (dtype == kBF16)
    return fused_mha_backward<bf16>(qkv, b, dout, dqkv, pt, B, chunks, g,
                                    choose_blocking(T_, dh, kBwdDbias), drop,
                                    s);
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
  if (B < 1 || P < 1 || B % P || nh < 1 || T_ < 1 || T_ > 128 || dh < 1 ||
      (dtype != kF32 && dtype != kBF16))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) return idvs_fused_mha_dbias_chunks_f32(B, T_, nh, dh, P);
  return fused_mha_dbias_chunks(B, P, nh,
                                choose_blocking(T_, dh, kBwdDbias));
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

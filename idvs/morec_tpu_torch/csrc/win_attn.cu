// Windowed multi-head self-attention with its projections (Swin), forward:
//   qkv = cast(x @ Wqkv + bqkv)                 per window of T = w*w tokens
//   s   = f32(q . k) * dh^-1/2 + bias[window % P, head]
//   p   = cast(softmax_f32(s))
//   ctx = cast(f32(p . v))
//   out = cast(ctx @ Wo + bo)
// Each body (bf16, float32) takes the two index maps of win_map.cuh: the
// window layout reads window r from a (B, T, C) tensor; the band layout
// reads a window's tokens from the (N, Hp, Wp, C) feature map and writes
// them back there, so the window partition and its reverse never exist in
// device memory.
//
// Replaces idvs/morec_tpu/ops/pallas/attention.py _pfwd_kernel (reached
// through fused_mha_proj) and _bfwd_kernel (fused_mha_proj_band), bodies
// _p_proj and _p_attention. The TPU wrapper's 7 -> 8 window padding is a
// Mosaic constraint and is not carried over: its padded keys get -1e9 and
// its padded queries are sliced off, which equals the 49-token math done
// here. The bias arrives already cast to the compute dtype (and widened to
// float), as the TPU wrapper casts it.
//
// Bound on the H100: per window 8*T*C*C flops of projections against
// 4*T*T*C of attention, so at Swin's widths the projections are 95 % or
// more of the work: bound by operations in bf16 (0.12-0.18 ms a Swin-T
// stage for 512 images at 989 TFLOP/s, by bytes at stage 0) and in float32
// at 3xTF32's 165 TFLOP/s (0.74-0.90 ms a stage). Two launches: the
// window kernel writes each head's context into a scratch in x's layout,
// and the output projection, which sums over all heads, is a plain
// row-major product of that scratch through gemm.cu (idvs_gemm, with its
// bias epilogue): tensor-core tiles in bf16, 3xTF32 tiles in float32.
//
// bf16 (win_attn_mma_kernel), on the tensor cores. A block owns G windows
// and a group of HG heads; its plan (win_attn_plan in ops/cuda/attention.py,
// the one place it is decided; the host checks it) pads T to Tp and dh to
// Dp, multiples of 16, and lays out WM x WN warps. The qkv projection of
// the block's G * Tp rows (a window's rows at Tp-token strides, the tokens
// past T zeros) is mma.sync m16n8k16 bf16 with float accumulators
// (mma.cuh): x's rows come through the row index map by 16-byte cp.async,
// in 32-deep K slices with the head group's q, k and v columns of Wqkv
// (each head's dh columns zero-filled to Dp), through a ring of kStages
// stages; each warp owns a 32 x 48 tile, in passes of 32 WM rows. The cast
// qkv (bias added, padded columns exact zeros) stays in shared memory,
// [G Tp][3 HG Dp + 8]. Each warp then takes (window, head, 16 query rows)
// items: the scores against 64-key blocks are mma.sync tiles in
// registers, scaled and biased, keys past T at -inf before the float
// softmax (the padded queries are computed and dropped), which equals the
// 49-token math; the max and sum run online over the key blocks (one
// block up to T = 64, so the direct formula), the probabilities are cast
// and packed as the A operand of P . V (fused_mha.cu's trick), and the
// context goes to the scratch at the tokens' own rows. At T <= 64 the
// scores are computed once; above, once for the statistics and once more
// for P . V. Head groups keep a window's qkv inside a block's shared memory
// (451 KB for all heads at C = 768) and, with G, give the last stage (one
// window an image) thousands of blocks. Every division by a runtime width
// is done once a block, into a map from the block's q | k | v columns to
// Wqkv's (col_of): a first version that divided in the copy and epilogue
// loops took 3.87 ms at Swin-T stage 0 against 2.52 (bench_swin, PERF.md).
// Persistent blocks with the next tile's copies in flight during the
// attention were slower.
//
// float32 (win_attn_tf32_kernel), on the tensor cores as 3xTF32 (mma.cuh:
// each operand split into big + small tf32 terms, three m16n8k8 products a
// step; the scalar body it replaces ran the projections on the FMA units
// in 4 x 12 register tiles and lost to the plain version at stages 2 and 3,
// PERF.md). bf16's structure: the same plan function (win_attn_plan with
// the dtype; G windows, HG heads, Tp, Dp, a 32 x 48 projection tile a warp,
// at most 8 warps, the host checks it), the same row and column maps. The
// projection streams x's rows and Wqkv's head-group columns as floats in
// 16-deep slices (two k-steps) through a ring of 3 cp.async stages, its
// products summed a slice at a time into zeroed sums that float adds take
// to the accumulators (mma.cuh tf32_slice: each warp splits a Wqkv value
// once for its two m16 tiles and an x value once for its six n8 tiles);
// q, k and v stay floats in shared memory, [G Tp][3 HG Dp + 8] (8 mod 32
// floats a row, so the fragments' float2 reads hit distinct banks). The
// attention takes bf16's (window, head, 16 query rows) items: the scores
// against 64-key blocks as 3xTF32 tiles (q's and k's values split as they
// are read), the float softmax with expf, online over the key blocks, and
// P . V with the probabilities, as they lie in the score accumulators, as
// the A operand (fused_mha's float32 forward's fragment order), the context
// stored at the tokens' own rows. Every geometry the scalar body placed is
// placed (tests/test_torch_f32_plans.py), heads of 4 to 128 columns with
// them.
#include "common.cuh"
#include "mma.cuh"
#include "win_map.cuh"

namespace idvs {
namespace {

struct WinGeom {
  int windows, T, C, nh, dh;
  int P;                           // bias period: window r takes bias[r % P]
  long long bias_sp, bias_sh;      // bias strides of the period and the head
  int band;                        // 1: (N, Hp, Wp, C) map; 0: (B, T, C)
  int w, nwc, nwr;                 // window side, windows per row and column
  float scale;
};

// the row (in units of C elements) of token t of window widx; -1 beyond
__device__ __forceinline__ int token_row(const WinGeom& g, int widx, int t) {
  if (widx >= g.windows) return -1;
  return static_cast<int>(TokenMap{g.band, g.w, g.nwc, g.nwr}.row(widx, t,
                                                                   g.T));
}

// ---- bf16: mma.sync on the tensor cores -----------------------------------

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;              // of the projection's K-slice ring
constexpr int kSliceK = 32;             // depth of a K slice
constexpr int kLdA = kSliceK + 8;       // x rows of a slice, 16 bytes padded
constexpr int kMmaWarps = 16;           // at most, a block
constexpr int kWarpRows = 32, kWarpCols = 48;   // a warp's projection tile
constexpr int kKeys = 64;               // keys of a score block

// The block plan (win_attn_plan in ops/cuda/attention.py): G windows, HG
// heads, T and dh padded to Tp and Dp, WM x WN warps, passes of 32 WM rows
// over the G * Tp rows, shared-memory bytes.
struct MmaPlan {
  int G, HG, Tp, Dp, WM, WN, passes;
  long long smem;
};

inline long long mma_smem(const MmaPlan& k) {
  const long long R = static_cast<long long>(k.G) * k.Tp;
  const long long ldq = 3LL * k.HG * k.Dp + 8, PR = kWarpRows * k.WM;
  return 4 * (k.passes * PR + ldq - 8) + 2 * R * ldq +
         2 * kStages * (PR * kLdA + kSliceK * ldq);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Scores of 16 query rows (row group rg) against key block kb, in n8
// tiles: fragment element (n, e) is query 16 rg + lane / 4 + 8 (e / 2) and
// key 64 kb + 8 n + 2 (lane % 4) + e % 2; scaled and biased, -inf past T.
// qs and ks are a head's [Tp][ldq] q and k columns (Dp wide).
__device__ __forceinline__ void block_scores(const bf16* qs, const bf16* ks,
                                             int ldq, int rg, int kb, int Dp,
                                             const WinGeom& g,
                                             const float* const (&bi)[2],
                                             float (&s)[8][4]) {
  const int l = threadIdx.x & 31, q = l & 3, key0 = kKeys * kb;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const uint32_t a0 = smem_u32(qs + (16 * rg + a_row(l)) * ldq + a_col(l));
  const uint32_t b0 = smem_u32(ks + (key0 + bn_row(l)) * ldq + bn_col(l));
  for (int kk = 0; kk < Dp / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a0 + kk * 32);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if (key0 + 16 * n2 < g.T) {
        uint32_t b[4];
        ldsm_x4(b, b0 + (n2 * 16 * ldq + kk * 16) * 2);
        mma_bf16(s[2 * n2], a, b[0], b[1]);
        if (key0 + 16 * n2 + 8 < g.T) mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + 8 * n + 2 * q + (e & 1);
      s[n][e] = j < g.T ? s[n][e] * g.scale + __ldg(bi[e >> 1] + j)
                        : -INFINITY;
    }
}

// p = cast(exp(s - m) / l) as the bf16 A fragments of P . V's four 16-key
// k-steps: register r of k-step kb holds tile 2 kb + r / 2, row half r % 2
__device__ __forceinline__ void prob_frags(const float (&s)[8][4],
                                           const float (&m)[2],
                                           const float (&inv)[2],
                                           uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 2 * kb + (r >> 1), hh = r & 1;
      pa[kb][r] = pack_bf16(__expf(s[n][2 * hh] - m[hh]) * inv[hh],
                            __expf(s[n][2 * hh + 1] - m[hh]) * inv[hh]);
    }
}

// o += P . V over key block kb for the output columns [64 dc, 64 dc + 64)
// of the head (those below Dp); vs is the head's [Tp][ldq] v columns
__device__ __forceinline__ void prob_times_v(const uint32_t (&pa)[4][4],
                                             const bf16* vs, int ldq, int kb,
                                             int dc, int Dp, int T,
                                             float (&o)[8][4]) {
  const int l = threadIdx.x & 31;
  const uint32_t b0 = smem_u32(vs + bk_row(l) * ldq + bk_col(l));
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int key0 = kKeys * kb + 16 * ks;
    if (key0 >= T) continue;       // probabilities zero there
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      const int col = 64 * dc + 16 * n2;
      if (col < Dp) {
        uint32_t b[4];
        ldsm_x4_t(b, b0 + (key0 * ldq + col) * 2);
        mma_bf16(o[2 * n2], pa[ks], b[0], b[1]);
        mma_bf16(o[2 * n2 + 1], pa[ks], b[2], b[3]);
      }
    }
  }
}

// grid (window groups, head groups); block 32 WM WN threads
__global__ void __launch_bounds__(32 * kMmaWarps)
    win_attn_mma_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ bqkv, bf16* __restrict__ ctx,
                        WinGeom g, MmaPlan k) {
  extern __shared__ __align__(16) unsigned char win_smem_mma[];
  const int R = k.G * k.Tp, HD = k.HG * k.Dp, Np = 3 * HD, ldq = Np + 8;
  const int PR = kWarpRows * k.WM, stage = PR * kLdA + kSliceK * ldq;
  int* row_of = reinterpret_cast<int*>(win_smem_mma);         // [passes PR]
  int* col_of = row_of + k.passes * PR;                       // [Np]
  bf16* Q = reinterpret_cast<bf16*>(col_of + Np);             // [R][ldq]
  bf16* ring = Q + R * ldq;   // kStages x (x rows [PR][kLdA], W [32][ldq])
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, wm = warp / k.WN, wn = warp % k.WN;
  const int gq = lane >> 2, q = lane & 3;
  const int win0 = blockIdx.x * k.G, h0 = blockIdx.y * k.HG;
  for (int r = threadIdx.x; r < k.passes * PR; r += blockDim.x)
    row_of[r] = r < R && r % k.Tp < g.T
                    ? token_row(g, win0 + r / k.Tp, r % k.Tp)
                    : -1;
  // column c of the block's q | k | v (head hl's Dp columns in each part)
  // is Wqkv's column col_of[c] + h0 dh, or -1 in a head's padding: the
  // loops below then divide by nothing that is not a constant
  for (int c = threadIdx.x; c < Np; c += blockDim.x) {
    const int d = c % k.Dp;
    col_of[c] = d < g.dh ? c / HD * g.C + c / k.Dp % k.HG * g.dh + d : -1;
  }
  __syncthreads();
  const bf16* wq = wqkv + h0 * g.dh;
  const bf16* bq = bqkv + h0 * g.dh;

  // K slice t of pass rows [prow0, prow0 + PR) into slot t % kStages: x's
  // rows (zeros for padded tokens and windows past the last) and the head
  // group's q, k, v columns of Wqkv, each head's dh columns then zeros to Dp
  const int nk = (g.C + kSliceK - 1) / kSliceK;
  const int w_row = threadIdx.x / (Np / 8), w_col = threadIdx.x % (Np / 8) * 8;
  const int w_row_step = blockDim.x / (Np / 8);
  const int w_col_step = blockDim.x % (Np / 8) * 8;
  auto issue = [&](int prow0, int t) {
    if (t >= nk) return;
    const int k0 = t * kSliceK;
    bf16* As = ring + (t % kStages) * stage;
    bf16* Ws = As + PR * kLdA;
    for (int c = threadIdx.x; c < PR * (kSliceK / 8); c += blockDim.x) {
      const int r = c / (kSliceK / 8), kc = c % (kSliceK / 8) * 8;
      const int ro = row_of[prow0 + r];
      const bool live = ro >= 0 && k0 + kc < g.C;
      cp_async16_zfill(As + r * kLdA + kc,
                       live ? x + static_cast<size_t>(ro) * g.C + k0 + kc : x,
                       live ? 16 : 0);
    }
    // row kr, 8 columns from col: each thread steps through the slice
    for (int kr = w_row, col = w_col; kr < kSliceK;) {
      const bf16* src = wq + static_cast<size_t>(k0 + kr) * 3 * g.C;
      bf16* dst = Ws + kr * ldq + col;
      const bool live_k = k0 + kr < g.C;
      if (g.dh % 8 == 0) {   // 8 columns of one head, all real or padding
        const int from = col_of[col];
        const bool live = live_k && from >= 0;
        cp_async16_zfill(dst, live ? src + from : wqkv, live ? 16 : 0);
      } else {   // a head's columns are no whole 16-byte pieces
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int from = col_of[col + e];
          dst[e] = live_k && from >= 0 ? src[from] : __float2bfloat16(0.f);
        }
      }
      kr += w_row_step;
      col += w_col_step;
      if (col >= Np) col -= Np, ++kr;
    }
  };

  // qkv = cast(x Wqkv + b) of the block's rows, pass by pass
  for (int pass = 0; pass < k.passes; ++pass) {
    const int prow0 = pass * PR;
    float acc[2][6][4] = {};
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      issue(prow0, t);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      // slice t has landed; every warp is done with the slot slice
      // t + kStages - 1 takes
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(prow0, t + kStages - 1);
      cp_async_commit();
      const bf16* As = ring + (t % kStages) * stage;
      const bf16* Ws = As + PR * kLdA;
#pragma unroll
      for (int kk = 0; kk < kSliceK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], smem_u32(As + (kWarpRows * wm + 16 * i +
                                       a_row(lane)) * kLdA +
                                 kk + a_col(lane)));
#pragma unroll
        for (int j2 = 0; j2 < 3; ++j2) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(Ws + (kk + bk_row(lane)) * ldq +
                                kWarpCols * wn + 16 * j2 + bk_col(lane)));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * j2], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * j2 + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = prow0 + kWarpRows * wm + 16 * i + gq + 8 * hh;
          if (r >= R) continue;
          const int col = kWarpCols * wn + 8 * j + 2 * q, from = col_of[col];
          float v0 = 0.f, v1 = 0.f;   // exact zeros in the padded columns
          if (from >= 0) {
            v0 = acc[i][j][2 * hh] + __bfloat162float(bq[from]);
            v1 = acc[i][j][2 * hh + 1] + __bfloat162float(bq[from + 1]);
          }
          store_pair(Q + r * ldq + col, v0, v1);
        }
  }
  __syncthreads();

  // attention: a warp takes (window, head, 16 query rows) items
  const int RG = k.Tp / 16, nkb = (k.Tp + kKeys - 1) / kKeys;
  const int ndc = (k.Dp + 63) / 64, items = k.G * k.HG * RG;
  for (int it = warp; it < items; it += warps) {
    const int rg = it % RG, hl = it / RG % k.HG, gw = it / (RG * k.HG);
    const int widx = win0 + gw;
    if (widx >= g.windows) continue;
    const bf16* qs = Q + gw * k.Tp * ldq + hl * k.Dp;
    const bf16* ks = qs + HD;
    const bf16* vs = qs + 2 * HD;
    // padded query rows take row T - 1's bias: finite, never stored
    const float* brow =
        bias + (widx % g.P) * g.bias_sp + (h0 + hl) * g.bias_sh;
    const int i0 = 16 * rg + gq;
    const float* const bi[2] = {brow + min(i0, g.T - 1) * g.T,
                                brow + min(i0 + 8, g.T - 1) * g.T};
    float s[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < nkb; ++kb) {
      block_scores(qs, ks, ldq, rg, kb, k.Dp, g, bi, s);
      float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(~0u, mb[r], 1));
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(~0u, mb[r], 2));
        const float mn = fmaxf(m[r], mb[r]);   // every block has a live key
        l[r] *= __expf(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(s[n][e] - m[e >> 1]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(~0u, l[r], 1);
      l[r] += __shfl_xor_sync(~0u, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    uint32_t pa[4][4];
    if (nkb == 1) prob_frags(s, m, inv, pa);
    for (int dc = 0; dc < ndc; ++dc) {
      float o[8][4] = {};
      for (int kb = 0; kb < nkb; ++kb) {
        if (nkb > 1) {
          block_scores(qs, ks, ldq, rg, kb, k.Dp, g, bi, s);
          prob_frags(s, m, inv, pa);
        }
        prob_times_v(pa, vs, ldq, kb, dc, k.Dp, g.T, o);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i >= g.T) continue;
        bf16* dst = ctx + static_cast<size_t>(row_of[gw * k.Tp + i]) * g.C +
                    (h0 + hl) * g.dh;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = 64 * dc + 8 * n + 2 * q;
          if (d < g.dh) store_pair(dst + d, o[n][2 * hh], o[n][2 * hh + 1]);
        }
      }
    }
  }
}

// ---- float32: 3xTF32 on the tensor cores -----------------------------------
//
// bf16's blocking and loops with float tiles: the projection's slices are
// 16 floats deep (two k-steps) with their products summed into zeroed sums
// (mma.cuh tf32_slice), q, k and v stay floats in shared memory ([G Tp][3
// HG Dp + 8], padded columns exact zeros), and the scores, the softmax
// (expf) and P . V run as 3xTF32 tiles, each operand split once as it is
// read into its fragment.

constexpr int kF32Slice = 16;                 // depth of a K slice
constexpr int kF32LdA = kF32Slice + 8;        // x rows of a slice, floats
constexpr int kF32Stages = 3;                 // of the projection's ring
constexpr int kF32Warps = 8;                  // at most, a block

inline long long tf32_smem(const MmaPlan& k) {
  const long long R = static_cast<long long>(k.G) * k.Tp;
  const long long Np = 3LL * k.HG * k.Dp, PR = kWarpRows * k.WM;
  return 4 * (k.passes * PR + Np) + 4 * R * (Np + 8) +
         4 * kF32Stages * (PR * kF32LdA + kF32Slice * (Np + 4));
}

// the plan is the one win_attn_plan builds for this geometry and dtype
inline bool plan_fits(const WinGeom& g, const MmaPlan& k, bool f32) {
  return k.G >= 1 && k.HG >= 1 && g.nh % k.HG == 0 &&
         k.Tp == (g.T + 15) / 16 * 16 && k.Dp == (g.dh + 15) / 16 * 16 &&
         k.WN * 16 == k.HG * k.Dp && k.WM >= 1 &&
         k.WM * k.WN <= (f32 ? kF32Warps : kMmaWarps) &&
         k.passes == (k.G * k.Tp + kWarpRows * k.WM - 1) /
                         (kWarpRows * k.WM) &&
         k.smem == (f32 ? tf32_smem(k) : mma_smem(k)) &&
         k.smem <= static_cast<long long>(kMaxSmem);
}

// d = the 3xTF32 product of one k-step into zeroed sums (small terms first)
__device__ __forceinline__ void tf32_step(float (&d)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], float b0,
                                          float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32_fast(b0, bb0, bs0);
  split_tf32_fast(b1, bb1, bs1);
  mma_tf32_zero(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_fast(a[e], ab[e], as[e]);
}

// block_scores in float: the scores of 16 query rows (row group rg) against
// key block kb, fragment element (n, e) query 16 rg + lane / 4 + 8 (e / 2),
// key 64 kb + 8 n + 2 (lane % 4) + e % 2; scaled and biased, -inf past T.
// qs and ks are a head's [Tp][ldq] float q and k columns (Dp wide); within
// a k-step, fragment column q is the head's column 2q and q + 4 is 2q + 1
// for q and k alike (mma.cuh tf32_slice), one float2 a row.
__device__ __forceinline__ void block_scores_tf32(
    const float* qs, const float* ks, int ldq, int rg, int kb, int Dp,
    const WinGeom& g, const float* const (&bi)[2], float (&s)[8][4]) {
  const int l = threadIdx.x & 31, gq = l >> 2, q = l & 3, key0 = kKeys * kb;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const float* qa = qs + (16 * rg + gq) * ldq + 2 * q;
  const float* kr = ks + (key0 + gq) * ldq + 2 * q;
  for (int kk = 0; kk < Dp / 8; ++kk) {
    const float2 lo = *reinterpret_cast<const float2*>(qa + 8 * kk);
    const float2 hi = *reinterpret_cast<const float2*>(qa + 8 * ldq + 8 * kk);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (key0 + 8 * n < g.T) {
        const float2 kv =
            *reinterpret_cast<const float2*>(kr + 8 * n * ldq + 8 * kk);
        float d[4];
        tf32_step(d, ab, as, kv.x, kv.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += d[e];
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + 8 * n + 2 * q + (e & 1);
      s[n][e] = j < g.T ? s[n][e] * g.scale + __ldg(bi[e >> 1] + j)
                        : -INFINITY;
    }
}

// the scores in place to p = exp(s - m) / l
__device__ __forceinline__ void probs_tf32(float (&s)[8][4],
                                           const float (&m)[2],
                                           const float (&inv)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = expf(s[n][e] - m[e >> 1]) * inv[e >> 1];
}

// o += P . V over key block kb for the output columns [64 dc, 64 dc + 64)
// of the head (those below Dp): the probabilities p, as they lie, are the
// A fragments of the 8-key k-steps (tile n's c0, c1 row g's keys 2q and
// 2q + 1, c2, c3 row g + 8's), B reads v's rows 2q and 2q + 1 of the
// step at one column; vs is the head's [Tp][ldq] v columns
__device__ __forceinline__ void prob_times_v_tf32(const float (&p)[8][4],
                                                  const float* vs, int ldq,
                                                  int kb, int dc, int Dp,
                                                  int T, float (&o)[8][4]) {
  const int l = threadIdx.x & 31, gq = l >> 2, q = l & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = kKeys * kb + 8 * n;
    if (key >= T) continue;       // probabilities zero there
    const float a[4] = {p[n][0], p[n][2], p[n][1], p[n][3]};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    const float* vr = vs + (key + 2 * q) * ldq + 64 * dc + gq;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (64 * dc + 8 * t < Dp) {
        float d[4];
        tf32_step(d, ab, as, vr[8 * t], vr[ldq + 8 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[t][e] += d[e];
      }
    }
  }
}

// grid (window groups, head groups); block 32 WM WN threads
__global__ void __launch_bounds__(32 * kF32Warps, 2)
    win_attn_tf32_kernel(const float* __restrict__ x,
                         const float* __restrict__ bias,
                         const float* __restrict__ wqkv,
                         const float* __restrict__ bqkv,
                         float* __restrict__ ctx, WinGeom g, MmaPlan k) {
  extern __shared__ __align__(16) unsigned char win_smem_tf32[];
  const int R = k.G * k.Tp, HD = k.HG * k.Dp, Np = 3 * HD;
  const int ldq = Np + 8, ldw = Np + 4;
  const int PR = kWarpRows * k.WM, stage = PR * kF32LdA + kF32Slice * ldw;
  int* row_of = reinterpret_cast<int*>(win_smem_tf32);        // [passes PR]
  int* col_of = row_of + k.passes * PR;                       // [Np]
  float* Q = reinterpret_cast<float*>(col_of + Np);           // [R][ldq]
  float* ring = Q + R * ldq;   // kF32Stages x (x rows [PR][kF32LdA], W)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, wm = warp / k.WN, wn = warp % k.WN;
  const int gq = lane >> 2, q = lane & 3;
  const int win0 = blockIdx.x * k.G, h0 = blockIdx.y * k.HG;
  for (int r = threadIdx.x; r < k.passes * PR; r += blockDim.x)
    row_of[r] = r < R && r % k.Tp < g.T
                    ? token_row(g, win0 + r / k.Tp, r % k.Tp)
                    : -1;
  // column c of the block's q | k | v is Wqkv's column col_of[c] + h0 dh,
  // or -1 in a head's padding (dh is a multiple of 4: a 16-byte piece is
  // all real or all padding)
  for (int c = threadIdx.x; c < Np; c += blockDim.x) {
    const int d = c % k.Dp;
    col_of[c] = d < g.dh ? c / HD * g.C + c / k.Dp % k.HG * g.dh + d : -1;
  }
  __syncthreads();
  const float* wq = wqkv + h0 * g.dh;
  const float* bq = bqkv + h0 * g.dh;

  // K slice t of pass rows [prow0, prow0 + PR) into slot t % kF32Stages:
  // x's rows (zeros for padded tokens and windows past the last) and the
  // head group's q, k, v columns of Wqkv (zeros in the heads' padding)
  const int nk = g.C / kF32Slice;
  auto issue = [&](int prow0, int t) {
    if (t >= nk) return;
    const int k0 = t * kF32Slice;
    float* As = ring + (t % kF32Stages) * stage;
    float* Ws = As + PR * kF32LdA;
    for (int c = threadIdx.x; c < PR * (kF32Slice / 4); c += blockDim.x) {
      const int r = c / (kF32Slice / 4), kc = c % (kF32Slice / 4) * 4;
      const int ro = row_of[prow0 + r];
      cp_async16_zfill(As + r * kF32LdA + kc,
                       ro >= 0 ? x + static_cast<size_t>(ro) * g.C + k0 + kc
                               : x,
                       ro >= 0 ? 16 : 0);
    }
    for (int c = threadIdx.x; c < kF32Slice * (Np / 4); c += blockDim.x) {
      const int kr = c / (Np / 4), col = c % (Np / 4) * 4;
      const int from = col_of[col];
      cp_async16_zfill(
          Ws + kr * ldw + col,
          from >= 0 ? wq + static_cast<size_t>(k0 + kr) * 3 * g.C + from
                    : wqkv,
          from >= 0 ? 16 : 0);
    }
  };

  // qkv = x Wqkv + b of the block's rows, pass by pass: each warp a 32 x 48
  // tile, its two m16 tiles sharing each split of Wqkv
  for (int pass = 0; pass < k.passes; ++pass) {
    const int prow0 = pass * PR;
    float acc[2][6][4] = {};
#pragma unroll
    for (int t = 0; t < kF32Stages - 1; ++t) {
      issue(prow0, t);
      cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      // slice t has landed; every warp is done with the slot slice
      // t + kF32Stages - 1 takes
      cp_async_wait<kF32Stages - 2>();
      __syncthreads();
      issue(prow0, t + kF32Stages - 1);
      cp_async_commit();
      const float* As = ring + (t % kF32Stages) * stage;
      tf32_slice<2, 6, kF32Slice / 8>(acc, As + kWarpRows * wm * kF32LdA,
                                      kF32LdA,
                                      As + PR * kF32LdA + kWarpCols * wn,
                                      ldw);
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = prow0 + kWarpRows * wm + 16 * i + gq + 8 * hh;
          if (r >= R) continue;
          const int col = kWarpCols * wn + 8 * j + 2 * q, from = col_of[col];
          float v0 = 0.f, v1 = 0.f;   // exact zeros in the padded columns
          if (from >= 0) {
            v0 = acc[i][j][2 * hh] + bq[from];
            v1 = acc[i][j][2 * hh + 1] + bq[from + 1];
          }
          *reinterpret_cast<float2*>(Q + r * ldq + col) = make_float2(v0, v1);
        }
  }
  __syncthreads();

  // attention: a warp takes (window, head, 16 query rows) items, as bf16
  const int RG = k.Tp / 16, nkb = (k.Tp + kKeys - 1) / kKeys;
  const int ndc = (k.Dp + 63) / 64, items = k.G * k.HG * RG;
  for (int it = warp; it < items; it += warps) {
    const int rg = it % RG, hl = it / RG % k.HG, gw = it / (RG * k.HG);
    const int widx = win0 + gw;
    if (widx >= g.windows) continue;
    const float* qs = Q + gw * k.Tp * ldq + hl * k.Dp;
    const float* ks = qs + HD;
    const float* vs = qs + 2 * HD;
    // padded query rows take row T - 1's bias: finite, never stored
    const float* brow =
        bias + (widx % g.P) * g.bias_sp + (h0 + hl) * g.bias_sh;
    const int i0 = 16 * rg + gq;
    const float* const bi[2] = {brow + min(i0, g.T - 1) * g.T,
                                brow + min(i0 + 8, g.T - 1) * g.T};
    float s[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < nkb; ++kb) {
      block_scores_tf32(qs, ks, ldq, rg, kb, k.Dp, g, bi, s);
      float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(~0u, mb[r], 1));
        mb[r] = fmaxf(mb[r], __shfl_xor_sync(~0u, mb[r], 2));
        const float mn = fmaxf(m[r], mb[r]);   // every block has a live key
        l[r] *= expf(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[n][e] - m[e >> 1]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(~0u, l[r], 1);
      l[r] += __shfl_xor_sync(~0u, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    if (nkb == 1) probs_tf32(s, m, inv);
    for (int dc = 0; dc < ndc; ++dc) {
      float o[8][4] = {};
      for (int kb = 0; kb < nkb; ++kb) {
        if (nkb > 1) {
          block_scores_tf32(qs, ks, ldq, rg, kb, k.Dp, g, bi, s);
          probs_tf32(s, m, inv);
        }
        prob_times_v_tf32(s, vs, ldq, kb, dc, k.Dp, g.T, o);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i >= g.T) continue;
        float* dst = ctx + static_cast<size_t>(row_of[gw * k.Tp + i]) * g.C +
                     (h0 + hl) * g.dh;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = 64 * dc + 8 * n + 2 * q;
          if (d < g.dh)
            *reinterpret_cast<float2*>(dst + d) =
                make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
        }
      }
    }
  }
}

cudaError_t attention_f32(const void* x, const float* bias, const void* wqkv,
                          const void* bqkv, void* ctx, const WinGeom& g,
                          const MmaPlan& k, cudaStream_t s) {
  auto kernel = win_attn_tf32_kernel;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(k.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.windows + k.G - 1) / k.G, g.nh / k.HG);
  kernel<<<grid, 32 * k.WM * k.WN, k.smem, s>>>(
      static_cast<const float*>(x), bias, static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<float*>(ctx), g, k);
  return cudaGetLastError();
}

cudaError_t attention_bf16(const void* x, const float* bias,
                           const void* wqkv, const void* bqkv, void* ctx,
                           const WinGeom& g, const MmaPlan& k,
                           cudaStream_t s) {
  auto kernel = win_attn_mma_kernel;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(k.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.windows + k.G - 1) / k.G, g.nh / k.HG);
  kernel<<<grid, 32 * k.WM * k.WN, k.smem, s>>>(
      static_cast<const bf16*>(x), bias, static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<bf16*>(ctx), g, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

extern "C" int idvs_gemm(const void* A, const void* B, void* out,
                         const void* add, const void* gate, const void* bias,
                         void* ws, int M, int N, int K, long long sam,
                         long long sak, long long sbk, long long sbn,
                         int splits, int pro_act, int gate_act, int out_act,
                         int out_f32, int a_f32, int gate_f32, int dtype,
                         void* stream);

// x, ctx (scratch), out: windows * T rows of C in the compute dtype, in the
// window layout (band = 0: window r is rows r*T .. r*T+T-1) or the band
// layout (band = 1: images of nwr x nwc windows of w x w tokens, row-major
// maps). wqkv (C, 3C), bqkv (3C,), wo (C, C), bo (C,) in the compute dtype,
// (in, out) layouts, 16-byte aligned. bias: float, element (p, h, i, j) at
// p*bias_sp + h*bias_sh + i*T + j; window r takes p = r % P. dh is a
// multiple of 4 and C of 16. G ... smem: the block plan win_attn_plan builds
// for the geometry and the dtype (checked by plan_fits). Returns
// cudaErrorInvalidValue for a plan that is not that one.
extern "C" int idvs_win_attn_fwd(const void* x, const void* bias,
                                 const void* wqkv, const void* bqkv,
                                 const void* wo, const void* bo, void* ctx,
                                 void* out, int windows, int T, int C, int nh,
                                 int P, long long bias_sp, long long bias_sh,
                                 int band, int w, int nwc, int nwr,
                                 float scale, int G, int HG, int t_pad,
                                 int dh_pad, int warps_m, int warps_n,
                                 int passes, long long smem, int dtype,
                                 void* stream) {
  using namespace idvs;
  if (windows < 1 || T < 1 || nh < 1 || C % nh || C % 16 || P < 1 ||
      (C / nh) % 4 ||
      (band && (w * w != T || nwc < 1 || nwr < 1 ||
                windows % (nwc * nwr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WinGeom g{windows, T, C, nh, C / nh, P, bias_sp, bias_sh,
            band, w, nwc, nwr, scale};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MmaPlan k{G, HG, t_pad, dh_pad, warps_m, warps_n, passes, smem};
  if ((dtype != kF32 && dtype != kBF16) || !plan_fits(g, k, dtype == kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == kF32 ? attention_f32(x, bf, wqkv, bqkv, ctx, g, k, s)
                    : attention_bf16(x, bf, wqkv, bqkv, ctx, g, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // out = cast(ctx Wo + bo): row-major (M, C) x (C, C), one K slice
  const int M = windows * T;
  return idvs_gemm(ctx, wo, out, nullptr, nullptr, bo, nullptr, M, C, C, C,
                   1, C, 1, 1, 0, 1, 0, 0, 0, 0, dtype, stream);
}

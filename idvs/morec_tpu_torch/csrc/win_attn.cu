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
// stage for 512 images at 989 TFLOP/s, by bytes at stage 0) and by the
// float FMA rate in float32 (no TF32, for parity). Two launches: the
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
// float32 (win_attn_kernel): the first launch gives a block G windows (one
// at T = 49) and HG heads (3 or 4): it streams the windows' rows of x and
// the head group's q, k, v columns of Wqkv through shared memory in
// 16-deep slices into a 4 x 12 register tile per thread (tile.cuh), parks
// the cast q, k, v of its heads in shared memory (a head group's is 80 KB
// at C = 768), runs the (T, T) scores, the float softmax and p . v there
// (4 x 4 register tiles: at C = 96 the attention is a fifth of the
// operations), and writes its heads' context into the scratch.
#include "mma.cuh"
#include "tile.cuh"
#include "win_map.cuh"

namespace idvs {
namespace {

constexpr int kKB = 16;            // depth of a K slice in win_attn_kernel
constexpr int kMaxThreads = 512;   // of a win_attn_kernel block

struct WinGeom {
  int windows, T, C, nh, dh;
  int G, HG;                       // windows and heads per block
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

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// shared-memory bytes of a win_attn_kernel block
inline size_t win_smem(const WinGeom& g) {
  const int R4 = round4(g.G * g.T), NC = 3 * g.HG * g.dh;
  return sizeof(float) * (static_cast<size_t>(R4) + 2 * kKB * (R4 + 4) +
                          2 * kKB * NC + static_cast<size_t>(R4) * (NC + 1) +
                          static_cast<size_t>(g.G) * g.HG * g.T * (g.T + 1));
}

// The one place that chooses a block's share: G windows for a row tile of
// at least 45 tokens (TY = ceil(G * T / 4) >= 12), and the largest group of
// at most 4 heads that divides nh, is at least 32 columns wide (TX >= 8) and
// fits the block's threads and shared memory. False: no such blocking.
inline bool choose_blocking(WinGeom& g) {
  g.G = (45 + g.T - 1) / g.T;
  const int TY = round4(g.G * g.T) / 4;
  for (g.HG = 4; g.HG >= 1; --g.HG) {
    const int TX = g.HG * g.dh / 4;
    if (g.nh % g.HG == 0 && TX >= 8 && TX * TY <= kMaxThreads &&
        win_smem(g) <= kMaxSmem)
      return true;
  }
  return false;
}

// grid (window groups, head groups); block TX * TY threads with
// TX = HG * dh / 4 and TY = ceil(G * T / 4)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    win_attn_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                    T* __restrict__ ctx, WinGeom g) {
  extern __shared__ float4 smem4[];
  const int R = g.G * g.T, R4 = round4(R), lda = R4 + 4;
  const int HD = g.HG * g.dh, NC = 3 * HD, ldq = NC + 1, lds = g.T + 1;
  int* row_of = reinterpret_cast<int*>(smem4);          // [R4]
  float* At = reinterpret_cast<float*>(smem4) + R4;     // 2 x [kKB][lda]
  float* Bs = At + 2 * kKB * lda;                       // 2 x [kKB][NC]
  float* Q = Bs + 2 * kKB * NC;                         // [R4][ldq] q|k|v
  float* S = Q + R4 * ldq;                              // [G*HG*T][lds]
  const int TX = HD / 4;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int win0 = blockIdx.x * g.G, h0 = blockIdx.y * g.HG;

  for (int r = threadIdx.x; r < R4; r += blockDim.x)
    row_of[r] = r < R ? token_row(g, win0 + r / g.T, r % g.T) : -1;
  __syncthreads();

  // q, k, v of the block's heads: (R4, C) x (C, NC), columns gathered from
  // the three ranges of Wqkv
  float acc[4][12] = {};
  tile::ASlice<T, kKB, 2> a;
  tile::WSlice<T, kKB, 4> b;
  a.init(row_of, R4, g.C, lda);
  b.init(3 * g.C, NC, HD, g.C, h0 * g.dh);
  const int slices = g.C / kKB;
  a.load(x, 0);
  b.load(wqkv, 3 * g.C, 0);
  for (int s = 0; s < slices; ++s) {
    float* at = At + (s & 1) * kKB * lda;
    float* bs = Bs + (s & 1) * kKB * NC;
    a.store(at, lda);
    b.store(bs);
    __syncthreads();
    if (s + 1 < slices) {      // next slice in flight during the FMAs
      a.load(x, (s + 1) * kKB);
      b.load(wqkv, 3 * g.C, (s + 1) * kKB);
    }
    tile::fma_tile<3, kKB>(acc, at, lda, bs, NC, 4 * ty, 4 * tx, 4 * TX);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + 4 * TX * j + c;
      const float bv =
          to_f32(bqkv[(col / HD) * g.C + h0 * g.dh + col % HD]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        Q[(4 * ty + r) * ldq + col] = round_to<T>(acc[r][4 * j + c] + bv);
    }
  }
  __syncthreads();

  // scores of every (window, head) of the block, a 4 x 4 tile of (query,
  // key) pairs a thread: 8 shared-memory loads feed 16 FMAs. The rows of a
  // ragged edge tile (T = 49 is no multiple of 4) are clamped for the loads
  // and left out of the stores
  const int planes = g.G * g.HG, nt = (g.T + 3) / 4;
  for (int tile = threadIdx.x; tile < planes * nt * nt; tile += blockDim.x) {
    const int gh = tile / (nt * nt), rem = tile % (nt * nt);
    const int i0 = 4 * (rem / nt), j0 = 4 * (rem % nt);
    const int gw = gh / g.HG, hl = gh % g.HG, widx = win0 + gw;
    const float *q[4], *k[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      q[r] = Q + (gw * g.T + min(i0 + r, g.T - 1)) * ldq + hl * g.dh;
      k[r] = Q + (gw * g.T + min(j0 + r, g.T - 1)) * ldq + HD + hl * g.dh;
    }
    float s[4][4] = {};
    for (int d = 0; d < g.dh; ++d) {
      const float qv[4] = {q[0][d], q[1][d], q[2][d], q[3][d]};
      const float kv[4] = {k[0][d], k[1][d], k[2][d], k[3][d]};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
    const bool live = widx < g.windows;
    const float* brow =
        bias + (live ? (widx % g.P) * g.bias_sp + (h0 + hl) * g.bias_sh : 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r >= g.T) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c >= g.T) continue;
        S[(gh * g.T + i0 + r) * lds + j0 + c] =
            live ? s[r][c] * g.scale + brow[(i0 + r) * g.T + j0 + c] : 0.f;
      }
    }
  }
  __syncthreads();

  // float softmax over each row, one warp a row; the probabilities are
  // cast. A block need not be whole warps (TX * TY threads): the last,
  // partial warp sits out, the shuffles need all 32 lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int row = warp < warps ? warp : planes * g.T; row < planes * g.T;
       row += warps) {
    float* si = S + row * lds;
    float m = -INFINITY;
    for (int j = lane; j < g.T; j += 32) m = fmaxf(m, si[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    float sum = 0.f;
    for (int j = lane; j < g.T; j += 32) {
      const float e = expf(si[j] - m);
      si[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    for (int j = lane; j < g.T; j += 32) si[j] = round_to<T>(si[j] / sum);
  }
  __syncthreads();

  // ctx = p . v into the scratch, at the tokens' own rows: a 4 x 4 tile
  // of (query, feature) pairs a thread
  const int nd = g.dh / 4;
  for (int tile = threadIdx.x; tile < planes * nt * nd; tile += blockDim.x) {
    const int gh = tile / (nt * nd), rem = tile % (nt * nd);
    const int i0 = 4 * (rem / nd), d0 = 4 * (rem % nd);
    const int gw = gh / g.HG, hl = gh % g.HG;
    const float* p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[r] = S + (gh * g.T + min(i0 + r, g.T - 1)) * lds;
    const float* v = Q + gw * g.T * ldq + 2 * HD + hl * g.dh + d0;
    float o[4][4] = {};
    for (int j = 0; j < g.T; ++j) {
      const float pv[4] = {p[0][j], p[1][j], p[2][j], p[3][j]};
      const float* vj = v + j * ldq;
      const float vv[4] = {vj[0], vj[1], vj[2], vj[3]};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = fmaf(pv[r], vv[c], o[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + r < g.T ? row_of[gw * g.T + i0 + r] : -1;
      if (row < 0) continue;
      tile::store4(ctx + static_cast<size_t>(row) * g.C + (h0 + hl) * g.dh +
                       d0,
                   make_float4(o[r][0], o[r][1], o[r][2], o[r][3]));
    }
  }
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

// the plan is the one win_attn_plan builds for this geometry
inline bool plan_fits(const WinGeom& g, const MmaPlan& k) {
  return k.G >= 1 && k.HG >= 1 && g.nh % k.HG == 0 &&
         k.Tp == (g.T + 15) / 16 * 16 && k.Dp == (g.dh + 15) / 16 * 16 &&
         k.WN * 16 == k.HG * k.Dp && k.WM >= 1 &&
         k.WM * k.WN <= kMmaWarps &&
         k.passes == (k.G * k.Tp + kWarpRows * k.WM - 1) /
                         (kWarpRows * k.WM) &&
         k.smem == mma_smem(k) && k.smem <= static_cast<long long>(kMaxSmem);
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

cudaError_t attention_f32(const void* x, const float* bias, const void* wqkv,
                          const void* bqkv, void* ctx, const WinGeom& g,
                          cudaStream_t s) {
  const size_t smem = win_smem(g);
  auto kernel = win_attn_kernel<float>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = g.HG * g.dh / 4 * (round4(g.G * g.T) / 4);
  const dim3 grid((g.windows + g.G - 1) / g.G, g.nh / g.HG);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(x), bias, static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<float*>(ctx), g);
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
                         int splits, int pro_act, int gate_act, int out_f32,
                         int a_f32, int gate_f32, int dtype, void* stream);

// x, ctx (scratch), out: windows * T rows of C in the compute dtype, in the
// window layout (band = 0: window r is rows r*T .. r*T+T-1) or the band
// layout (band = 1: images of nwr x nwc windows of w x w tokens, row-major
// maps). wqkv (C, 3C), bqkv (3C,), wo (C, C), bo (C,) in the compute dtype,
// (in, out) layouts, 16-byte aligned. bias: float, element (p, h, i, j) at
// p*bias_sp + h*bias_sh + i*T + j; window r takes p = r % P. dh is a
// multiple of 4 and C of 16. bf16 takes the block plan G ... smem of
// win_attn_plan (checked by plan_fits); float32 ignores it and chooses its
// own (choose_blocking). Returns cudaErrorInvalidValue for a geometry the
// dtype's body cannot place.
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
  if (windows < 1 || T < 1 || nh < 1 || C % nh || C % kKB || P < 1 ||
      (C / nh) % 4 ||
      (band && (w * w != T || nwc < 1 || nwr < 1 ||
                windows % (nwc * nwr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WinGeom g{windows, T, C, nh, C / nh, 0, 0, P, bias_sp, bias_sh,
            band, w, nwc, nwr, scale};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    if (!choose_blocking(g)) return static_cast<int>(cudaErrorInvalidValue);
    err = attention_f32(x, bf, wqkv, bqkv, ctx, g, s);
  } else if (dtype == kBF16) {
    const MmaPlan k{G, HG, t_pad, dh_pad, warps_m, warps_n, passes, smem};
    if (!plan_fits(g, k)) return static_cast<int>(cudaErrorInvalidValue);
    err = attention_bf16(x, bf, wqkv, bqkv, ctx, g, k, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // out = cast(ctx Wo + bo): row-major (M, C) x (C, C), one K slice
  const int M = windows * T;
  return idvs_gemm(ctx, wo, out, nullptr, nullptr, bo, nullptr, M, C, C, C,
                   1, C, 1, 1, 0, 1, 0, 0, 0, dtype, stream);
}

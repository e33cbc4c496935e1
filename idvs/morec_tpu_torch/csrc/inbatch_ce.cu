// The in-batch debiased cross-entropy with an online softmax: the forward
// (loss rows) and the backward (du, dcand), the (M, N) logits never in
// device memory.
//
// Replaces idvs/morec_tpu/ops/pallas/inbatch_ce.py fused_inbatch_ce and
// fused_inbatch_ce_gathered: _fwd_kernel (:61, pallas_call :189) and
// _bwd_kernel (:99, pallas_call :227). Both editions share these kernels;
// the gathered one passes the all-gathered candidates and a label offset.
//
// Per row r (user i = r / L, position j = r % L) and candidate column c:
//   logit[r][c] = u[r] . cand[c] - logpop[c]               (float32)
//   -1e4 where colmask[c] == 0, or where cand_ids[c] is among user i's S
//   ids and c != label[r] = label_off + i*S + j + 1
//   ce[r] = log sum_c exp(logit[r][c]) - logit[r][label[r]]
// Only the N real columns enter the sums (the TPU kernel's padded columns
// are a tiling artefact). The backward forms
//   dlogit = (exp(logit - m[r]) / l[r] - onehot) * ws[r],
//   ws[r] = w[r] * g / n_valid,
// and 0 at a masked logit, which is a constant (the TPU kernel lets
// -onehot * ws through a masked label column, which a log mask of 0 inside
// a history gives a valid row; the composition's autograd does not); then
// du = dlogit @ cand, dcand = dlogit^T @ u, accumulated in float and
// rounded once to the inputs' dtype.
//
// Bound on the H100: the products, 2*M*N*D operations each (7 GFLOP at
// the text flagship's M 2560 x N 2688 x D 512; one forward, three in the
// backward) against a few MB of operands: compute-bound. Design: every
// product on the tensor cores, as mma.sync (mma.cuh): bf16 m16n8k16 with
// float accumulators (products of bf16 values are exact in float, so the
// sums match the TPU kernel's widened float32 dot up to their order), and
// float32 as 3xTF32 on m16n8k8, each 8-deep step's sums added to the
// running sums by float adds (gemm.cu's header has why).
// - A logit tile is 64 rows of the block's own side by 128 of the other
//   side, K = D walked in slices of 128 to 512 bytes a row (FwdRing,
//   BwdRing) through a ring of shared-memory stages filled by 16-byte
//   cp.async copies (zero-filled past M, N and D). Rows are padded by 16
//   bytes (bf16: ldmatrix's eight rows fall in eight bank groups) or 32
//   (float: the float2 fragment reads of a half-warp fall in distinct
//   banks). Every step ends at a barrier of the block's warps, so fewer,
//   larger steps measured faster (PERF.md, PR 13): bf16 takes the largest
//   slices the blocks an SM holds leave room for.
// - The masks cost a few register operations a logit: a tile stages its
//   rows' label column and user, its columns' id, mask and log popularity,
//   and the same-user rejection once a tile as one bit per (user, column)
//   for the at most 128 / L + 2 users the tile's rows span (a warp's
//   ballot over 32 columns, the ids read as int4). Each thread then keeps
//   its columns' terms and its rows' bit words in registers; the label is
//   exempt by its column index, so an exemption across a tile edge needs
//   nothing more.
// - Forward (ce_fwd_kernel): 8 warps, each a 32 x 32 piece of the tile,
//   keep a running max, sum and label logit for each of their rows in
//   registers (the max reduced over the fragment's quad by shuffles each
//   tile, the sum and the label logit at the end). The column tiles of a
//   row tile are split over `splits` blocks so that enough blocks fill the
//   card; the four column warps' partials are merged in order in shared
//   memory and ce_merge_kernel merges the splits in split order.
// - Backward (ce_bwd_kernel): the TPU kernel sums dcand over row tiles in
//   its sequential grid; blocks here run in no order and only
//   scatter_add_rows may use float atomics. So one launch holds two passes
//   that each own their output: a du block owns 64 rows of u and DC
//   columns of du and walks the candidate tiles; a dcand block owns 64
//   candidates and DC columns of dcand and walks the row tiles of u,
//   computing cand . u^T so that dlogit^T lies in accumulator layout. Each
//   tile recomputes the logits (16 warps of 16 x 32), forms dlogit in
//   registers (stage_dlogit, specialised by pass so that each row's and
//   column's staged data is read once) and stages it in shared memory in
//   the compute dtype (bf16 rounds it as fused_mha's bf16 backward rounds
//   ds), then multiplies it by the other side's rows, streamed through the
//   same ring in slices of DC columns (16 warps of 32 x DC / 8, DC / 8
//   float accumulators a thread: DC = 512 keeps D = 512 at one logit
//   product a pass). A pass
//   whose own tiles are too few to fill the card splits its walk, each
//   split writing a float partial that ce_sum_kernel adds in split order.
//   No atomics: two runs give the same bits.
// The block plan (splits, DC, shared memory) is ce_plan in
// ops/cuda/inbatch_ce.py; the entries check it and refuse any other.
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace idvs {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBO = 64;            // own rows of a block
constexpr int kBX = 128;           // other rows of a tile
constexpr int kFwdThreads = 256;   // 2 x 4 warps of 32 x 32 logits
constexpr int kBwdThreads = 512;   // 4 x 4 warps of 16 x 32 logits
constexpr int kMetaRows = 128;     // rows of either side a tile stages
constexpr float kMask = -1e4f;     // the reference's mask value
constexpr float kNegBig = -1e9f;   // running-max start; never a result

// The cp.async ring of a pass: its stages, the bytes of a logit slice's
// row and (backward) the other rows of a gradient slice. Fewer, larger
// steps measured faster (fewer barriers a tile, PERF.md), as far as the
// shared memory of the blocks an SM holds allows: the forward's two
// blocks an SM, the backward's one.
template <typename T>
struct FwdRing {
  static constexpr int stages = sizeof(T) == 2 ? 2 : 3;
  static constexpr int slice = sizeof(T) == 2 ? 256 : 128;
};
template <typename T>
struct BwdRing {
  static constexpr int stages = sizeof(T) == 2 ? 2 : 3;
  static constexpr int slice = sizeof(T) == 2 ? 512 : 256;
  static constexpr int rows = sizeof(T) == 2 ? 64 : 16;
};

// Shared-memory geometry of a compute dtype, a logit slice of SB bytes a
// row and gradient slices of KXR other rows, in elements of T.
template <typename T, int SB, int KXR = 0>
struct Tiles {
  static constexpr int E = sizeof(T);
  static constexpr int KD = SB / E;             // depth of a logit slice
  static constexpr int LDK = KD + 8;            // its row stride
  static constexpr int KX = KXR;                // other rows a gradient slice
  static constexpr int PADX = E == 2 ? 8 : 4;   // its row padding
  static constexpr int LDS = kBX + 8;           // dlogit's row stride
  static constexpr int logit_elems = (kBO + kBX) * LDK;
  __host__ __device__ static constexpr int LDX(int DC) { return DC + PADX; }
  __host__ __device__ static constexpr int grad_elems(int DC) {
    return KX * LDX(DC);
  }
  __host__ __device__ static constexpr int stage_elems(int DC) {
    return logit_elems > grad_elems(DC) ? logit_elems : grad_elems(DC);
  }
};

struct Problem {
  const void* u;          // (M, D) compute dtype
  const void* cand;       // (N, D) compute dtype
  const int* ids;         // (M / L, S) the local users' ids
  const int* cand_ids;    // (N)
  const float* colmask;   // (N)
  const float* logpop;    // (N)
  int M, N, D, L, S, label_off;
};

// users the rows of one staged tile can span
__host__ __device__ constexpr int max_users(int L) {
  return kMetaRows / L + 2;
}

// a user's staged ids: S rounded up to whole int4s
__host__ __device__ constexpr int ids_stride(int S) { return (S + 3) / 4 * 4; }

// 32-bit words of the staged tile data (a multiple of four)
__host__ __device__ constexpr int meta_words(int L, int S, bool fwd) {
  return 8 * kMetaRows + max_users(L) * (4 + ids_stride(S)) +
         (fwd ? 3 * 4 * kBO : 0);
}

// A tile's staged data: the u side's rows (label column, -1 beyond M; the
// user, counted from the tile's first; the backward's max, 1 / sum and
// weight), the candidate side's columns (id, -1 beyond N; mask; log
// popularity), the rejection bits, bit ci % 32 of word [user][ci / 32] set
// where column ci's id is among the user's ids, and the users' ids
// ([user][ids_stride(S)], -2 past S: no id); the forward's [3][4][kBO]
// partials of its four column warps.
struct Meta {
  int* lab;
  int* usr;
  float* m;
  float* il;
  float* ws;
  int* cid;
  float* cm;
  float* lp;
  unsigned* bits;
  int* sids;
  float* red;
};

__device__ __forceinline__ Meta carve_meta(int* w, int L, int S) {
  Meta t;
  t.lab = w;
  t.usr = w + kMetaRows;
  t.m = reinterpret_cast<float*>(w + 2 * kMetaRows);
  t.il = t.m + kMetaRows;
  t.ws = t.il + kMetaRows;
  t.cid = w + 5 * kMetaRows;
  t.cm = reinterpret_cast<float*>(w + 6 * kMetaRows);
  t.lp = t.cm + kMetaRows;
  t.bits = reinterpret_cast<unsigned*>(w + 8 * kMetaRows);
  t.sids = reinterpret_cast<int*>(t.bits + 4 * max_users(L));
  t.red = reinterpret_cast<float*>(t.sids + max_users(L) * ids_stride(S));
  return t;
}

// Stages the u side's rows ur0.. (nr of them) and the candidate side's
// columns cc0.. (nc); m, l, ws null in the forward. Returns the users the
// rows span.
__device__ int stage_meta(const Problem& p, const Meta& t, int ur0, int nr,
                          int cc0, int nc, const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ ws) {
  const int u0 = ur0 / p.L;
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const int r = ur0 + i;
    const bool in = r < p.M;
    t.lab[i] = in ? p.label_off + r / p.L * p.S + r % p.L + 1 : -1;
    t.usr[i] = in ? r / p.L - u0 : 0;
    if (m != nullptr) {
      t.m[i] = in ? m[r] : 0.f;
      t.il[i] = in ? 1.f / l[r] : 0.f;
      t.ws[i] = in ? ws[r] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const int c = cc0 + i;
    const bool in = c < p.N;
    t.cid[i] = in ? p.cand_ids[c] : -1;
    t.cm[i] = in ? p.colmask[c] : 0.f;
    t.lp[i] = in ? p.logpop[c] : 0.f;
  }
  const int users = (min(ur0 + nr, p.M) - 1) / p.L - u0 + 1;
  const int S4 = ids_stride(p.S);
  for (int i = threadIdx.x; i < users * S4; i += blockDim.x) {
    const int us = i / S4, k = i % S4;
    t.sids[i] = k < p.S ? p.ids[(u0 + us) * p.S + k] : -2;
  }
  return users;
}

// The rejection bits of `users` users by nc columns (nc a multiple of 32,
// so each warp's 32 pairs share a user and a word), after stage_meta.
__device__ void reject_bits(const Meta& t, int users, int nc, int S) {
  const int S4 = ids_stride(S);
  for (int i = threadIdx.x; i < users * nc; i += blockDim.x) {
    const int us = i / nc, ci = i % nc;
    const int id = t.cid[ci];
    const int4* s = reinterpret_cast<const int4*>(t.sids + us * S4);
    bool hit = false;
    for (int k = 0; k < S4 / 4; ++k) {
      const int4 v = s[k];
      hit |= (v.x == id) | (v.y == id) | (v.z == id) | (v.w == id);
    }
    const unsigned word = __ballot_sync(~0u, hit);
    if ((threadIdx.x & 31) == 0) t.bits[us * 4 + ci / 32] = word;
  }
}

// Whether the logit of u-side row ri and candidate-side column ci, whose
// global column is c, is masked to -1e4.
__device__ __forceinline__ bool masked(const Meta& t, int ri, int ci, int c) {
  if (t.cm[ci] == 0.f) return true;
  const bool rej = (t.bits[t.usr[ri] * 4 + (ci >> 5)] >> (ci & 31)) & 1u;
  return rej && c != t.lab[ri];
}

// exp: exact in float32 (held to float32's tolerances), fast in bf16
template <typename T>
__device__ __forceinline__ float ex(float x) {
  return sizeof(T) == 4 ? expf(x) : __expf(x);
}

// rows [r0, r0 + rows) by columns [k0, k0 + width) of the (n, D) matrix
// src into dst, a [rows][ld] tile, by 16-byte cp.async copies; zeros past
// n rows and D columns (width and k0 multiples of 16 bytes)
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld,
                                          const T* __restrict__ src, int rows,
                                          int n, int r0, int k0, int width,
                                          int D) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = width / EPC;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int row = i / cpr, k = i % cpr * EPC;
    const int r = r0 + row, d = k0 + k;
    const bool in = r < n && d < D;
    cp_async16_zfill(dst + row * ld + k,
                     in ? src + static_cast<size_t>(r) * D + d : src,
                     in ? 16 : 0);
  }
}

// One logit slice: acc += own rows [16 WM wm, +16 WM) . other rows [8 WN
// wn, +8 WN) over the slice's KD columns; st holds the kBO own rows, then
// the kBX other rows, [row][LDK]. bf16: ldmatrix fragments, m16n8k16.
template <int WM, int WN, int SB>
__device__ __forceinline__ void logit_step(float (&acc)[WM][WN][4],
                                           const bf16* st, int wm, int wn) {
  using G = Tiles<bf16, SB>;
  const int l = threadIdx.x & 31;
  const uint32_t a0 =
      smem_u32(st + (16 * WM * wm + a_row(l)) * G::LDK + a_col(l));
  const uint32_t b0 = smem_u32(st + (kBO + 8 * WN * wn + bn_row(l)) * G::LDK +
                               bn_col(l));
#pragma unroll
  for (int kk = 0; kk < G::KD / 16; ++kk) {
    uint32_t a[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i)
      ldsm_x4(a[i], a0 + (i * 16 * G::LDK + kk * 16) * 2);
#pragma unroll
    for (int n2 = 0; n2 < WN / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, b0 + (n2 * 16 * G::LDK + kk * 16) * 2);
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        mma_bf16(acc[i][2 * n2], a[i], b[0], b[1]);
        mma_bf16(acc[i][2 * n2 + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// float32: 3xTF32 on m16n8k8. Within an 8-deep step fragment column q is
// the slice's column 2q and column q + 4 is 2q + 1, for A and B alike (the
// sum over k does not mind the order), so each fragment pair is a float2.
template <int WM, int WN, int SB>
__device__ __forceinline__ void logit_step(float (&acc)[WM][WN][4],
                                           const float* st, int wm, int wn) {
  using G = Tiles<float, SB>;
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const float* A = st + (16 * WM * wm + g) * G::LDK + 2 * q;
  const float* B = st + (kBO + 8 * WN * wn + g) * G::LDK + 2 * q;
#pragma unroll
  for (int kk = 0; kk < G::KD / 8; ++kk) {
    uint32_t ab[WM][4], as[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      const float2 lo =
          *reinterpret_cast<const float2*>(A + i * 16 * G::LDK + 8 * kk);
      const float2 hi =
          *reinterpret_cast<const float2*>(A + (i * 16 + 8) * G::LDK + 8 * kk);
      const float a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[i][e], as[i][e]);
    }
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      const float2 bv =
          *reinterpret_cast<const float2*>(B + n * 8 * G::LDK + 8 * kk);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(bv.x, bb0, bs0);
      split_tf32(bv.y, bb1, bs1);
#pragma unroll
      for (int i = 0; i < WM; ++i)
        mma_3xtf32(acc[i][n], ab[i], as[i], bb0, bb1, bs0, bs1);
    }
  }
}

// One gradient slice: acc += dS rows [32 wr, +32) over its columns [kb, kb
// + KX) times the slice's KX other rows st ([k][LDX]), output columns [8
// NT wc, +8 NT) of the block's DC. bf16: dS by ldmatrix, the rows by
// ldmatrix.trans.
template <int NT, typename G>
__device__ __forceinline__ void grad_step(float (&acc)[2][NT][4],
                                          const bf16* dS, int kb,
                                          const bf16* st, int ldx, int wr,
                                          int wc) {
  const int l = threadIdx.x & 31;
  const uint32_t a0 =
      smem_u32(dS + (32 * wr + a_row(l)) * G::LDS + kb + a_col(l));
  const uint32_t b0 = smem_u32(st + bk_row(l) * ldx + 8 * NT * wc + bk_col(l));
#pragma unroll
  for (int kk = 0; kk < G::KX / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], a0 + (i * 16 * G::LDS + kk * 16) * 2);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4_t(b, b0 + (kk * 16 * ldx + n2 * 16) * 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * n2], a[i], b[0], b[1]);
        mma_bf16(acc[i][2 * n2 + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// float32: 3xTF32; dS's fragment pairs as float2 (columns 2q, 2q + 1 as
// fragment columns q, q + 4), so B reads the other rows 2q and 2q + 1
// (ldx = 4 mod 16 keeps those reads conflict-free).
template <int NT, typename G>
__device__ __forceinline__ void grad_step(float (&acc)[2][NT][4],
                                          const float* dS, int kb,
                                          const float* st, int ldx, int wr,
                                          int wc) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const float* A = dS + (32 * wr + g) * G::LDS + kb + 2 * q;
#pragma unroll
  for (int kk = 0; kk < G::KX / 8; ++kk) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 lo =
          *reinterpret_cast<const float2*>(A + i * 16 * G::LDS + 8 * kk);
      const float2 hi = *reinterpret_cast<const float2*>(
          A + (i * 16 + 8) * G::LDS + 8 * kk);
      const float a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[i][e], as[i][e]);
    }
    const float* b = st + (8 * kk + 2 * q) * ldx + 8 * NT * wc + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b[8 * n], bb0, bs0);
      split_tf32(b[ldx + 8 * n], bb1, bs1);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma_3xtf32(acc[i][n], ab[i], as[i], bb0, bb1, bs0, bs1);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

// Walks `total` steps through a ring of kStages stages: load(s, stage)
// fills stage s % kStages kStages - 1 steps ahead; work(s, stage) runs
// after a barrier that makes step s's copies (and everything written
// before it) visible, and before step s + 1's barrier, which frees its
// stage.
template <int kStages, typename T, typename Load, typename Work>
__device__ __forceinline__ void ring_walk(T* ring, int stage_elems, int total,
                                          Load load, Work work) {
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s, ring + s * stage_elems);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = s + kStages - 1;
    if (nx < total) load(nx, ring + (nx % kStages) * stage_elems);
    cp_async_commit();
    work(s, ring + (s % kStages) * stage_elems);
  }
  cp_async_wait<0>();
}

// grid (row tiles, splits): block (x, y) owns rows 64x.. and the column
// tiles [y * per, (y + 1) * per) and writes its rows' running max, sum and
// label logit to part[k][y][r] (k = 0, 1, 2).
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2)
    ce_fwd_kernel(Problem p, int per, float* __restrict__ part) {
  using R = FwdRing<T>;
  using G = Tiles<T, R::slice>;
  extern __shared__ __align__(16) unsigned char ce_smem[];
  T* ring = reinterpret_cast<T*>(ce_smem);
  const size_t ring_bytes = sizeof(T) * R::stages * G::logit_elems;
  const Meta t =
      carve_meta(reinterpret_cast<int*>(ce_smem + ring_bytes), p.L, p.S);
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int r0 = blockIdx.x * kBO;
  const int tiles = (p.N + kBX - 1) / kBX;
  const int t0 = blockIdx.y * per, t1 = min(tiles, t0 + per);
  const int nk = (p.D + G::KD - 1) / G::KD;
  const T* u = static_cast<const T*>(p.u);
  const T* cand = static_cast<const T*>(p.cand);

  // thread rows 32 wm + 16 i + g + 8 h; columns 32 wn + 8 n + 2 q + e
  float m_run[2][2], l_run[2][2], t_run[2][2], acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[i][h] = kNegBig;
      l_run[i][h] = t_run[i][h] = 0.f;
    }
  ring_walk<R::stages>(
      ring, G::logit_elems, (t1 - t0) * nk,
      [&](int s, T* st) {
        const int k0 = s % nk * G::KD;
        copy_rows(st, G::LDK, u, kBO, p.M, r0, k0, G::KD, p.D);
        copy_rows(st + kBO * G::LDK, G::LDK, cand, kBX, p.N,
                  (t0 + s / nk) * kBX, k0, G::KD, p.D);
      },
      [&](int s, const T* st) {
        const int j = s % nk, c0 = (t0 + s / nk) * kBX;
        if (j == 0) {
          const int users =
              stage_meta(p, t, r0, kBO, c0, kBX, nullptr, nullptr, nullptr);
          __syncthreads();
          reject_bits(t, users, kBX, p.S);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
        }
        logit_step<2, 4, R::slice>(acc, st, wm, wn);
        if (j != nk - 1) return;
        __syncthreads();   // the rejection bits
        // the thread's 8 columns 32 wn + 8 n + 2 q + e: x = acc * cmul +
        // cadd is the logit, the mask value (colmask 0) or no term (past N)
        float cmul[4][2], cadd[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = 32 * wn + 8 * n + 2 * q + e;
            const bool in = c0 + ci < p.N, on = in && t.cm[ci] != 0.f;
            cmul[n][e] = on ? 1.f : 0.f;
            cadd[n][e] = on ? -t.lp[ci] : in ? kMask : -INFINITY;
          }
        const int cb = c0 + 32 * wn + 2 * q;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ri = 32 * wm + 16 * i + g + 8 * h;
            // bit 8 n + e: the column's id is among the row's user's ids;
            // the label sits at element 8 n + e = lab (if it is this
            // thread's) and is exempt
            const unsigned word = t.bits[t.usr[ri] * 4 + wn] >> (2 * q);
            const int lab = t.lab[ri] - cb;
            float v[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = 8 * n + e;
                float x = fmaf(acc[i][n][2 * h + e], cmul[n][e], cadd[n][e]);
                if (((word >> k) & 1u) && lab != k) x = kMask;
                if (lab == k) t_run[i][h] += x;
                v[n][e] = x;
              }
            float tmax = fmaxf(fmaxf(fmaxf(v[0][0], v[0][1]),
                                     fmaxf(v[1][0], v[1][1])),
                               fmaxf(fmaxf(v[2][0], v[2][1]),
                                     fmaxf(v[3][0], v[3][1])));
            const float m_new = fmaxf(m_run[i][h], quad_max(tmax));
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n)
              sum += ex<T>(v[n][0] - m_new) + ex<T>(v[n][1] - m_new);
            l_run[i][h] = l_run[i][h] * ex<T>(m_run[i][h] - m_new) + sum;
            m_run[i][h] = m_new;
          }
      });
  // the column warps' partials, merged in order 0..3
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ls = quad_sum(l_run[i][h]), ts = quad_sum(t_run[i][h]);
      if (q == 0) {
        const int ri = 32 * wm + 16 * i + g + 8 * h;
        t.red[(0 * 4 + wn) * kBO + ri] = m_run[i][h];
        t.red[(1 * 4 + wn) * kBO + ri] = ls;
        t.red[(2 * 4 + wn) * kBO + ri] = ts;
      }
    }
  __syncthreads();
  const int ri = threadIdx.x, r = r0 + ri;
  if (ri >= kBO || r >= p.M) return;
  float m = kNegBig;
  for (int w = 0; w < 4; ++w) m = fmaxf(m, t.red[w * kBO + ri]);
  float ls = 0.f, ts = 0.f;
  for (int w = 0; w < 4; ++w) {
    ls += t.red[(4 + w) * kBO + ri] * ex<T>(t.red[w * kBO + ri] - m);
    ts += t.red[(8 + w) * kBO + ri];
  }
  const size_t stride = static_cast<size_t>(gridDim.y) * p.M;
  const size_t at = static_cast<size_t>(blockIdx.y) * p.M + r;
  part[at] = m;
  part[stride + at] = ls;
  part[2 * stride + at] = ts;
}

// ce, m and l of each row from the splits' partials, merged in split order.
__global__ void ce_merge_kernel(const float* __restrict__ part, int splits,
                                int M, float* __restrict__ ce,
                                float* __restrict__ m_out,
                                float* __restrict__ l_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const size_t stride = static_cast<size_t>(splits) * M;
  float m = kNegBig;
  for (int y = 0; y < splits; ++y)
    m = fmaxf(m, part[static_cast<size_t>(y) * M + r]);
  float l = 0.f, t = 0.f;
  for (int y = 0; y < splits; ++y) {
    const size_t at = static_cast<size_t>(y) * M + r;
    l += part[stride + at] * expf(part[at] - m);
    t += part[2 * stride + at];
  }
  ce[r] = logf(l) + m - t;
  m_out[r] = m;
  l_out[r] = l;
}

// The backward's plan: each pass's other tiles are split into `splits`
// ranges of `per` tiles (u pass: candidate tiles; c pass: row tiles).
struct BwdPlan {
  int per_u, splits_u, per_c, splits_c;
};

__device__ __forceinline__ void store_pair(bf16* at, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* at, float x, float y) {
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}

// dlogit of the warp's 16 x 32 piece of the logit tile, own rows 16 wm + g
// + 8 h by other rows 32 wn + 8 n + 2 q + e, into dS in the compute dtype:
// 0 at a masked logit and beyond the data. kC: the own side is the
// candidates (the dcand pass), else u's rows. The u side's rows and the
// candidate side's columns are staged at ur0 and cc0.
template <bool kC, typename T>
__device__ __forceinline__ void stage_dlogit(const float (&acc)[1][4][4],
                                             T* dS, const Meta& t,
                                             const Problem& p, int ur0,
                                             int cc0, int wm, int wn) {
  using G = Tiles<T, BwdRing<T>::slice>;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  // the u side's rows and the candidate side's columns of the thread: two
  // own (h), eight other (n, e)
  constexpr int NR = kC ? 8 : 2, NCOL = kC ? 2 : 8;
  auto row_of = [&](int h, int n, int e) {
    return kC ? 32 * wn + 8 * n + 2 * q + e : 16 * wm + g + 8 * h;
  };
  auto col_of = [&](int h, int n, int e) {
    return kC ? 16 * wm + g + 8 * h : 32 * wn + 8 * n + 2 * q + e;
  };
  float mr[NR], il[NR], ws[NR];
  int lab[NR];
  unsigned word[NR];
  bool rin[NR];
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int ri = kC ? row_of(0, a / 2, a % 2) : row_of(a, 0, 0);
    rin[a] = ur0 + ri < p.M;
    mr[a] = t.m[ri];
    il[a] = t.il[ri];
    ws[a] = t.ws[ri];
    lab[a] = t.lab[ri];
    // the rejection bits of the row's user at the thread's columns
    word[a] = t.bits[t.usr[ri] * 4 + (kC ? (16 * wm) >> 5 : wn)];
  }
  float lp[NCOL];
  bool on[NCOL];
#pragma unroll
  for (int b = 0; b < NCOL; ++b) {
    const int ci = kC ? col_of(b, 0, 0) : col_of(0, b / 2, b % 2);
    on[b] = cc0 + ci < p.N && t.cm[ci] != 0.f;
    lp[b] = t.lp[ci];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = 16 * wm + g + 8 * h;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int x = 32 * wn + 8 * n + 2 * q;
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = kC ? 2 * n + e : h, b = kC ? h : 2 * n + e;
        const int ci = col_of(h, n, e), c = cc0 + ci;
        const bool rej = ((word[a] >> (ci & 31)) & 1u) && c != lab[a];
        const float pr = ex<T>(acc[0][n][2 * h + e] - lp[b] - mr[a]) * il[a];
        d[e] = rin[a] && on[b] && !rej ? (c == lab[a] ? pr - 1.f : pr) * ws[a]
                                       : 0.f;
      }
      store_pair(dS + o * G::LDS + x, d[0], d[1]);
    }
  }
}

// grid (u blocks + c blocks): block b < nb_u = tiles_u * splits_u * chunks
// owns 64 rows of u and DC columns of du, the others 64 candidates and DC
// columns of dcand; b = (chunk * splits + split) * own tiles + own tile.
// A split of a pass with splits > 1 writes its float partial to part_u or
// part_c ([split][rows][D]), else the compute dtype to du or dcand.
template <typename T, int DC>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ce_bwd_kernel(Problem p, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ ws,
                  T* __restrict__ du, T* __restrict__ dcand,
                  float* __restrict__ part_u, float* __restrict__ part_c,
                  BwdPlan k) {
  using R = BwdRing<T>;
  using G = Tiles<T, R::slice, R::rows>;
  constexpr int NT = DC / 64, LDX = G::LDX(DC), SE = G::stage_elems(DC);
  extern __shared__ __align__(16) unsigned char ce_smem[];
  T* ring = reinterpret_cast<T*>(ce_smem);
  T* dS = ring + R::stages * SE;   // [kBO][LDS] own x other
  const Meta t =
      carve_meta(reinterpret_cast<int*>(dS + kBO * G::LDS), p.L, p.S);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;   // logits: 4 x 4 of 16 x 32
  const int wr = warp >> 3, wc = warp & 7;   // gradient: 2 x 8 of 32 x DC/8
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int chunks = (p.D + DC - 1) / DC;
  const int own_u = (p.M + kBO - 1) / kBO, own_c = (p.N + kBO - 1) / kBO;
  const int nb_u = own_u * k.splits_u * chunks;
  const bool cpass = static_cast<int>(blockIdx.x) >= nb_u;
  const int b = cpass ? blockIdx.x - nb_u : blockIdx.x;
  const int own_tiles = cpass ? own_c : own_u;
  const int splits = cpass ? k.splits_c : k.splits_u;
  const int per = cpass ? k.per_c : k.per_u;
  const int sp = b / own_tiles % splits;
  const int o0 = b % own_tiles * kBO, d0 = b / (own_tiles * splits) * DC;
  const int n_own = cpass ? p.N : p.M, n_other = cpass ? p.M : p.N;
  const int tiles = (n_other + kBX - 1) / kBX;
  const int t0 = sp * per, t1 = min(tiles, t0 + per);
  const T* own = static_cast<const T*>(cpass ? p.cand : p.u);
  const T* other = static_cast<const T*>(cpass ? p.u : p.cand);
  const int nk = (p.D + G::KD - 1) / G::KD, span = nk + kBX / G::KX;

  float acc[1][4][4], acc2[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc2[i][n][0] = acc2[i][n][1] = acc2[i][n][2] = acc2[i][n][3] = 0.f;
  ring_walk<R::stages>(
      ring, SE, (t1 - t0) * span,
      [&](int s, T* st) {
        const int x0 = (t0 + s / span) * kBX, j = s % span;
        if (j < nk) {
          copy_rows(st, G::LDK, own, kBO, n_own, o0, j * G::KD, G::KD, p.D);
          copy_rows(st + kBO * G::LDK, G::LDK, other, kBX, n_other, x0,
                    j * G::KD, G::KD, p.D);
        } else {
          copy_rows(st, LDX, other, G::KX, n_other, x0 + (j - nk) * G::KX,
                    d0, DC, p.D);
        }
      },
      [&](int s, const T* st) {
        const int x0 = (t0 + s / span) * kBX, j = s % span;
        if (j >= nk) {
          grad_step<NT, G>(acc2, dS, (j - nk) * G::KX, st, LDX, wr, wc);
          return;
        }
        const int ur0 = cpass ? x0 : o0, cc0 = cpass ? o0 : x0;
        if (j == 0) {
          const int users = stage_meta(p, t, ur0, cpass ? kBX : kBO, cc0,
                                       cpass ? kBO : kBX, m, l, ws);
          __syncthreads();
          reject_bits(t, users, cpass ? kBO : kBX, p.S);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            acc[0][n][0] = acc[0][n][1] = acc[0][n][2] = acc[0][n][3] = 0.f;
        }
        logit_step<1, 4, R::slice>(acc, st, wm, wn);
        if (j != nk - 1) return;
        __syncthreads();   // the rejection bits
        if (cpass)
          stage_dlogit<true>(acc, dS, t, p, ur0, cc0, wm, wn);
        else
          stage_dlogit<false>(acc, dS, t, p, ur0, cc0, wm, wn);
      });
  // rows 32 wr + 16 i + g + 8 h, columns d0 + 8 NT wc + 8 n + 2 q
  float* part = cpass ? part_c : part_u;
  T* out = cpass ? dcand : du;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + 32 * wr + 16 * i + g + 8 * h;
      if (o >= n_own) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = d0 + 8 * NT * wc + 8 * n + 2 * q;
        if (d >= p.D) continue;
        const size_t at = static_cast<size_t>(o) * p.D + d;
        const float x = acc2[i][n][2 * h], y = acc2[i][n][2 * h + 1];
        if (splits > 1)
          store_pair(part + static_cast<size_t>(sp) * n_own * p.D + at, x, y);
        else
          store_pair(out + at, x, y);
      }
    }
}

// out[i] = the splits' partials of element i added in split order, cast
// once to the compute dtype
template <typename T>
__global__ void ce_sum_kernel(const float* __restrict__ part, int splits,
                              size_t n, T* __restrict__ out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int y = 0; y < splits; ++y) s += part[y * n + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T>
size_t fwd_smem(int L, int S) {
  using R = FwdRing<T>;
  return sizeof(T) * R::stages * Tiles<T, R::slice>::logit_elems +
         4 * meta_words(L, S, true);
}

template <typename T>
size_t bwd_smem(int DC, int L, int S) {
  using R = BwdRing<T>;
  using G = Tiles<T, R::slice, R::rows>;
  return sizeof(T) * (R::stages * G::stage_elems(DC) + kBO * G::LDS) +
         4 * meta_words(L, S, false);
}

bool valid(const Problem& p) {
  return p.M >= 1 && p.N >= 1 && p.L >= 1 && p.S == p.L + 1 &&
         p.M % p.L == 0 && p.D >= 16 && p.D % 16 == 0 && p.label_off >= 0;
}

// `splits` ranges of `per` of `tiles` tiles, none empty
bool covers(int tiles, int per, int splits) {
  return per >= 1 && splits >= 1 && (splits - 1) * per < tiles &&
         splits * per >= tiles;
}

template <typename T>
cudaError_t launch_fwd(const Problem& p, int per, int splits, float* part,
                       float* ce, float* m, float* l, cudaStream_t st) {
  const size_t smem = fwd_smem<T>(p.L, p.S);
  cudaError_t err = allow_smem(ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kBO - 1) / kBO, splits);
  ce_fwd_kernel<T><<<grid, kFwdThreads, smem, st>>>(p, per, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(p.M + 255) / 256, 256, 0, st>>>(part, splits, p.M, ce,
                                                     m, l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sum_partials(const float* part, int splits, size_t n, void* out,
                         cudaStream_t st) {
  if (splits <= 1) return cudaSuccess;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  ce_sum_kernel<T><<<blocks, 256, 0, st>>>(part, splits, n,
                                           static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_bwd_dc(const Problem& p, const float* m, const float* l,
                          const float* ws, void* du, void* dcand,
                          float* part_u, float* part_c, const BwdPlan& k,
                          size_t smem, cudaStream_t st) {
  auto kernel = ce_bwd_kernel<T, DC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p.D + DC - 1) / DC;
  const int blocks = (((p.M + kBO - 1) / kBO) * k.splits_u +
                      ((p.N + kBO - 1) / kBO) * k.splits_c) * chunks;
  kernel<<<blocks, kBwdThreads, smem, st>>>(
      p, m, l, ws, static_cast<T*>(du), static_cast<T*>(dcand), part_u,
      part_c, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_partials<T>(part_u, k.splits_u,
                        static_cast<size_t>(p.M) * p.D, du, st);
  if (err != cudaSuccess) return err;
  return sum_partials<T>(part_c, k.splits_c,
                         static_cast<size_t>(p.N) * p.D, dcand, st);
}

template <typename T>
cudaError_t launch_bwd(const Problem& p, const float* m, const float* l,
                       const float* ws, void* du, void* dcand, float* part_u,
                       float* part_c, int dc, const BwdPlan& k, size_t smem,
                       cudaStream_t st) {
  if (smem != bwd_smem<T>(dc, p.L, p.S) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  switch (dc) {
    case 128:
      return launch_bwd_dc<T, 128>(p, m, l, ws, du, dcand, part_u, part_c, k,
                                   smem, st);
    case 256:
      return launch_bwd_dc<T, 256>(p, m, l, ws, du, dcand, part_u, part_c, k,
                                   smem, st);
    case 512:
      return launch_bwd_dc<T, 512>(p, m, l, ws, du, dcand, part_u, part_c, k,
                                   smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace idvs

// Forward of the in-batch CE. u (M, D) and cand (N, D) in the compute
// dtype; ids (M / L, S), cand_ids (N) int32; colmask, logpop (N) float.
// The plan (ce_plan): the column tiles of 128 split over `splits` blocks a
// row tile of 64, `per` tiles each (no split empty), and the block's
// shared-memory bytes `smem`; part holds 3 * splits * M floats. Writes ce,
// m and l (M) in float.
extern "C" int idvs_inbatch_ce_fwd(const void* u, const void* cand,
                                   const int* ids, const int* cand_ids,
                                   const float* colmask, const float* logpop,
                                   float* part, float* ce, float* m, float* l,
                                   int M, int N, int D, int L, int S,
                                   int label_off, int per, int splits,
                                   long long smem, int dtype, void* stream) {
  using namespace idvs;
  const Problem p{u, cand, ids, cand_ids, colmask, logpop,
                  M, N, D, L, S, label_off};
  if (!valid(p) || !covers((N + kBX - 1) / kBX, per, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t want = dtype == kF32    ? fwd_smem<float>(L, S)
                      : dtype == kBF16 ? fwd_smem<__nv_bfloat16>(L, S)
                                       : 0;
  if (want == 0 || smem != static_cast<long long>(want) || want > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return static_cast<int>(
        launch_fwd<float>(p, per, splits, part, ce, m, l, st));
  return static_cast<int>(
      launch_fwd<__nv_bfloat16>(p, per, splits, part, ce, m, l, st));
}

// Backward of the in-batch CE: the forward's operands, its m and l, and
// ws (M) = w * g / n_valid in float; writes du (M, D) and dcand (N, D) in
// the compute dtype. The plan (ce_plan): dc gradient columns a block (128,
// 256 or 512), the u pass's candidate tiles of 128 split into splits_u
// ranges of per_u, the c pass's row tiles into splits_c of per_c, and the
// block's shared-memory bytes; part_u (splits_u * M * D floats) and part_c
// (splits_c * N * D) are needed only where their splits exceed 1.
extern "C" int idvs_inbatch_ce_bwd(
    const void* u, const void* cand, const int* ids, const int* cand_ids,
    const float* colmask, const float* logpop, const float* m,
    const float* l, const float* ws, void* du, void* dcand, float* part_u,
    float* part_c, int M, int N, int D, int L, int S, int label_off, int dc,
    int per_u, int splits_u, int per_c, int splits_c, long long smem,
    int dtype, void* stream) {
  using namespace idvs;
  const Problem p{u, cand, ids, cand_ids, colmask, logpop,
                  M, N, D, L, S, label_off};
  const BwdPlan k{per_u, splits_u, per_c, splits_c};
  if (!valid(p) || !covers((N + kBX - 1) / kBX, per_u, splits_u) ||
      !covers((M + kBX - 1) / kBX, per_c, splits_c) ||
      (splits_u > 1 && part_u == nullptr) ||
      (splits_c > 1 && part_c == nullptr) || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (dtype == kF32)
    return static_cast<int>(launch_bwd<float>(p, m, l, ws, du, dcand, part_u,
                                              part_c, dc, k, bytes, st));
  if (dtype == kBF16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(
        p, m, l, ws, du, dcand, part_u, part_c, dc, k, bytes, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// the text flagship's M 2560 x N 2688 x D 512) against a few MB of
// operands: compute-bound, on the float FMA units here (parity with the
// float32 composition; bf16 operands are widened on load, as the TPU
// kernel widens them). Design: the logit tile is tile.cuh's register tile,
// 32 rows a block by 128 columns a step, 256 threads of 4 x 4, the K = D
// walk in 16-deep slices double-buffered through shared memory.
// - Forward: a block owns 32 rows and walks a contiguous range of column
//   tiles with a running max, sum and label logit a row (one warp owns 4
//   rows, so a row's reductions are warp shuffles). Too few row tiles fill
//   the card at these shapes, so the columns are split over `splits`
//   blocks and a second kernel merges their (m, l, t) in split order.
// - Backward: the TPU kernel sums dcand over row tiles in its sequential
//   grid; blocks here run in parallel and in no order, and only
//   scatter_add_rows may use float atomics. So the backward is two passes
//   in one launch, each owning its output: a du block owns 32 rows of u and
//   512 columns of du and walks every candidate tile; a dcand block owns 32
//   candidates and walks every row tile. Each recomputes its logit tiles
//   (one product more than the TPU kernel; at D > 512 once per 512
//   columns), stages dlogit in shared memory and multiplies it with the
//   other side's rows. Two runs give the same bits.
#include "common.cuh"
#include "tile.cuh"

namespace idvs {
namespace {

using rowtile::load4;
using rowtile::store4;

constexpr int kThreads = 256;
constexpr int TX = 32, TY = 8;      // thread grid of a logit tile
constexpr int BO = 4 * TY;          // rows a block owns (32)
constexpr int BX = 4 * TX;          // rows of the other side a step (128)
constexpr int KB = 16;              // depth of a logit slice
constexpr int LDO = BO + 4, LDX = BX + 4;
constexpr int DC = 512;             // gradient columns a block owns
constexpr int NG2 = DC / BX;        // 4-column groups a thread owns there
constexpr int KB2 = 8;              // other-side rows a gradient slice
constexpr float kMask = -1e4f;      // the reference's mask value
constexpr float kNegBig = -1e9f;    // running-max start; never a result

struct Problem {
  const void* u;          // (M, D) compute dtype
  const void* cand;       // (N, D) compute dtype
  const int* ids;         // (M / L, S) the local users' ids
  const int* cand_ids;    // (N)
  const float* colmask;   // (N)
  const float* logpop;    // (N)
  int M, N, D, L, S, label_off;
};

// Per-row data of the u side of a tile and per-column data of the
// candidate side, staged in shared memory.
struct Stage {
  int* lab;     // [BX] label column of the row, -1 beyond M
  int* usr;     // [BX] the row's user, counted from the tile's first
  float* m;     // [BX] backward: the row's max, sum and weight
  float* l;
  float* ws;
  int* cid;     // [BX] candidate id
  float* cm;    // [BX] candidate column mask
  float* lp;    // [BX] candidate log popularity
  int* sids;    // [(BX / L + 2) * S] the ids of the tile's users
  int* own;     // [BO] own rows (-1 beyond the data), ASlice's row_of
  int* other;   // [BX] other-side rows of the current step
};

__device__ __forceinline__ Stage carve(int* base) {
  Stage s;
  s.lab = base;
  s.usr = s.lab + BX;
  s.cid = s.usr + BX;
  s.own = s.cid + BX;
  s.other = s.own + BO;
  float* f = reinterpret_cast<float*>(s.other + BX);
  s.m = f;
  s.l = s.m + BX;
  s.ws = s.l + BX;
  s.cm = s.ws + BX;
  s.lp = s.cm + BX;
  s.sids = reinterpret_cast<int*>(s.lp + BX);
  return s;
}

// ints and floats of a Stage (kept a multiple of 4 for float4 alignment)
__host__ __device__ constexpr int stage_words(int S, int L) {
  return ((9 * BX + BO + (BX / L + 2) * S) + 3) / 4 * 4;
}

__device__ void stage_rows(const Problem& p, const Stage& s, int r0, int n,
                           const float* m, const float* l, const float* ws) {
  const int u0 = r0 / p.L;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int r = r0 + t;
    if (r < p.M) {
      const int i = r / p.L;
      s.lab[t] = p.label_off + i * p.S + r % p.L + 1;
      s.usr[t] = i - u0;
      if (m != nullptr) {
        s.m[t] = m[r];
        s.l[t] = l[r];
        s.ws[t] = ws[r];
      }
    } else {
      s.lab[t] = -1;
      s.usr[t] = 0;
      if (m != nullptr) {
        s.m[t] = 0.f;
        s.l[t] = 1.f;
        s.ws[t] = 0.f;
      }
    }
  }
  const int u1 = (min(r0 + n, p.M) - 1) / p.L;
  for (int t = threadIdx.x; t < (u1 - u0 + 1) * p.S; t += blockDim.x)
    s.sids[t] = p.ids[u0 * p.S + t];
}

__device__ void stage_cols(const Problem& p, const Stage& s, int c0, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int c = c0 + t;
    const bool in = c < p.N;
    s.cid[t] = in ? p.cand_ids[c] : -1;
    s.cm[t] = in ? p.colmask[c] : 0.f;
    s.lp[t] = in ? p.logpop[c] : 0.f;
  }
}

__device__ void row_list(int* rows, int r0, int n, int total) {
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    rows[t] = r0 + t < total ? r0 + t : -1;
}

// Whether the logit of u-side row rt and candidate ct (tile-local), whose
// global column is c, is masked to -1e4.
__device__ __forceinline__ bool is_masked(const Stage& s, int S, int rt,
                                          int ct, int c) {
  if (s.cm[ct] == 0.f) return true;
  const int* uid = s.sids + s.usr[rt] * S;
  const int id = s.cid[ct];
  bool rej = false;
  for (int k = 0; k < S; ++k) rej |= uid[k] == id;
  return rej && c != s.lab[rt];
}

// acc = own[own rows] . other[other rows] over K = D, in KB-deep slices
// double-buffered through Ot / Xt (tile.cuh's register tile: thread
// (ty, tx) owns own rows 4ty.. and other rows 4tx..).
template <typename T>
__device__ void logit_tile(float (&acc)[4][4], const T* __restrict__ own,
                           const T* __restrict__ other,
                           tile::ASlice<T, KB, 1>& ao,
                           tile::ASlice<T, KB, 2>& ax, float* Ot, float* Xt,
                           int D) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  ao.load(own, 0);
  ax.load(other, 0);
  ao.store(Ot, LDO);
  ax.store(Xt, LDX);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += KB) {
    const bool more = k0 + KB < D;
    if (more) {
      ao.load(own, k0 + KB);
      ax.load(other, k0 + KB);
    }
    tile::fma_tile<1, KB>(acc, Ot + buf * KB * LDO, LDO, Xt + buf * KB * LDX,
                          LDX, 4 * ty, 4 * tx, BX);
    if (more) {
      ao.store(Ot + (buf ^ 1) * KB * LDO, LDO);
      ax.store(Xt + (buf ^ 1) * KB * LDX, LDX);
    }
    __syncthreads();
    buf ^= 1;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// grid (row tiles, splits): block (x, y) owns rows 32x.. and the column
// tiles [y * per, (y + 1) * per) and writes its rows' running max, sum and
// label logit to part[k][y][r] (k = 0, 1, 2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(Problem p, int per, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* Ot = reinterpret_cast<float*>(smem4);
  float* Xt = Ot + 2 * KB * LDO;
  const Stage s = carve(reinterpret_cast<int*>(Xt + 2 * KB * LDX));
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int r0 = blockIdx.x * BO;
  const int tiles = (p.N + BX - 1) / BX;
  const int t_begin = blockIdx.y * per, t_end = min(tiles, t_begin + per);
  const T* u = static_cast<const T*>(p.u);
  const T* cand = static_cast<const T*>(p.cand);

  row_list(s.own, r0, BO, p.M);
  stage_rows(p, s, r0, BO, nullptr, nullptr, nullptr);
  __syncthreads();
  tile::ASlice<T, KB, 1> ao;
  ao.init(s.own, BO, p.D, LDO);

  float m_run[4], l_run[4], t_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegBig;
    l_run[i] = 0.f;
    t_run[i] = 0.f;
  }
  float acc[4][4];
  for (int tile_i = t_begin; tile_i < t_end; ++tile_i) {
    const int c0 = tile_i * BX;
    __syncthreads();   // the last step's epilogue is done with the stage
    row_list(s.other, c0, BX, p.N);
    stage_cols(p, s, c0, BX);
    __syncthreads();
    tile::ASlice<T, KB, 2> ax;
    ax.init(s.other, BX, p.D, LDX);
    logit_tile<T>(acc, u, cand, ao, ax, Ot, Xt, p.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rt = 4 * ty + i;
      float v[4];
      float tmax = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ct = 4 * tx + j, c = c0 + ct;
        v[j] = is_masked(s, p.S, rt, ct, c) ? kMask : acc[i][j] - s.lp[ct];
        if (c < p.N) {
          tmax = fmaxf(tmax, v[j]);
          if (c == s.lab[rt]) t_run[i] += v[j];
        }
      }
      const float m_new = fmaxf(m_run[i], warp_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + 4 * tx + j < p.N) sum += expf(v[j] - m_new);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + warp_sum(sum);
      m_run[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = warp_sum(t_run[i]);
    const int r = r0 + 4 * ty + i;
    if (tx == 0 && r < p.M) {
      const size_t stride = static_cast<size_t>(gridDim.y) * p.M;
      const size_t at = static_cast<size_t>(blockIdx.y) * p.M + r;
      part[at] = m_run[i];
      part[stride + at] = l_run[i];
      part[2 * stride + at] = t;
    }
  }
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

// A [KB2][DC] slice of the other side's rows x0.. and columns d0.., zeros
// beyond n rows or D columns, staged in registers.
template <typename T>
struct RowSlice {
  static constexpr int kQuads = DC / 4;
  static constexpr int kPer = KB2 * kQuads / kThreads;
  float4 v[kPer];
  __device__ void load(const T* __restrict__ X, int n, int D, int x0,
                       int d0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int x = x0 + i / kQuads, d = d0 + 4 * (i % kQuads);
      v[q] = (x < n && d < D)
                 ? load4(X + static_cast<size_t>(x) * D + d)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ void store(float* Bs) const {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = threadIdx.x + q * kThreads;
      *reinterpret_cast<float4*>(Bs + (i / kQuads) * DC +
                                 4 * (i % kQuads)) = v[q];
    }
  }
};

// grid (tiles_u + tiles_c, D chunks): blocks below tiles_u own 32 rows of
// u and write du; the others own 32 candidates and write dcand. y picks
// the 512 gradient columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(Problem p, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ ws,
                  T* __restrict__ du, T* __restrict__ dcand, int tiles_u) {
  extern __shared__ float4 smem4[];
  float* Ot = reinterpret_cast<float*>(smem4);
  float* Xt = Ot + 2 * KB * LDO;
  float* dSt = Xt + 2 * KB * LDX;      // [BX][LDO] dlogit, other-major
  float* Bs = dSt + BX * LDO;          // [2][KB2][DC]
  const Stage s = carve(reinterpret_cast<int*>(Bs + 2 * KB2 * DC));
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const bool cpass = blockIdx.x >= tiles_u;   // owns candidates
  const int o0 = (cpass ? blockIdx.x - tiles_u : blockIdx.x) * BO;
  const int d0 = blockIdx.y * DC;
  const int n_own = cpass ? p.N : p.M, n_other = cpass ? p.M : p.N;
  const T* own = static_cast<const T*>(cpass ? p.cand : p.u);
  const T* other = static_cast<const T*>(cpass ? p.u : p.cand);

  row_list(s.own, o0, BO, n_own);
  if (cpass)
    stage_cols(p, s, o0, BO);
  else
    stage_rows(p, s, o0, BO, m, l, ws);
  __syncthreads();
  tile::ASlice<T, KB, 1> ao;
  ao.init(s.own, BO, p.D, LDO);

  float acc2[4][4 * NG2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG2; ++j) acc2[i][j] = 0.f;
  float acc[4][4];
  RowSlice<T> rs;
  for (int x0 = 0; x0 < n_other; x0 += BX) {
    __syncthreads();   // the last step is done with the stage and Bs
    row_list(s.other, x0, BX, n_other);
    if (cpass)
      stage_rows(p, s, x0, BX, m, l, ws);
    else
      stage_cols(p, s, x0, BX);
    __syncthreads();
    tile::ASlice<T, KB, 2> ax;
    ax.init(s.other, BX, p.D, LDX);
    logit_tile<T>(acc, own, other, ao, ax, Ot, Xt, p.D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ot = 4 * ty + i, xt = 4 * tx + j;
        const int rt = cpass ? xt : ot, ct = cpass ? ot : xt;
        const int r = (cpass ? x0 : o0) + rt, c = (cpass ? o0 : x0) + ct;
        // a masked logit is a constant: no gradient flows through it
        float ds = 0.f;
        if (r < p.M && c < p.N && !is_masked(s, p.S, rt, ct, c)) {
          const float v = acc[i][j] - s.lp[ct];
          const float prob = expf(v - s.m[rt]) / s.l[rt];
          ds = (prob - (c == s.lab[rt] ? 1.f : 0.f)) * s.ws[rt];
        }
        dSt[xt * LDO + ot] = ds;
      }
    }
    const int x_end = min(BX, n_other - x0);
    rs.load(other, n_other, p.D, x0, d0);
    rs.store(Bs);
    __syncthreads();
    int buf = 0;
    for (int xs = 0; xs < x_end; xs += KB2) {
      const bool more = xs + KB2 < x_end;
      if (more) rs.load(other, n_other, p.D, x0 + xs + KB2, d0);
      tile::fma_tile<NG2, KB2>(acc2, dSt + xs * LDO, LDO,
                               Bs + buf * KB2 * DC, DC, 4 * ty, 4 * tx, BX);
      if (more) rs.store(Bs + (buf ^ 1) * KB2 * DC);
      __syncthreads();
      buf ^= 1;
    }
  }
  T* out = cpass ? dcand : du;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + 4 * ty + i;
    if (o >= n_own) continue;
#pragma unroll
    for (int j = 0; j < NG2; ++j) {
      const int d = d0 + 4 * tx + BX * j;
      if (d < p.D)
        store4(out + static_cast<size_t>(o) * p.D + d,
               make_float4(acc2[i][4 * j + 0], acc2[i][4 * j + 1],
                           acc2[i][4 * j + 2], acc2[i][4 * j + 3]));
    }
  }
}

size_t fwd_smem(int S, int L) {
  return 4 * (2 * KB * LDO + 2 * KB * LDX + stage_words(S, L));
}

size_t bwd_smem(int S, int L) {
  return 4 * (2 * KB * LDO + 2 * KB * LDX + BX * LDO + 2 * KB2 * DC +
              stage_words(S, L));
}

bool valid(const Problem& p) {
  return p.M >= 1 && p.N >= 1 && p.L >= 1 && p.S == p.L + 1 &&
         p.M % p.L == 0 && p.D >= KB && p.D % KB == 0 && p.label_off >= 0;
}

template <typename T>
cudaError_t launch_fwd(const Problem& p, int per, int splits, float* part,
                       float* ce, float* m, float* l, cudaStream_t st) {
  const size_t smem = fwd_smem(p.S, p.L);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + BO - 1) / BO, splits);
  ce_fwd_kernel<T><<<grid, kThreads, smem, st>>>(p, per, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(p.M + 255) / 256, 256, 0, st>>>(part, splits, p.M, ce,
                                                     m, l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Problem& p, const float* m, const float* l,
                       const float* ws, void* du, void* dcand,
                       cudaStream_t st) {
  const size_t smem = bwd_smem(p.S, p.L);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ce_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_u = (p.M + BO - 1) / BO, tiles_c = (p.N + BO - 1) / BO;
  const dim3 grid(tiles_u + tiles_c, (p.D + DC - 1) / DC);
  ce_bwd_kernel<T><<<grid, kThreads, smem, st>>>(
      p, m, l, ws, static_cast<T*>(du), static_cast<T*>(dcand), tiles_u);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// Forward of the in-batch CE. u (M, D) and cand (N, D) in the compute
// dtype; ids (M / L, S), cand_ids (N) int32; colmask, logpop (N) float.
// The column tiles of 128 are split over `splits` blocks a row tile, `per`
// tiles each (no split empty); part holds 3 * splits * M floats. Writes
// ce, m and l (M) in float.
extern "C" int idvs_inbatch_ce_fwd(const void* u, const void* cand,
                                   const int* ids, const int* cand_ids,
                                   const float* colmask, const float* logpop,
                                   float* part, float* ce, float* m, float* l,
                                   int M, int N, int D, int L, int S,
                                   int label_off, int per, int splits,
                                   int dtype, void* stream) {
  using namespace idvs;
  const Problem p{u, cand, ids, cand_ids, colmask, logpop,
                  M, N, D, L, S, label_off};
  const int tiles = (N + BX - 1) / BX;
  if (!valid(p) || per < 1 || splits < 1 || (splits - 1) * per >= tiles ||
      splits * per < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        launch_fwd<float>(p, per, splits, part, ce, m, l, st));
  if (dtype == kBF16)
    return static_cast<int>(
        launch_fwd<__nv_bfloat16>(p, per, splits, part, ce, m, l, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward of the in-batch CE: the forward's operands, its m and l, and
// ws (M) = w * g / n_valid in float; writes du (M, D) and dcand (N, D) in
// the compute dtype.
extern "C" int idvs_inbatch_ce_bwd(const void* u, const void* cand,
                                   const int* ids, const int* cand_ids,
                                   const float* colmask, const float* logpop,
                                   const float* m, const float* l,
                                   const float* ws, void* du, void* dcand,
                                   int M, int N, int D, int L, int S,
                                   int label_off, int dtype, void* stream) {
  using namespace idvs;
  const Problem p{u, cand, ids, cand_ids, colmask, logpop,
                  M, N, D, L, S, label_off};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(launch_bwd<float>(p, m, l, ws, du, dcand, st));
  if (dtype == kBF16)
    return static_cast<int>(
        launch_bwd<__nv_bfloat16>(p, m, l, ws, du, dcand, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

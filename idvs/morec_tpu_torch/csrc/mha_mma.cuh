// The tensor-core bodies of the short-sequence attention tiles, shared by
// fused_mha.cu (the forward and both backward editions of fused_mha) and
// win_attn_bwd.cu (the attention core of the windowed attention's
// backward). fused_mha.cu's header has the design; in short: bf16 keeps q,
// k, v (and dout) as bf16 [Tp][Dp + 8] tiles copied by cp.async, every (T,
// T, dh) product an mma.sync m16n8k16 tile with float accumulators, a warp
// to 16 query rows, the scores, the softmax, dp, ds and the dbias sums in
// registers; float32 has the same structure with float [T][Dp + 8] planes
// and every product as 3xTF32 on mma.sync m16n8k8.
//
// A tile is (row b, head h) of a packed (rows, T, 3H) qkv and (rows, T, H)
// dout, its tokens found through a TokenMap (win_map.cuh): fused_mha's
// tiles are T consecutive rows, the windowed attention's backward reads a
// window's tokens from the band layout's feature map in place. Each block
// keeps the map's per-token offsets in a table in shared memory, so a
// tile's rows cost one base a tile and a table read a row.
#pragma once

#include <algorithm>
#include <climits>
#include <initializer_list>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"
#include "win_map.cuh"

namespace idvs {
namespace {

// One call: tiles of T tokens, nh heads of dh; mode 0 reads a (rows, T) key
// mask, mode 1 an additive float bias whose (row, head) plane sits at (row %
// P) * bias_sp + head * bias_sh; scale = 1 / sqrt(dh).
struct Geometry {
  int T, nh, dh, mode, P;
  long long bias_sp, bias_sh;
  float scale;
};

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
  rest += sizeof(int) * k.Tp;   // the token offsets
  const size_t one = sizeof(bf16) * k.operand_elems;
  k.buffers = 2 * one + rest <= kMaxSmem / 2 ? 2 : 1;
  k.smem = k.buffers * one + rest;
  return k;
}

// The block's shared memory: operand buffers, partial scores, the staged
// ds and pd planes, the dbias plane above T = 64, the token offsets.
struct MmaSmem {
  bf16* ops;
  float* red;
  bf16* ds;
  bf16* pd;
  float* da;
  int* off;
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
  if (edition == kBwdDbias && k.RG > 4) base += sizeof(float) * k.Tp * k.Tp;
  s.off = reinterpret_cast<int*>(base);
  return s;
}

// The map's offset of every token (0 past T), once a block, before the
// barrier that precedes the block's first copy; k: either dtype's blocking.
template <typename Plan>
__device__ __forceinline__ void fill_offsets(int* off, const TokenMap& map,
                                             const Geometry& g,
                                             const Plan& k) {
  for (int t = threadIdx.x; t < k.Tp; t += blockDim.x)
    off[t] = t < g.T ? map.offset(t) : 0;
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies tile b's head h of q, k, v (and dout when given) into one operand
// buffer, [Tp][ld] tiles in that order; token t of the tile is row
// map.base(b) + off[t] of qkv and dout. Rows >= T and columns >= dh are
// never written: they keep the zeros the kernel put there first.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ dout,
                                          int b, int h, const Geometry& g,
                                          const Blocking& k, bf16* dst,
                                          bool vec, const TokenMap& map,
                                          const int* off) {
  const int H = g.nh * g.dh, planes = dout != nullptr ? 4 : 3;
  const long long row = map.base(b, g.T);
  auto src = [&](int p, int t) {
    return p < 3 ? qkv + (row + off[t]) * 3 * H + p * H + h * g.dh
                 : dout + (row + off[t]) * H + h * g.dh;
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
// kExact: expf (the float32 forward, held to float32's tolerance), else
// the fast __expf (bf16 rounds the probabilities anyway).
template <int RG, bool kExact = false>
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
      const float x = kExact ? expf(s[n][e] - m[e >> 1])
                             : __expf(s[n][e] - m[e >> 1]);
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
// [Tp][ld] tile ([k][n]); tile row r stored as bf16 at dst + (row0 +
// off[r]) * rs + column for r < rows and columns < cols, 64 columns at a
// time
template <int RG>
__device__ __forceinline__ void product_store(const uint32_t (&a)[RG][4],
                                              const bf16* B, int ld, int nb0,
                                              int nb1, int grp,
                                              bf16* __restrict__ dst,
                                              size_t rs, long long row0,
                                              const int* off, int rows,
                                              int cols) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const uint32_t b0 = smem_u32(B + bk_row(l) * ld + bk_col(l));
  bf16* out[2];   // this thread's two rows, null past `rows`
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * grp + g + 8 * hh;
    out[hh] = r < rows ? dst + (row0 + off[r]) * rs : nullptr;
  }
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
        for (int hh = 0; hh < 2; ++hh)
          if (out[hh] != nullptr)
            store_pair(out[hh], col, o[t][2 * hh], o[t][2 * hh + 1], cols);
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

// One (tile b, head h) tile of the backward (one body for every edition):
// warp (rg, ks) recomputes row group rg's probabilities and dp, stores its
// column share of the forward's output again in the kCtx edition (the
// windowed attention's dWo needs it: cast(pd . v), one more product), forms
// ds, adds its unscaled f32 value into the dbias accumulators (ks == 0 in
// the dbias edition: acc in registers, sm.da above T = 64), stores its
// column share of dq, stages ds and pd, then stores its share of dk and dv
// for the key rows of group rg. Token t of the tile is row map.base(b) +
// sm.off[t] of qkv, dqkv and ctx.
template <int RG, bool kDbias, bool kCtx>
__device__ __forceinline__ void bwd_tile_mma(const bf16* ops,
                                             const MmaSmem& sm,
                                             float (&acc)[2 * RG][4],
                                             const float* __restrict__ bias,
                                             bf16* __restrict__ dqkv,
                                             bf16* __restrict__ ctx, int b,
                                             int h, const Geometry& g,
                                             const Blocking& k,
                                             const Drop& drop,
                                             const TokenMap& map) {
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
  const int H = g.nh * g.dh, c0 = k0, c1 = k1;   // column share = k share
  const long long row0 = map.base(b, g.T);
  uint32_t a[RG][4];
  if constexpr (kCtx) {
    prob_frags<RG>(a, s, i0, plane, g, drop);
    product_store<RG>(a, V, k.ld, c0, c1, rg, ctx + h * g.dh, H, row0,
                      sm.off, g.T, g.dh);
  }
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
  const size_t rs = 3 * static_cast<size_t>(H);
  bf16* base = dqkv + h * g.dh;
  product_store<RG>(a, K, k.ld, c0, c1, rg, base, rs, row0, sm.off, g.T,
                    g.dh);   // dq
  __syncthreads();   // ds and pd staged
  transposed_frags<RG>(a, sm.ds, k.ldt, rg);
  product_store<RG>(a, Q, k.ld, c0, c1, rg, base + H, rs, row0, sm.off, g.T,
                    g.dh);   // dk
  transposed_frags<RG>(a, sm.pd, k.ldt, rg);
  product_store<RG>(a, O, k.ld, c0, c1, rg, base + 2 * H, rs, row0, sm.off,
                    g.T, g.dh);   // dv
}

// grid: persistent blocks walking tiles as the forward's; the dbias
// edition: block (chunk, p, h) walks rows i * P + p for i in its chunk's
// share of the B / P rows, in order, and writes its partial plane at
// ((chunk * P + p) * nh + h) for a bias per head, at ((chunk * nh + h) * P
// + p) for a bias shared by the heads, so that idvs_sum_partials over the
// leading index gives (P, nh, T, T) or (P, 1, T, T). kCtx: ctx (rows, T, H)
// receives the forward's output (bwd_tile_mma), else it is not read.
// Tokens found through `map`.
template <int RG, bool kDbias, bool kCtx = false>
__global__ void __launch_bounds__(32 * (RG > 4 ? RG : 4),
                                  kDbias && RG <= 4 ? 3 : 1)
    mha_bwd_mma_kernel(const bf16* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                       bf16* __restrict__ ctx, float* __restrict__ part,
                       int B, int chunks, Geometry g, Blocking k, Drop drop,
                       TokenMap map) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const MmaSmem sm = carve(mma_smem, k, kDbias ? kBwdDbias : kBwd);
  fill_offsets(sm.off, map, g, k);
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
        load_tile(qkv, dout, row_of(it), head_of(it), g, k, dst, vec, map,
                  sm.off);
      },
      [&](int it, const bf16* ops) {
        bwd_tile_mma<RG, kDbias, kCtx>(ops, sm, acc, bias, dqkv, ctx,
                                       row_of(it), head_of(it), g, k, drop,
                                       map);
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

// ---- the float32 body: every product as 3xTF32 on mma.sync m16n8k8 --------
//
// bf16's structure with float planes (fused_mha.cu's header): a plane is a
// head's (T, dh) tile of q, k, v or dout, [T][ld] floats, rows past T not
// kept (a read of such a row gives zeros) and columns [dh, Dp) zeros. Each
// float is split into big + small tf32 terms and each 8-deep k-step sums
// small.big + big.small + big.big into zeroed sums that float adds take to
// the running sums (mma.cuh mma_3xtf32). Within a k-step, fragment column q
// is the step's k index 2q and column q + 4 is 2q + 1, for A and B alike
// (the sum over k does not mind its order): a row read is then one float2,
// and the score accumulators are, as they lie, the A operand of a product
// over the keys, whose B reads rows 2q and 2q + 1 at one column.

// How a float32 launch is cut (choose_f32, the one place it is decided);
// sizes in floats unless named bytes.
struct F32Blocking {
  int Tp, Dp;         // T rounded up to 16 (row groups), dh to 16 or 8 (k-steps)
  int ld;             // row stride of a plane: Dp + 8, 8 mod 16 floats (or
                      // kBwdLayouts' fallbacks: Dp + 4 or Dp)
  int RG, KS, warps;  // row groups of 16 query rows, splits of each, warps
  int planes;         // forward: 3 (q, k, v), or 2 (v into q's after the scores)
  int plane;          // floats of one [T][ld] plane (rows past T not kept)
  int vsw;            // forward: v's column swizzle, 8 with three planes
  int ldt;            // backward: row stride of the staged ds and pd, Tp + 8
  int srows;          // backward: rows a staged plane keeps, T up to 8s
  int staged;         // backward: staged_planes(RG, ctx)
  int region;         // backward: floats of v's plane, where ds and pd go
  int acc_smem;       // backward: the dbias sums in a shared (Tp, Tp) plane
  int sw;             // backward: the q, k, dout and v planes' column swizzle
  size_t smem;        // dynamic shared memory of a block, bytes
};

constexpr int kF32Warps = 8;   // at most, RG * KS
constexpr int kSwizzle = 8;    // the backward's planes: column bit 3 flipped

// The backward's staged planes: ds and pd side by side up to four row
// groups (T <= 64, the main paths), so that neither stays in registers
// during the products; above, and in the window core's edition (ctx), one
// plane that takes ds, then pd. The dbias sums: in registers up to four
// row groups, else (and in the ctx edition) in a shared (Tp, Tp) plane.
// With two blocks an SM up to four row groups (mha_bwd_tf32_kernel's
// launch bounds: 128 registers a thread), these let three of the window
// core's blocks onto an SM at Swin-T's T = 49; with kBwdLayouts every
// (T, dh) the scalar bodies took still fits.
__host__ __device__ constexpr int staged_planes(int RG, bool ctx) {
  return RG > 4 || ctx ? 1 : 2;
}
__host__ __device__ constexpr bool acc_in_smem(int RG, bool dbias, bool ctx) {
  return dbias && (RG > 4 || ctx);
}

// Tp / 16 row groups; fewer than eight of wide heads (SASRec, dh 256 and
// 1024) split each KS ways, up to eight warps a tile, each at least 32
// columns of the head, or none where that does not fit. The forward keeps
// q, k and v (two planes where three do not fit); the backward q, k, dout
// and v, then the staged ds and pd (staged_planes) in v's plane, grown to
// hold them, its dbias plane (acc_in_smem) and the token offsets.
// The backward's planes are laid out the first way of kBwdLayouts that
// fits: dh padded to 16 columns, rows 8 mod 16 floats apart and swizzled
// (every main path), or, for the widest heads at up to kPackedRG row
// groups (T <= 48) outside the window core, dh padded to 8 only, rows 4 or
// 0 floats further apart and not swizzled (bank conflicts, but every
// (T, dh) whose four (T, dh + 1) planes and two (T, T + 1) planes fit in a
// block launches: the widest such heads are at T 16-33). The swizzle is a
// template argument of the kernel, so the main paths' code stays as it
// was; the unswizzled bodies are built in fused_mha_f32_packed.cu, beside
// the others.
// edition: kFwd, kBwd or kBwdDbias; ctx: the window core's edition.
struct F32Layout {
  int round, pad, sw;   // dh rounded up to `round`, `pad` floats more a row
};
constexpr F32Layout kBwdLayouts[] = {{16, 8, kSwizzle}, {8, 4, 0}, {8, 0, 0}};
constexpr int kPackedRG = 3;

F32Blocking choose_f32(int T, int dh, int edition, bool ctx = false) {
  F32Blocking k;
  k.Tp = (T + 15) / 16 * 16;
  k.RG = k.Tp / 16;
  k.ldt = k.Tp + 8;
  k.srows = (T + 7) / 8 * 8;
  k.planes = k.vsw = k.staged = k.region = 0;
  k.acc_smem = acc_in_smem(k.RG, edition == kBwdDbias, ctx);
  const int layouts = edition == kFwd || ctx || k.RG > kPackedRG ? 1 : 3;
  for (int li = 0; li < layouts; ++li) {
    const F32Layout lay = kBwdLayouts[li];
    k.Dp = (dh + lay.round - 1) / lay.round * lay.round;
    k.ld = k.Dp + lay.pad;
    k.sw = lay.sw;
    k.plane = T * k.ld;
    const int want = k.RG < kF32Warps && k.Dp >= 128
                         ? std::min(kF32Warps / k.RG, k.Dp / 32)
                         : 1;
    for (int ks : {want, 1}) {
      k.KS = ks;
      k.warps = k.RG * ks;
      // [KS][RG][Tp / 8 tiles][32 lanes][4] partial scores (and dp)
      const size_t red = ks > 1 ? sizeof(float) * (edition == kFwd ? 1 : 2) *
                                      ks * k.RG * 16 * k.Tp
                                : 0;
      if (edition == kFwd) {
        k.planes = sizeof(float) * 3 * k.plane + red <= kMaxSmem ? 3 : 2;
        k.vsw = k.planes == 3 ? 8 : 0;
        k.smem = sizeof(float) * k.planes * k.plane + red;
        if (k.smem <= kMaxSmem) return k;
        continue;
      }
      const size_t rest = red + sizeof(int) * k.Tp +
                          (k.acc_smem ? sizeof(float) * k.Tp * k.Tp : 0);
      k.staged = staged_planes(k.RG, ctx);
      // ds's plane keeps the srows rows the transposed products read; dq's
      // reads of its rows up to Tp run into pd's plane (they reach only dq
      // rows past T, which are never stored), and one plane keeps Tp rows
      k.region = std::max(k.plane, k.staged == 2 ? 2 * k.srows * k.ldt
                                                : k.Tp * k.ldt);
      k.smem = sizeof(float) * (3 * k.plane + k.region) + rest;
      if (k.smem <= kMaxSmem) return k;
    }
  }
  return k;   // too large: the entry points refuse it
}

// The backward block's shared memory: the q, k and dout planes, the region
// of v's plane and the staged ds and pd, the partial scores and dp (KS >
// 1), the dbias plane (acc_smem), the token offsets.
struct F32Smem {
  float *Q, *K, *O, *V, *red, *da;
  int* off;
};

__device__ __forceinline__ F32Smem carve_f32(unsigned char* base,
                                             const F32Blocking& k) {
  F32Smem s;
  s.Q = reinterpret_cast<float*>(base);
  s.K = s.Q + k.plane;
  s.O = s.K + k.plane;
  s.V = s.O + k.plane;
  s.red = s.V + k.region;
  s.da = s.red + (k.KS > 1 ? 2 * k.KS * k.RG * 16 * k.Tp : 0);
  s.off = reinterpret_cast<int*>(s.da + (k.acc_smem ? k.Tp * k.Tp : 0));
  return s;
}

// Where column c of row r of a plane lies: bit 3 of c flipped on rows with
// bit 2 set (sw = 8; 0: no swizzle). With a row stride of 8 mod 16 floats
// a warp's reads of rows 2q and 2q + 1 at one column then hit 32 distinct
// banks, and float2 row reads stay conflict-free.
__device__ __forceinline__ int swz(int r, int c, int sw) {
  return c ^ (r & 4 ? sw : 0);
}

// Copies one head's (T, dh) tile into dst, a [T][ld] plane with the column
// swizzle sw: token t is row row0 + off[t] (off null: row0 + t) of a tensor
// whose rows are rs floats apart, src its row 0 at the head's column 0.
// 16-byte cp.async copies where every row is 16-byte aligned (vec), else
// plain loads; columns [dh, Dp) get zeros.
__device__ __forceinline__ void copy_plane(const float* __restrict__ src,
                                           size_t rs, long long row0,
                                           const int* off, float* dst, int sw,
                                           int T, int dh, int Dp, int ld,
                                           bool vec) {
  auto row = [&](int t) {
    return src + static_cast<size_t>(row0 + (off ? off[t] : t)) * rs;
  };
  if (vec) {
    const int cpr = Dp / 4, real = dh / 4;   // 16-byte chunks a row, the head's
    auto chunk = [&](int t, int c) {
      float* d = dst + t * ld + swz(t, 4 * c, sw);
      if (c < real)
        cp_async16(d, row(t) + 4 * c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    };
    if (static_cast<int>(blockDim.x) % cpr == 0) {
      // each thread copies one chunk column of every step-th row
      const int c = threadIdx.x % cpr, step = blockDim.x / cpr;
      for (int t = threadIdx.x / cpr; t < T; t += step) chunk(t, c);
    } else {
      for (int idx = threadIdx.x; idx < T * cpr; idx += blockDim.x)
        chunk(idx / cpr, idx % cpr);
    }
  } else {
    for (int idx = threadIdx.x; idx < T * Dp; idx += blockDim.x) {
      const int t = idx / Dp, d = idx % Dp;
      dst[t * ld + swz(t, d, sw)] = d < dh ? row(t)[d] : 0.f;
    }
  }
}

// a float2 of a plane's row, zeros past the T rows it keeps
__device__ __forceinline__ float2 row_pair(const float* plane, int row,
                                           int col, int T, int ld, int sw) {
  return row < T ? *reinterpret_cast<const float2*>(plane + row * ld +
                                                    swz(row, col, sw))
                 : make_float2(0.f, 0.f);
}

// U independent 3xTF32 products of one k-step into zeroed sums d, in
// rounds: every product's small.big, then big.small, then big.big, so that
// the tensor cores see U independent products in a row rather than one
// chain of three (mma.cuh mma_3xtf32's arithmetic; the caller adds d to
// its running sums by float adds). Product u runs where on[u], with
// b[u] its B pair (k rows 2q and 2q + 1 of one n column).
template <int U>
__device__ __forceinline__ void tf32_rounds(float (&d)[U][4],
                                            const bool (&on)[U],
                                            const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4],
                                            const float (&b)[U][2]) {
  uint32_t bb[U][2], bs[U][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    split_tf32(b[u][0], bb[u][0], bs[u][0]);
    split_tf32(b[u][1], bb[u][1], bs[u][1]);
    d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (on[u]) mma_tf32(d[u], as, bb[u][0], bb[u][1]);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (on[u]) mma_tf32(d[u], ab, bs[u][0], bs[u][1]);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (on[u]) mma_tf32(d[u], ab, bb[u][0], bb[u][1]);
}

// s = rows [16 rg, 16 rg + 16) of A times Bᵀ over the 8-column k-steps
// [k0, k1) and the live key tiles, A and B [T][ld] planes with the swizzle
// sw (q and k, or dout and v): fragment columns q and q + 4 are the head's
// columns 2q and 2q + 1 of the step, one float2 for A and for B. The key
// tiles go four at a time through tf32_rounds.
template <int RG>
__device__ __forceinline__ void scores_tf32(const float* A, const float* B,
                                            int ld, int sw, int T, int rg,
                                            int k0, int k1, int live,
                                            float (&s)[2 * RG][4]) {
  constexpr int U = 2 * RG < 4 ? 2 * RG : 4;
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const int r0 = 16 * rg + g;
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = k0; kk < k1; ++kk) {
    const int col = 8 * kk + 2 * q;
    const float2 lo = row_pair(A, r0, col, T, ld, sw);
    const float2 hi = row_pair(A, r0 + 8, col, T, ld, sw);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
    for (int n0 = 0; n0 < 2 * RG; n0 += U) {
      if (n0 < live) {
        bool on[U];
        float b[U][2], d[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          on[u] = n0 + u < 2 * RG && n0 + u < live;
          const float2 kv = on[u]
                                ? row_pair(B, 8 * (n0 + u) + g, col, T, ld, sw)
                                : make_float2(0.f, 0.f);
          b[u][0] = kv.x;
          b[u][1] = kv.y;
        }
        tf32_rounds<U>(d, on, ab, as, b);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (n0 + u < 2 * RG)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n0 + u][e] += d[u][e];
      }
    }
  }
}

// A fragments over the keys from score-shaped accumulators x, as they lie:
// tile kb's c0, c1 are row g's keys 2q and 2q + 1, c2, c3 row g + 8's
template <int RG>
struct RegFrags {
  const float (&x)[2 * RG][4];
  __device__ __forceinline__ void operator()(int kb, float (&f)[4]) const {
    f[0] = x[kb][0];
    f[1] = x[kb][2];
    f[2] = x[kb][1];
    f[3] = x[kb][3];
  }
};

// A fragments of rows [i, i + 16) of P over its columns, i = 16 rg, P a
// staged [Tp][ldt] plane with the swizzle: k-step kb's columns q and q + 4
// are P's columns 8 kb + 2q and 8 kb + 2q + 1, one float2 a row
struct RowFrags {
  const float* P;
  int ldt, i;
  __device__ __forceinline__ void operator()(int kb, float (&f)[4]) const {
    const int r = i + ((threadIdx.x & 31) >> 2), c = 8 * kb + 2 * (threadIdx.x & 3);
    const float2 lo = *reinterpret_cast<const float2*>(
        P + r * ldt + swz(r, c, kSwizzle));
    const float2 hi = *reinterpret_cast<const float2*>(
        P + (r + 8) * ldt + swz(r + 8, c, kSwizzle));
    f[0] = lo.x;
    f[1] = hi.x;
    f[2] = lo.y;
    f[3] = hi.y;
  }
};

// A fragments of rows [j, j + 16) of Pᵀ, j = 16 rg, P a staged [Tp][ldt]
// plane with the swizzle: k-step kb's columns q and q + 4 are P's rows 8 kb
// + 2q and 8 kb + 2q + 1
struct PlaneFrags {
  const float* P;
  int ldt, j;
  __device__ __forceinline__ void operator()(int kb, float (&f)[4]) const {
    const int i = 8 * kb + 2 * (threadIdx.x & 3);
    const int c = j + ((threadIdx.x & 31) >> 2);
    const float* r = P + i * ldt;
    f[0] = r[swz(i, c, kSwizzle)];
    f[1] = r[swz(i, c + 8, kSwizzle)];
    f[2] = r[ldt + swz(i, c, kSwizzle)];
    f[3] = r[ldt + swz(i, c + 8, kSwizzle)];
  }
};

__device__ __forceinline__ void store_pair(float* row, int col, float x,
                                           float y, int cols) {
  if (col + 1 < cols && (reinterpret_cast<uintptr_t>(row + col) & 7) == 0) {
    *reinterpret_cast<float2*>(row + col) = make_float2(x, y);
  } else {
    if (col < cols) row[col] = x;
    if (col + 1 < cols) row[col + 1] = y;
  }
}

// rows [16 rg, 16 rg + 16) of A . B over the live k-steps, for the 8-wide
// output column tiles [c0, c1), four at a time: a(kb, f) gives k-step kb's
// A fragment, B is a [T][ld] plane with the swizzle sw read as [k][n], rows
// 2q and 2q + 1 of each k-step at column n (zeros past T). Tile row r goes
// to dst + (row0 + off[r]) * rs (off null: row0 + r) for r < T, columns <
// cols.
template <int RG, typename AFrags>
__device__ __forceinline__ void product_store_f32(
    const AFrags& a, const float* B, int ld, int sw, int T, int live, int rg,
    int c0, int c1, float* __restrict__ dst, size_t rs, long long row0,
    const int* off, int cols) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  float* out[2];   // this thread's two rows, null past T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * rg + g + 8 * hh;
    out[hh] = r < T ? dst + static_cast<size_t>(row0 + (off ? off[r] : r)) * rs
                    : nullptr;
  }
  for (int cb = c0; cb < c1; cb += 4) {
    float o[4][4] = {};
    bool on[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) on[t] = cb + t < c1;
#pragma unroll
    for (int kb = 0; kb < 2 * RG; ++kb) {
      if (kb >= live) continue;
      float f[4];
      a(kb, f);
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(f[e], ab[e], as[e]);
      const int j = 8 * kb + 2 * q;
      const float* b0 = B + j * ld;
      float b[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = swz(j, 8 * (cb + t) + g, sw);
        b[t][0] = on[t] && j < T ? b0[col] : 0.f;
        b[t][1] = on[t] && j + 1 < T ? b0[ld + col] : 0.f;
      }
      float d[4][4];
      tf32_rounds<4>(d, on, ab, as, b);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[t][e] += d[t][e];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = 8 * (cb + t) + 2 * q;
      if (cb + t >= c1 || col >= cols) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (out[hh] != nullptr)
          store_pair(out[hh], col, o[t][2 * hh], o[t][2 * hh + 1], cols);
    }
  }
}

// One (tile b, head h) tile of the float32 backward, bwd_tile_mma's steps
// on float planes: warp (rg, ks) recomputes row group rg's probabilities
// over its share of the head's columns (the KS partial sums added in a
// fixed order), stores its column share of ctx (kCtx: p v), computes dp
// the same way and forms ds and pd in registers (ds unscaled into the
// dbias sums when ks == 0); after a barrier that ends every read of v, the
// ks == 0 warps stage ds * scale and pd in v's region, and every warp
// stores its column share of dq and, for the key rows of group rg, of dk
// and dv, all three products' A operands read from the staged planes (one
// staged plane: ds for dq and dk, then pd for dv). Token t is row row0 +
// sm.off[t] of qkv, dqkv and ctx. With one staged plane, next() copies the
// next tile's q and k once the barrier before pd's staging has ended their
// reads.
template <int RG, bool kDbias, bool kCtx, int kSw, typename Next>
__device__ __forceinline__ void bwd_tile_tf32(
    const F32Smem& sm, float (&acc)[2 * RG][4], const float* __restrict__ bias,
    float* __restrict__ dqkv, float* __restrict__ ctx, int b, int h,
    long long row0, const Geometry& g, const F32Blocking& k, const Drop& drop,
    Next next) {
  constexpr bool kOnePlane = staged_planes(RG, kCtx) == 1;
  constexpr bool kAccSmem = acc_in_smem(RG, kDbias, kCtx);
  const int warp = threadIdx.x >> 5, rg = warp / k.KS, ks = warp % k.KS;
  const int q = threadIdx.x & 3, i0 = 16 * rg + ((threadIdx.x & 31) >> 2);
  const int steps = k.Dp / 8, live = live_tiles(g);
  const int c0 = ks * steps / k.KS, c1 = (ks + 1) * steps / k.KS;
  const int H = g.nh * g.dh;
  const uint32_t plane = static_cast<uint32_t>(b * g.nh + h) *
                         static_cast<uint32_t>(g.T * g.T);
  float s[2 * RG][4], dp[2 * RG][4];
  scores_tf32<RG>(sm.Q, sm.K, k.ld, kSw, g.T, rg, c0, c1, live, s);
  if (k.KS > 1) {
    write_partial<RG>(s, sm.red, rg, ks);
    __syncthreads();
    read_sum<RG>(s, sm.red, rg, k.KS);
  }
  softmax_frag<RG, true>(s, bias_row(bias, b, h, g), i0, g);
  // ctx = p v: the window core takes no dropout (idvs_win_attn_bwd passes
  // none), and p's padded query rows reach only rows that are never stored
  if constexpr (kCtx)
    product_store_f32<RG>(RegFrags<RG>{s}, sm.V, k.ld, kSw, g.T, live,
                          rg, c0, c1, ctx + h * g.dh, H, row0, sm.off, g.dh);
  scores_tf32<RG>(sm.O, sm.V, k.ld, kSw, g.T, rg, c0, c1, live, dp);
  if (k.KS > 1) {
    float* red_dp = sm.red + k.KS * k.RG * 16 * k.Tp;
    write_partial<RG>(dp, red_dp, rg, ks);
    __syncthreads();
    read_sum<RG>(dp, red_dp, rg, k.KS);
  }
  // dp dropped with the forward's mask, and dot = rowsum(dp * p); bit 4 n +
  // e of `dropped_bits` marks a dropped element, for pd below
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
  // ds = p (dp - dot) into the dbias sums unscaled and into dp as ds *
  // scale; pd, dropped as dp was, into s (zero in padded query rows and
  // keys; dead key tiles are zero in both already)
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n) {
    if (n >= live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, j = 8 * n + 2 * q + (e & 1);
      const float ds = i < g.T ? s[n][e] * (dp[n][e] - dot[e >> 1]) : 0.f;
      if (kDbias && ks == 0) {
        if constexpr (kAccSmem)
          sm.da[i * k.Tp + j] += ds;
        else
          acc[n][e] += ds;
      }
      dp[n][e] = ds * g.scale;
      const bool gone = i >= g.T || (dropped_bits >> (4 * n + e) & 1);
      s[n][e] = gone ? 0.f : s[n][e] * (drop.on() ? drop.scale : 1.f);
    }
  }
  float* P_ds = sm.V;
  float* P_pd = kOnePlane ? sm.V : sm.V + k.srows * k.ldt;
  // the ks == 0 warps write rows below srows, zeros past T
  auto stage = [&](float* P, const float (&x)[2 * RG][4]) {
    if (ks) return;
#pragma unroll
    for (int n = 0; n < 2 * RG; ++n) {
      if (n >= live) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        if (i >= k.srows) continue;
        *reinterpret_cast<float2*>(P + i * k.ldt +
                                   swz(i, 8 * n + 2 * q, kSwizzle)) =
            make_float2(x[n][2 * hh], x[n][2 * hh + 1]);
      }
    }
  };
  __syncthreads();   // every read of v is over: its region takes ds and pd
  stage(P_ds, dp);
  if constexpr (!kOnePlane) stage(P_pd, s);
  __syncthreads();   // staged
  const size_t rs = 3 * static_cast<size_t>(H);
  float* base = dqkv + h * g.dh;
  product_store_f32<RG>(RowFrags{P_ds, k.ldt, 16 * rg}, sm.K, k.ld,
                        kSw, g.T, live, rg, c0, c1, base, rs, row0,
                        sm.off, g.dh);   // dq
  product_store_f32<RG>(PlaneFrags{P_ds, k.ldt, 16 * rg}, sm.Q, k.ld,
                        kSw, g.T, live, rg, c0, c1, base + H, rs, row0,
                        sm.off, g.dh);   // dk
  if constexpr (kOnePlane) {
    __syncthreads();   // ds, q and k read
    next();
    stage(P_pd, s);
    __syncthreads();
  }
  product_store_f32<RG>(PlaneFrags{P_pd, k.ldt, 16 * rg}, sm.O, k.ld,
                        kSw, g.T, live, rg, c0, c1, base + 2 * H, rs,
                        row0, sm.off, g.dh);   // dv
}

// grid and dbias edition as mha_bwd_mma_kernel's. One buffer: the next
// tile's four planes are copied once this tile is done, or, with one
// staged plane, its q and k once this tile's dk is done (a copy group of
// their own) and its dout and v once this tile is done.
template <int RG, bool kDbias, bool kCtx = false, int kSw = kSwizzle>
__global__ void __launch_bounds__(32 * kF32Warps, RG <= 4 ? 2 : 1)
    mha_bwd_tf32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        float* __restrict__ dqkv, float* __restrict__ ctx,
                        float* __restrict__ part, int B, int chunks,
                        Geometry g, F32Blocking k, Drop drop, TokenMap map) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  const F32Smem sm = carve_f32(f32_smem, k);
  fill_offsets(sm.off, map, g, k);
  const bool vec = g.dh % 4 == 0 && aligned16(qkv) && aligned16(dout);
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
  constexpr bool kAccSmem = acc_in_smem(RG, kDbias, kCtx);
  if (kAccSmem)
    for (int idx = threadIdx.x; idx < k.Tp * k.Tp; idx += blockDim.x)
      sm.da[idx] = 0.f;
  float acc[2 * RG][4];
#pragma unroll
  for (int n = 0; n < 2 * RG; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  __syncthreads();   // the offsets
  const int H = g.nh * g.dh;
  const size_t rs = 3 * static_cast<size_t>(H);
  constexpr bool kOnePlane = staged_planes(RG, kCtx) == 1;
  // planes p (0 q, 1 k, 2 dout, 3 v) in [p0, p1) of tile it, one group
  auto copy = [&](int it, int p0, int p1) {
    const long long row0 = map.base(row_of(it), g.T);
    const int c = head_of(it) * g.dh;
    const float* src[4] = {qkv + c, qkv + H + c, dout + c, qkv + 2 * H + c};
    float* dst[4] = {sm.Q, sm.K, sm.O, sm.V};
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p >= p0 && p < p1)
        copy_plane(src[p], p == 2 ? H : rs, row0, sm.off, dst[p], kSw,
                   g.T, g.dh, k.Dp, k.ld, vec);
    cp_async_commit();
  };
  if (first < end) copy(first, 0, 4);
  for (int it = first; it < end; it += step) {
    const int nxt = it + step;
    cp_async_wait<0>();
    __syncthreads();   // this tile's planes
    bwd_tile_tf32<RG, kDbias, kCtx, kSw>(
        sm, acc, bias, dqkv, ctx, row_of(it), head_of(it),
        map.base(row_of(it), g.T), g, k, drop, [&] {
          if (nxt < end) copy(nxt, 0, 2);
        });
    __syncthreads();   // every read of this tile's planes is over
    if (nxt < end) copy(nxt, kOnePlane ? 2 : 0, 4);
  }
  if (!kDbias) return;
  const size_t slot =
      g.bias_sh == 0 ? (static_cast<size_t>(chunk) * g.nh + hd) * g.P + p
                     : (static_cast<size_t>(chunk) * g.P + p) * g.nh + hd;
  float* out = part + slot * g.T * g.T;
  if constexpr (!kAccSmem) {
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
    // every element of sm.da was last written before the loop's barrier
    for (int idx = threadIdx.x; idx < g.T * g.T; idx += blockDim.x)
      out[idx] = sm.da[idx / g.T * k.Tp + idx % g.T];
  }
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
// Plan: a blocking with the block's warps and shared-memory bytes (smem).
template <typename K, typename Plan>
cudaError_t resident(K kernel, const Plan& k, int* slots) {
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

// The backward body of a blocking's dtype: bf16 (Blocking) or float32
// (F32Blocking), whose operand planes take the column swizzle kSw (0 only
// in the layouts kBwdLayouts falls back to, which fused_mha_f32_packed.cu
// instantiates)
template <int R, bool kDbias, bool kCtx, int kSw>
auto bwd_body(const Blocking&) {
  return mha_bwd_mma_kernel<R, kDbias, kCtx>;
}
template <int R, bool kDbias, bool kCtx, int kSw>
auto bwd_body(const F32Blocking&) {
  return mha_bwd_tf32_kernel<R, kDbias, kCtx, kSw>;
}

// Whether a body of R row groups exists with the swizzle kSw: the
// unswizzled one only up to kPackedRG row groups, outside the window core
template <int R, bool kCtx, int kSw>
constexpr bool has_body() {
  return kSw == kSwizzle || (R <= kPackedRG && !kCtx);
}

// The blocks of k's dbias edition the SMs hold at once, after opting the
// kernel into its shared memory
template <bool kCtx, int kSw = kSwizzle, typename Plan>
cudaError_t dbias_slots(const Plan& k, int* slots) {
  return with_rg(k.RG, [&](auto rg) {
    constexpr int R = decltype(rg)::value;
    if constexpr (!has_body<R, kCtx, kSw>()) {
      return cudaErrorInvalidValue;
    } else {
      return resident(bwd_body<R, true, kCtx, kSw>(k), k, slots);
    }
  });
}

// Launches the backward body of k's dtype on elements T: chunks > 0 its
// dbias edition, block (chunk, p, head) each, else a persistent grid over
// the tiles; ctx is written in the kCtx edition (dbias only), tokens found
// through map.
template <bool kCtx, int kSw = kSwizzle, typename Plan, typename T>
cudaError_t launch_bwd(const T* qkv, const float* bias, const T* dout,
                       T* dqkv, T* ctx, float* part, int B, int chunks,
                       const Geometry& g, const Plan& k, Drop drop,
                       const TokenMap& map, cudaStream_t stream) {
  return with_rg(k.RG, [&](auto rg) {
    constexpr int R = decltype(rg)::value;
    if constexpr (!has_body<R, kCtx, kSw>()) {
      return cudaErrorInvalidValue;
    } else {
      auto kernel = bwd_body<R, true, kCtx, kSw>(k);
      if constexpr (!kCtx)
        if (chunks == 0) kernel = bwd_body<R, false, false, kSw>(k);
      int slots = 0;
      cudaError_t err = resident(kernel, k, &slots);
      if (err != cudaSuccess) return err;
      const int grid = chunks > 0 ? chunks * g.P * g.nh
                                  : std::min(B * g.nh, slots);
      kernel<<<grid, 32 * k.warps, k.smem, stream>>>(qkv, bias, dout, dqkv,
                                                     ctx, part, B, chunks, g,
                                                     k, drop, map);
      return cudaGetLastError();
    }
  });
}

bool valid(int B, const Geometry& g, size_t smem) {
  return B >= 1 && g.T >= 1 && g.T <= 128 && g.nh >= 1 && g.dh >= 1 &&
         smem <= kMaxSmem && (g.mode == 0 || (g.mode == 1 && g.P >= 1));
}

// fused_mha's backward in the dtype's body at its blocking k, edition kBwd
// (chunks = 0) or kBwdDbias (writing part), after checking that the
// geometry and k fit.
template <typename T, int kSw = kSwizzle, typename Plan>
int fused_mha_backward(const void* qkv, const float* bias, const void* dout,
                       void* dqkv, float* part, int B, int chunks,
                       const Geometry& g, const Plan& k, Drop drop,
                       cudaStream_t stream) {
  if (!valid(B, g, k.smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd<false, kSw>(
      static_cast<const T*>(qkv), bias, static_cast<const T*>(dout),
      static_cast<T*>(dqkv), static_cast<T*>(nullptr), part, B, chunks, g,
      k, drop, TokenMap{}, stream));
}

// the non-empty shares of `rows` rows that `chunks` asks for
int normalised(int rows, int chunks) {
  const int per = (rows + chunks - 1) / chunks;
  return (rows + per - 1) / per;
}

// Chunks of the dbias edition: how many shares the B / P rows of each
// (bias row, head) are cut into, one block each: the count that minimises
// waves x (rows a block walks + 2), the 2 standing for the partial plane
// it writes and the sum reads back (about two rows' bytes), with `slots`
// the blocks of the body (either dtype's) the SMs hold at once.
int dbias_chunks(int B, int P, int nh, int slots) {
  const int rows = B / P, cells = P * nh;
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

// The chunks of fused_mha's dbias edition in the dtype's body at its
// blocking k (dbias_chunks), or a negative CUDA error
template <int kSw = kSwizzle, typename Plan>
int fused_mha_dbias_chunks(int B, int P, int nh, const Plan& k) {
  if (k.smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  const cudaError_t err = dbias_slots<false, kSw>(k, &slots);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dbias_chunks(B, P, nh, slots);
}

// fused_mha's float32 backward with the operand swizzle kSw, on the
// arguments of idvs_fused_mha_bwd_f32 (fused_mha_f32.cu): kSwizzle there,
// 0 in fused_mha_f32_packed.cu
template <int kSw>
int fused_mha_backward_f32(const void* qkv, const void* bias,
                           const void* dout, void* dqkv, void* part, int B,
                           int T_, int nh, int dh, int mode, int P,
                           int chunks, long long bias_sp, long long bias_sh,
                           float scale, unsigned drop_key,
                           unsigned drop_thresh, float drop_scale,
                           void* stream) {
  const Geometry g{T_, nh, dh, mode, P, bias_sp, bias_sh, scale};
  return fused_mha_backward<float, kSw>(
      qkv, static_cast<const float*>(bias), dout, dqkv,
      static_cast<float*>(part), B, chunks, g,
      choose_f32(T_, dh, chunks > 0 ? kBwdDbias : kBwd),
      Drop{drop_key, drop_thresh, drop_scale},
      static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace idvs

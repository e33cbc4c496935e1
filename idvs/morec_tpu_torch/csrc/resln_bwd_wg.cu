// The post-LN tails' backward in bf16 at C <= 512 (the "fused" route of
// resln_bwd_plan in ops/cuda/mlp.py): one warp-specialised row-block
// kernel a tail, whose products along the rows run on Hopper's warpgroup
// tensor-core instruction (wgmma, wgmma.cuh). They replace, with gemm.cu's
// weight-gradient products over K = M, the TPU kernels
// idvs/morec_tpu/ops/pallas/mlp.py _bwd_post_kernel (:444-494, the FFN
// tail) and _bwd_proj_kernel (:723-769, the projection tail), with their
// rounding points:
//   xhat = (ypre - mu) rstd      (mu, rstd in float from the cast ypre)
//   dyp  = rstd (dout g - mean(dout g) - xhat mean(dout g xhat))
//   dz   = cast(dropout(dyp))    (the forward's mask, dropout.cuh)
// FFN tail (h the forward's saved cast pre-activation):
//   g  = cast(act(h)),  dg = f32(dz W2c^T),  dh = cast(dg act'(h))
//   dx = cast(f32(dh W1^T) + dyp)
//   then dW2 = g^T dz and dW1 = x^T dh in gemm.cu
// projection tail:
//   dres = cast(dyp),  dx = cast(f32(dz W^T)),  then dW = x^T dz in gemm.cu
// and the column sums dgamma = sum(dout xhat), dbeta = sum(dout), db2 (db)
// = sum(dropout(dyp)) in float before the cast, db1 = sum(cast dh).
//
// Bound on the H100 (text BERT, M = 23040, C = 512, F = 2048): the FFN
// kernel's two products are 96.6 GFLOP (0.098 ms at 989 TFLOP/s) against
// about 382 MB of traffic (0.114 ms at 3.35 TB/s). The route it replaces
// ran the row pass, act_cast and colsum as memory passes and the dh and dx
// products through gemm.cu's mma.sync body, h and dh crossing device
// memory 2 and 4 times (PERF.md). Here a block owns 64 rows (one wgmma M
// tile), so each block streams all of W1 and W2 from L2 (4 MB at C = 512,
// 64 operations a byte). What bounds it is the block's serial walk: its
// products run near the tensor cores' rate, but between them the block
// waits for the prologue, the activation's epilogue, the stores of g and
// dh and the weights' arrival, one after the other, and one block fills
// an SM (at M = 2560, 40 blocks take as long as 80). Three redesigns of
// the walk measured no faster on the card (PERF.md): F in chunks of 128
// through a ring of 16 KB stages (dg on m64n64); those stages as 1-D bulk
// copies of weights packed beforehand in the stages' layout; and the
// epilogue interleaved with the next chunk's dg products. The lever left
// is overlap across row tiles: a persistent block whose idle producer
// warps run the row passes of the next tile.
//
// Block layout: 384 threads, two consumer warpgroups (threads 0-255) and a
// producer warpgroup of which one thread issues TMA loads (setmaxnreg
// moves the producer's registers to the consumers). Shared memory, from a
// 1024-byte aligned base: the dz tile [64][C] as K-blocks of 64 (the A
// operand of dg and of the projection's product), a ring of two weight
// slots of 64 x C bf16 each, for the FFN the dh and g tiles [64][64],
// then each row's (mu, rstd, m1, m2), db1's warp sums and four mbarriers
// (full and empty of each slot). Every tile is K-major in the 128-byte
// swizzled layout TMA writes (wgmma.cuh).
//
// Prologue (consumers; warp w owns rows 8w..8w+7, lane l columns 4l +
// 128j, as resln_bwd.cu's row pass): the LN backward above from ypre and
// dout; dz to device memory and into the dz tile (dres too for the
// projection); each row's statistics kept; the warps' column sums go
// through slot 1, which the producer fills only once the prologue has
// released it, and are added in warp order into the block's partial row.
//
// FFN walk over F in chunks of 64 (slot 0 W2's 64 rows of the chunk, slot
// 1 W1's 64 columns): warpgroup v computes dg for the chunk's columns
// 32v..32v+31 (m64n32k16, K = C), with the saved h of its accumulators
// loaded before the product; releases slot 0 (the producer refills it
// with the next chunk's W2 rows); the activation and its derivative once
// an element (mlp_mma.cuh act_dact: GELU's erf as the TPU kernel's _erf);
// dh into the dh tile, g into the g tile, db1's 16-row sums by shuffles;
// then dx += dh W1c^T (m64n(C/2)k16, K = 64) for its C / 2 columns of dx
// (64 x 256 floats at C = 512, 128 a thread: a 64 x 512 accumulator in
// one warpgroup would need 256 registers a thread), and while that runs
// the g and dh tiles leave as 16-byte pieces of rows and the chunk's db1
// partial is written; then slot 1 is released.
//
// Projection walk over K = C in K-blocks of 64 (the slots alternate): dx
// += dz_kb W_kb^T, m64n(C/2)k16, one group of products in flight.
//
// Epilogue: the accumulators go through shared memory (the dz tile and
// the slots are free) as a float [64][C + 8] tile; the row pass adds dyp,
// recomputed from the kept statistics and ypre and dout re-read (no float
// (M, C) dyp in device memory; the next row's loaded while this one is
// stored), casts and stores dx in whole rows.
// Each block writes one partial row (dgamma, dbeta, db2[, db1]); two
// passes add them in a fixed order (reduce.cuh group_sums): no atomics,
// so two runs give the same bits.
#include "mlp_mma.cuh"
#include "reduce.cuh"
#include "rowtile.cuh"
#include "wgmma.cuh"

namespace idvs {
namespace {

using rowtile::load4;
using rowtile::store4;

constexpr int kRows = 64;        // a block's rows: one wgmma M tile
constexpr int kChunk = 64;       // F (FFN) or K (projection) a slot holds
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = 384;    // and the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSync = 1;         // the consumers' named barrier

// C columns; the FFN tail (dh and g tiles, db1's sums) or the projection
template <int C_, bool kMlp_>
struct WgCfg {
  static constexpr int C = C_;
  static constexpr bool kMlp = kMlp_;
  static constexpr int NG = C / 128, V = 4 * NG;   // a lane's row columns
  static constexpr int BR = C < 256 ? C : 256;     // rows of a weight box
  static constexpr int HALF = C / 2;               // a warpgroup's dx cols
  static constexpr uint32_t kblock = kRows * 128;  // a dz tile K-block
  static constexpr uint32_t tile = kRows * C * 2;
  static constexpr uint32_t slot = kChunk * C * 2;
  static constexpr uint32_t small = kRows * kChunk * 2;
  static constexpr uint32_t off_small = tile + 2 * slot;
  static constexpr uint32_t off_stats = off_small + (kMlp ? 2 * small : 0);
  static constexpr uint32_t off_red = off_stats + kRows * 16;
  static constexpr uint32_t off_bar = off_red + (kMlp ? 4 * kChunk * 4 : 0);
  static constexpr size_t smem = off_bar + 4 * 8 + 1024;   // + alignment
  static_assert(smem <= kMaxSmem, "tiles do not fit in shared memory");
  static_assert(8 * 3 * C * 4 <= slot, "column sums fit slot 1");
  static_assert(kRows * (C + 8) * 4 <= tile + 2 * slot, "dx tile fits");
};

struct WgArgs {
  const bf16 *ypre, *dout, *h;   // h: the FFN's saved (M, F), or null
  const float* gamma;
  bf16 *dz, *dres, *g, *dh, *dx;  // dres: projection; g, dh: FFN
  float* part;                    // (blocks, 3 C [+ F])
  int M, F;
  float eps;
  Drop drop;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// the sum over the 8 lanes of a quad column: 16 rows of one accumulator
// column
__device__ __forceinline__ float col_sum8(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float dyp_of(float d, float g, float xhat,
                                        float rstd, float m1, float m2) {
  return rstd * (d * g - m1 - xhat * m2);
}

// byte offset of (r, col) in the dz tile
template <typename K>
__device__ __forceinline__ uint32_t dz_offset(int r, int col) {
  return (col >> 6) * K::kblock + wg::sw128_offset(r, col & 63);
}

// The prologue on the 256 consumer threads: see the header.
template <typename K>
__device__ __forceinline__ void ln_bwd_rows(const WgArgs& p, uint8_t* sm,
                                            int tid, int row0, float* part) {
  constexpr int C = K::C, NG = K::NG, V = K::V;
  const int warp = tid >> 5, lane = tid & 31;
  float4* stats = reinterpret_cast<float4*>(sm + K::off_stats);
  float g[V], pg[V] = {}, pb[V] = {}, pd[V] = {};
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const float4 t = load4(p.gamma + 4 * lane + 128 * j);
    g[4 * j] = t.x, g[4 * j + 1] = t.y, g[4 * j + 2] = t.z,
          g[4 * j + 3] = t.w;
  }
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * warp + i, row = row0 + r;
    if (row >= p.M) {   // zeros past M: their dg and dh are 0
#pragma unroll
      for (int j = 0; j < NG; ++j)
        *reinterpret_cast<uint2*>(
            sm + dz_offset<K>(r, 4 * lane + 128 * j)) = make_uint2(0u, 0u);
      continue;
    }
    const size_t base = static_cast<size_t>(row) * C;
    float y[V], d[V];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * lane + 128 * j;
      const float4 a = load4(p.ypre + base + col);
      const float4 b = load4(p.dout + base + col);
      y[4 * j] = a.x, y[4 * j + 1] = a.y, y[4 * j + 2] = a.z,
            y[4 * j + 3] = a.w;
      d[4 * j] = b.x, d[4 * j + 1] = b.y, d[4 * j + 2] = b.z,
            d[4 * j + 3] = b.w;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sum += y[v];
      sq += y[v] * y[v];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / C;
    const float rstd = 1.f / sqrtf(fmaxf(sq / C - mu * mu, 0.f) + p.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      y[v] = (y[v] - mu) * rstd;        // xhat
      const float dx = d[v] * g[v];
      s1 += dx;
      s2 += dx * y[v];
      pg[v] += d[v] * y[v];
      pb[v] += d[v];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * lane + 128 * j;
      float o[4], z[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = 4 * j + c;
        o[c] = dyp_of(d[v], g[v], y[v], rstd, m1, m2);
        z[c] = p.drop.apply(o[c], static_cast<uint32_t>(base + col + c));
        pd[v] += z[c];
      }
      if (p.dres != nullptr)
        store4(p.dres + base + col, make_float4(o[0], o[1], o[2], o[3]));
      store4(p.dz + base + col, make_float4(z[0], z[1], z[2], z[3]));
      *reinterpret_cast<uint2*>(sm + dz_offset<K>(r, col)) =
          make_uint2(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]));
    }
    if (lane == 0) stats[r] = make_float4(mu, rstd, m1, m2);
  }
  // the warps' column sums through slot 1, added in warp order
  float* red = reinterpret_cast<float*>(sm + K::tile + K::slot);
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = 4 * j + c, col = 4 * lane + 128 * j + c;
      red[(warp * 3 + 0) * C + col] = pg[v];
      red[(warp * 3 + 1) * C + col] = pb[v];
      red[(warp * 3 + 2) * C + col] = pd[v];
    }
  wg::named_sync(kSync, kConsumers);
  for (int e = tid; e < 3 * C; e += kConsumers) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * 3 * C + e];
    part[e] = s;
  }
  wg::fence_async_smem();   // the dz tile, before the products read it
  wg::named_sync(kSync, kConsumers);
}

// The epilogue: warpgroup v's accumulators (dx's columns v C / 2 ..) into
// the float [64][C + 8] tile at the base, then dx = cast(acc [+ dyp]) in
// whole rows.
template <typename K, bool kAddDyp>
__device__ __forceinline__ void dx_rows(const WgArgs& p, uint8_t* sm,
                                        const float (&acc)[K::HALF / 2],
                                        int tid, int row0) {
  constexpr int C = K::C, NG = K::NG, ld = C + 8;
  float* xt = reinterpret_cast<float*>(sm);
  const int t = tid & 127, c0 = (tid >> 7) * K::HALF;
  wg::fence_async_smem();
  wg::named_sync(kSync, kConsumers);   // every product is done with smem
#pragma unroll
  for (int i = 0; i < K::HALF / 2; i += 2)
    *reinterpret_cast<float2*>(xt + wg::acc_row(t, i) * ld + c0 +
                               wg::acc_col(t, i)) =
        make_float2(acc[i], acc[i + 1]);
  wg::named_sync(kSync, kConsumers);
  const int warp = tid >> 5, lane = tid & 31;
  const float4* stats = reinterpret_cast<const float4*>(sm + K::off_stats);
  // a row's ypre and dout, the next row's loaded while this one is stored
  auto load_row = [&](int i, float4 (&y)[NG], float4 (&d)[NG]) {
    const int row = row0 + 8 * warp + i;
    if (!kAddDyp || row >= p.M) return;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const size_t o = static_cast<size_t>(row) * C + 4 * lane + 128 * j;
      y[j] = load4(p.ypre + o);
      d[j] = load4(p.dout + o);
    }
  };
  float4 y[NG], d[NG];
  load_row(0, y, d);
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * warp + i, row = row0 + r;
    float4 yn[NG], dn[NG];
    if (i + 1 < 8) load_row(i + 1, yn, dn);
    if (row < p.M) {
      const size_t base = static_cast<size_t>(row) * C;
      const float4 st = stats[r];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int col = 4 * lane + 128 * j;
        float4 a = *reinterpret_cast<const float4*>(xt + r * ld + col);
        if constexpr (kAddDyp) {
          const float4 gm = load4(p.gamma + col);
          const float4 yy = y[j], dd = d[j];
          a.x += dyp_of(dd.x, gm.x, (yy.x - st.x) * st.y, st.y, st.z, st.w);
          a.y += dyp_of(dd.y, gm.y, (yy.y - st.x) * st.y, st.y, st.z, st.w);
          a.z += dyp_of(dd.z, gm.z, (yy.z - st.x) * st.y, st.y, st.z, st.w);
          a.w += dyp_of(dd.w, gm.w, (yy.w - st.x) * st.y, st.y, st.z, st.w);
        }
        store4(p.dx + base + col, a);
      }
    }
    if (i + 1 < 8) {
#pragma unroll
      for (int j = 0; j < NG; ++j) y[j] = yn[j], d[j] = dn[j];
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  // full 0, full 1: the producer's arrival and the bytes; empty 0, empty
  // 1: one arrival from each consumer warpgroup
  if (threadIdx.x == 0) {
    wg::mbar_init(&bars[0], 1);
    wg::mbar_init(&bars[1], 1);
    wg::mbar_init(&bars[2], 2);
    wg::mbar_init(&bars[3], 2);
    wg::mbar_init_fence();
  }
  __syncthreads();
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_resln_bwd_wg_kernel(const __grid_constant__ CUtensorMap w1_map,
                            const __grid_constant__ CUtensorMap w2_map,
                            const WgArgs p, int act) {
  constexpr int C = K::C;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* sm = aligned_base(wg_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + K::off_bar);
  const int tid = threadIdx.x, row0 = blockIdx.x * kRows;
  const int F = p.F, nch = F / kChunk;
  init_bars(bars);
  if (tid >= kConsumers) {
    // the producer: W2's chunk rows into slot 0 (K-blocks of 64 of C),
    // W1's chunk columns into slot 1, each once its slot is released
    wg::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int ch = 0; ch < nch; ++ch) {
        const int f0 = ch * kChunk;
        if (ch > 0) wg::mbar_wait(&bars[2], (ch - 1) & 1);
        wg::mbar_expect(&bars[0], K::slot);
        for (int kb = 0; kb < C / 64; ++kb)
          wg::tma_load(sm + K::tile + kb * (kChunk * 128), &w2_map, 64 * kb,
                       f0, &bars[0]);
        wg::mbar_wait(&bars[3], ch & 1);   // phase 0: the prologue's
        wg::mbar_expect(&bars[1], K::slot);
        for (int q = 0; q < C / K::BR; ++q)
          wg::tma_load(sm + K::tile + K::slot + q * K::BR * 128, &w1_map, f0,
                       q * K::BR, &bars[1]);
      }
    }
  } else {
    wg::setmaxnreg_inc<kConsumerRegs>();
    float* part = p.part + static_cast<size_t>(blockIdx.x) * (3 * C + F);
    ln_bwd_rows<K>(p, sm, tid, row0, part);
    const int v = tid >> 7, t = tid & 127, wr = t >> 5, lane = t & 31;
    if (t == 0) wg::mbar_arrive(&bars[3]);   // slot 1's scratch is free
    uint8_t* dh_t = sm + K::off_small;
    uint8_t* g_t = dh_t + K::small;
    float* red1 = reinterpret_cast<float*>(sm + K::off_red);   // [4][64]
    const uint32_t a_dz = smem_u32(sm), a_dh = smem_u32(dh_t);
    const uint32_t b_w2 = smem_u32(sm + K::tile) + v * 32 * 128;
    const uint32_t b_w1 = smem_u32(sm + K::tile + K::slot) + v * K::HALF * 128;
    const int r0 = 16 * wr + (lane >> 2), cq = 32 * v + 2 * (lane & 3);
    float acc[K::HALF / 2];
#pragma unroll
    for (int i = 0; i < K::HALF / 2; ++i) acc[i] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int f0 = ch * kChunk;
      // the saved h at this thread's dg values, ahead of the product
      uint32_t hv[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + r0 + 8 * hh;
          hv[2 * j + hh] =
              row < p.M ? *reinterpret_cast<const uint32_t*>(
                              p.h + static_cast<size_t>(row) * F + f0 + cq +
                              8 * j)
                        : 0u;
        }
      float dg[16] = {};
      wg::mbar_wait(&bars[0], ch & 1);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wg::mma<32>(dg, wg::kstep_desc(a_dz, ks, K::kblock),
                    wg::kstep_desc(b_w2, ks, kChunk * 128), ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(dg);
      if (t == 0) wg::mbar_arrive(&bars[2]);   // slot 0 is free
      // the last chunk's tiles have been read (products and copies)
      wg::named_sync(kSync, kConsumers);
      auto epi = [&](auto a_) {
        constexpr int A = decltype(a_)::value;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cq + 8 * j;   // within the chunk
          uint32_t dhp[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t hb = hv[2 * j + hh];
            float ga0, da0, ga1, da1;
            act_dact<A>(__uint_as_float(hb << 16), ga0, da0);
            act_dact<A>(__uint_as_float(hb & 0xffff0000u), ga1, da1);
            dhp[hh] = pack_bf16(dg[4 * j + 2 * hh] * da0,
                                dg[4 * j + 2 * hh + 1] * da1);
            const uint32_t off = wg::sw128_offset(r0 + 8 * hh, col);
            *reinterpret_cast<uint32_t*>(dh_t + off) = dhp[hh];
            *reinterpret_cast<uint32_t*>(g_t + off) = pack_bf16(ga0, ga1);
          }
          // db1 from the cast dh: the warp's 16 rows of both columns
          const float s0 = col_sum8(__uint_as_float(dhp[0] << 16) +
                                    __uint_as_float(dhp[1] << 16));
          const float s1 = col_sum8(__uint_as_float(dhp[0] & 0xffff0000u) +
                                    __uint_as_float(dhp[1] & 0xffff0000u));
          if ((lane >> 2) == 0) {
            red1[wr * kChunk + col] = s0;
            red1[wr * kChunk + col + 1] = s1;
          }
        }
      };
      if (act == kRelu)
        epi(std::integral_constant<int, kRelu>());
      else if (act == kQuickGelu)
        epi(std::integral_constant<int, kQuickGelu>());
      else
        epi(std::integral_constant<int, kGelu>());
      wg::fence_async_smem();   // the dh tile, before dx's product reads it
      wg::named_sync(kSync, kConsumers);
      wg::mbar_wait(&bars[1], ch & 1);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        wg::mma<K::HALF>(acc, wg::kstep_desc(a_dh, ks, 0),
                         wg::kstep_desc(b_w1, ks, 0), 1);
      wg::commit();
      // while it runs: g and dh out as 16-byte pieces of rows, db1's
      // partial of the chunk (the warps' sums in order)
      for (int c = tid; c < 2 * kRows * 8; c += kConsumers) {
        const int r = (c >> 3) & (kRows - 1), piece = c & 7;
        const int row = row0 + r;
        if (row >= p.M) continue;
        const uint8_t* src = (c < kRows * 8 ? dh_t : g_t) + r * 128 +
                             (((piece ^ r) & 7) << 4);
        bf16* dst = (c < kRows * 8 ? p.dh : p.g) +
                    static_cast<size_t>(row) * F + f0 + 8 * piece;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      }
      if (tid < kChunk)
        part[3 * C + f0 + tid] = red1[tid] + red1[kChunk + tid] +
                                 red1[2 * kChunk + tid] +
                                 red1[3 * kChunk + tid];
      wg::wait<0>();
      wg::fence_acc(acc);
      if (t == 0) wg::mbar_arrive(&bars[3]);   // slot 1 is free
    }
    dx_rows<K, true>(p, sm, acc, tid, row0);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 1)
    proj_resln_bwd_wg_kernel(const __grid_constant__ CUtensorMap w_map,
                             const WgArgs p) {
  constexpr int C = K::C, NKB = C / 64;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* sm = aligned_base(wg_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + K::off_bar);
  const int tid = threadIdx.x, row0 = blockIdx.x * kRows;
  init_bars(bars);
  if (tid >= kConsumers) {
    // the producer: W's K-block kb (its columns 64 kb.., all C rows) into
    // slot kb % 2 once that slot is released
    wg::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int kb = 0; kb < NKB; ++kb) {
        const int s = kb & 1, u = kb >> 1;
        if (s == 1)
          wg::mbar_wait(&bars[3], u & 1);   // phase 0: the prologue's
        else if (u > 0)
          wg::mbar_wait(&bars[2], (u - 1) & 1);
        wg::mbar_expect(&bars[s], K::slot);
        for (int q = 0; q < C / K::BR; ++q)
          wg::tma_load(sm + K::tile + s * K::slot + q * K::BR * 128, &w_map,
                       64 * kb, q * K::BR, &bars[s]);
      }
    }
  } else {
    wg::setmaxnreg_inc<kConsumerRegs>();
    float* part = p.part + static_cast<size_t>(blockIdx.x) * 3 * C;
    ln_bwd_rows<K>(p, sm, tid, row0, part);
    const int v = tid >> 7, t = tid & 127;
    if (t == 0) wg::mbar_arrive(&bars[3]);   // slot 1's scratch is free
    const uint32_t a_dz = smem_u32(sm);
    const uint32_t b0 = smem_u32(sm + K::tile) + v * K::HALF * 128;
    float acc[K::HALF / 2];
#pragma unroll
    for (int i = 0; i < K::HALF / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < NKB; ++kb) {
      const int s = kb & 1;
      wg::mbar_wait(&bars[s], (kb >> 1) & 1);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::mma<K::HALF>(acc, wg::kstep_desc(a_dz + kb * K::kblock, ks, 0),
                         wg::kstep_desc(b0 + s * K::slot, ks, 0), 1);
      wg::commit();
      wg::wait<1>();   // the previous K-block's products are done
      if (kb > 0 && t == 0) wg::mbar_arrive(&bars[2 + (s ^ 1)]);
    }
    wg::wait<0>();
    wg::fence_acc(acc);
    dx_rows<K, false>(p, sm, acc, tid, row0);
  }
}

// The block plan the launch passes (resln_bwd_plan in ops/cuda/mlp.py)
struct WgPlan {
  int rows, chunk, threads;
  long long smem;
};

template <typename K, typename Kernel>
cudaError_t check_plan(Kernel kernel, const WgPlan& plan) {
  if (plan.rows != kRows || plan.chunk != kChunk ||
      plan.threads != kThreads || plan.smem != static_cast<long long>(K::smem))
    return cudaErrorInvalidValue;
  return allow_smem(kernel, K::smem);
}

template <int C>
cudaError_t launch_mlp(const WgArgs& p, const void* w1, const void* w2,
                       int act, const WgPlan& plan, float* part2, float* sums,
                       int per, cudaStream_t s) {
  using K = WgCfg<C, true>;
  if (p.F % kChunk != 0) return cudaErrorInvalidValue;
  auto kernel = mlp_resln_bwd_wg_kernel<K>;
  cudaError_t err = check_plan<K>(kernel, plan);
  if (err != cudaSuccess) return err;
  CUtensorMap m1, m2;
  err = wg::bf16_map(&m1, w1, C, p.F, K::BR);        // W1 (C, F)
  if (err != cudaSuccess) return err;
  err = wg::bf16_map(&m2, w2, p.F, C, kChunk);       // W2 (F, C)
  if (err != cudaSuccess) return err;
  const int nb = (p.M + kRows - 1) / kRows;
  kernel<<<nb, kThreads, K::smem, s>>>(m1, m2, p, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return group_sums(p.part, part2, sums, nb, 3 * C + p.F, per, s);
}

template <int C>
cudaError_t launch_proj(const WgArgs& p, const void* w, const WgPlan& plan,
                        float* part2, float* sums, int per, cudaStream_t s) {
  using K = WgCfg<C, false>;
  auto kernel = proj_resln_bwd_wg_kernel<K>;
  cudaError_t err = check_plan<K>(kernel, plan);
  if (err != cudaSuccess) return err;
  CUtensorMap m;
  err = wg::bf16_map(&m, w, C, C, K::BR);            // W (C in, C out)
  if (err != cudaSuccess) return err;
  const int nb = (p.M + kRows - 1) / kRows;
  kernel<<<nb, kThreads, K::smem, s>>>(m, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return group_sums(p.part, part2, sums, nb, 3 * C, per, s);
}

}  // namespace
}  // namespace idvs

// The FFN tail's fused backward, bf16: ypre, dout, dz, dx (M, C); h, g, dh
// (M, F); w1 (C, F) and w2 (F, C) in (in, out) layout; gamma (C,) float;
// all 16-byte aligned. part: blocks * (3C + F) floats, part2: ceil(blocks
// / per) * (3C + F), sums: 3C + F floats = (dgamma, dbeta, db2, db1),
// blocks = ceil(M / rows). activation: 0 GELU, 1 ReLU, 2 quick_gelu.
// rows, chunk, threads, smem: the block plan (resln_bwd_plan), which must
// be the one built for C; C one of 128, 256, 512 and F a multiple of
// chunk. Dropout as the forward (dropout.cuh).
extern "C" int idvs_mlp_resln_bwd_wg(
    const void* ypre, const void* dout, const void* gamma, const void* h,
    const void* w1, const void* w2, void* dz, void* g, void* dh, void* dx,
    void* part, void* part2, void* sums, int M, int C, int F, float eps,
    int activation, unsigned drop_key, unsigned drop_thresh, float drop_scale,
    int per, int rows, int chunk, int threads, long long smem, int dtype,
    void* stream) {
  using namespace idvs;
  if (dtype != kBF16 || M < 1 || F < 1 || per < 1 || activation < 0 ||
      activation > 2 || !ypre || !dout || !gamma || !h || !w1 || !w2 || !dz ||
      !g || !dh || !dx || !part || !part2 || !sums)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgArgs p{static_cast<const bf16*>(ypre),
                 static_cast<const bf16*>(dout),
                 static_cast<const bf16*>(h),
                 static_cast<const float*>(gamma),
                 static_cast<bf16*>(dz),
                 nullptr,
                 static_cast<bf16*>(g),
                 static_cast<bf16*>(dh),
                 static_cast<bf16*>(dx),
                 static_cast<float*>(part),
                 M,
                 F,
                 eps,
                 Drop{drop_key, drop_thresh, drop_scale}};
  const WgPlan plan{rows, chunk, threads, smem};
  float* p2 = static_cast<float*>(part2);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128:
      return static_cast<int>(
          launch_mlp<128>(p, w1, w2, activation, plan, p2, sm, per, s));
    case 256:
      return static_cast<int>(
          launch_mlp<256>(p, w1, w2, activation, plan, p2, sm, per, s));
    case 512:
      return static_cast<int>(
          launch_mlp<512>(p, w1, w2, activation, plan, p2, sm, per, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The projection tail's fused backward, bf16: ypre, dout, dz, dres, dx
// (M, C); w (C, C) in (in, out) layout; gamma (C,) float; all 16-byte
// aligned. part: blocks * 3C floats, part2: ceil(blocks / per) * 3C,
// sums: 3C floats = (dgamma, dbeta, db). The plan and C as above.
extern "C" int idvs_proj_resln_bwd_wg(
    const void* ypre, const void* dout, const void* gamma, const void* w,
    void* dz, void* dres, void* dx, void* part, void* part2, void* sums,
    int M, int C, float eps, unsigned drop_key, unsigned drop_thresh,
    float drop_scale, int per, int rows, int chunk, int threads,
    long long smem, int dtype, void* stream) {
  using namespace idvs;
  if (dtype != kBF16 || M < 1 || per < 1 || !ypre || !dout || !gamma || !w ||
      !dz || !dres || !dx || !part || !part2 || !sums)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgArgs p{static_cast<const bf16*>(ypre),
                 static_cast<const bf16*>(dout),
                 nullptr,
                 static_cast<const float*>(gamma),
                 static_cast<bf16*>(dz),
                 static_cast<bf16*>(dres),
                 nullptr,
                 nullptr,
                 static_cast<bf16*>(dx),
                 static_cast<float*>(part),
                 M,
                 C,
                 eps,
                 Drop{drop_key, drop_thresh, drop_scale}};
  const WgPlan plan{rows, chunk, threads, smem};
  float* p2 = static_cast<float*>(part2);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128:
      return static_cast<int>(launch_proj<128>(p, w, plan, p2, sm, per, s));
    case 256:
      return static_cast<int>(launch_proj<256>(p, w, plan, p2, sm, per, s));
    case 512:
      return static_cast<int>(launch_proj<512>(p, w, plan, p2, sm, per, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pre-LN MLP's backward in bf16 at C = 512, 768 and 1024 (Swin-T stage
// 3, Swin-B stages 2-3; the "wg" route of premlp_bwd_plan in
// ops/cuda/mlp.py): the row-local half of the TPU kernel
// idvs/morec_tpu/ops/pallas/mlp.py _bwd_kernel (:134-210, under fused_mlp
// :907 and fused_mlp_res :966), with its rounding points,
//   h   = f32(xn @ W1) + b1          (or the forward's saved cast(h))
//   g   = cast(act(h)),  dg = f32(dy @ W2^T),  dh = cast(dg * act'(h))
//   db1 = colsum(dh),    db2 = colsum(dy)
// in one warp-specialised kernel, premlp_bwd_wg_kernel, whose two products
// run on Hopper's warpgroup tensor-core instruction (wgmma, wgmma.cuh).
// Around it the route runs premlp_bwd.cu's row pass (xn = cast(LN(x)) and
// dy = cast(s dout) in one pass), gemm.cu's dW2 = g^T dy, dW1 = xn^T dh
// and dxn = dh W1^T, and premlp_bwd.cu's LayerNorm backward.
//
// Why a kernel of its own: premlp_bwd.cu's row kernel keeps a block's rows
// of x and dy at full width C in shared memory and dxn in registers, which
// at C = 768 exceed a block's 227 KB and a thread's registers. Before this
// kernel, C >= 512 took gemm.cu's five products: h written as float32
// (173 MB at Swin-T stage 3, 288 images) and read twice, an act_cast pass
// and a column sum of dh, 1.93-1.97 ms of device time a call (PERF.md).
// Here nothing is C wide: a block owns a tile of 128 rows x 128 columns of
// F and walks K = C in K-blocks of 64, so h and dg never leave registers
// and g and dh are written once, in bf16.
//
// Bound on the H100 (Swin-T stage 3, M = 14112, C = 768, F = 3072): the
// two products are 4 M C F = 133 GFLOP, 0.135 ms at 989 TFLOP/s, against
// 2 M C + 2 C F bf16 read and 2 M F written (222 MB, 0.066 ms at 3.35
// TB/s): operations. But each block reads its rows' xn and dy and its
// columns' W1 and W2 K-blocks from L2, 64 operations a byte of L2
// traffic (2.1 GB at stage 3): at 0.333 ms the L2 delivers about 6.3
// TB/s, and the tensor cores run at 40 % of their peak. A 2 x 2 cluster
// whose blocks multicast half of each K-block to their neighbours (TMA
// .multicast::cluster) halved that traffic and measured 2.1x slower, each
// stage then waiting on three blocks' consumers (PERF.md).
//
// Block: 384 threads. A producer warpgroup gives its registers away
// (setmaxnreg) and one of its threads brings each K-block by TMA (128-byte
// swizzle) into a ring of 3 stages of 64 KB on mbarriers: xn's and dy's
// 128 rows x 64 (the A operands, K-major), W1's 64 k x 128 columns as two
// [64 k][64 n] boxes (B, MN-major: wgmma reads it transposed) and W2's 128
// rows x 64 k (B, K-major). Two consumer warpgroups, warpgroup v owning
// rows 64v..64v+63, run h += xn W1 and dg += dy W2^T on m64n128k16 into two
// 64 x 128 float accumulators (128 registers a thread under its cap of
// 232). Each consumer warp releases a stage (an arrival on its empty
// mbarrier) as soon as its products and its db2 reads are done: with the
// L2 the limit, two stages in flight measured 3.5 % faster than one group
// of products in flight and one stage (PERF.md). The save_h edition loads
// neither xn nor W1 and runs dg alone. The block of F-tile ft also adds,
// for db2, the columns of each dy K-block kb with kb % (F / 128) == ft
// over its rows, while the products read the same stage.
//
// Epilogue on the accumulators: h = acc + b1 (or the saved h, read at the
// accumulators' positions), act and act' once an element (mlp_mma.cuh
// act_dact: GELU's erf as the TPU kernel's _erf, relu, quick_gelu),
// g and dh cast to bf16 into two swizzled [128][128] tiles over the
// drained ring, then stored as 16-byte pieces of rows; rows past M (TMA
// fills them with zeros, so there h = b1 and g = act(b1) != 0) are never
// stored nor summed. db1's column sums come from the cast dh: 16-row sums
// by shuffles, then the 8 warps' in order. Each row tile's blocks write
// one partial row (db2 | db1, C + F floats); reduce.cuh's group_sums adds
// the row tiles in a fixed order: no atomics, two runs give the same bits.
#include "mlp_mma.cuh"
#include "reduce.cuh"
#include "wgmma.cuh"

namespace idvs {
namespace {

constexpr int kRows = 128;       // a block's rows: an m64 tile a consumer
constexpr int kCols = 128;       // a block's columns of F: the products' N
constexpr int kDepth = 64;       // K a stage holds: one 128-byte line
constexpr int kStages = 3;
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = 384;    // and the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSync = 1;         // the consumers' named barrier

template <int C_>
struct GdhCfg {
  static constexpr int C = C_, NKB = C / kDepth;
  static constexpr uint32_t a_tile = kRows * kDepth * 2;   // xn or dy
  static constexpr uint32_t w_half = kDepth * 64 * 2;      // a W1 box
  static constexpr uint32_t off_dy = a_tile, off_w1 = 2 * a_tile;
  static constexpr uint32_t off_w2 = off_w1 + 2 * w_half;
  static constexpr uint32_t stage = off_w2 + kCols * kDepth * 2;
  static constexpr uint32_t off_red1 = kStages * stage;   // [8][128] floats
  static constexpr uint32_t off_red2 = off_red1 + 8 * kCols * 4;  // [2][C]
  static constexpr uint32_t off_bar = off_red2 + 2 * C * 4;
  static constexpr size_t smem = off_bar + 2 * kStages * 8 + 1024;
  static constexpr uint32_t out_half = kRows * 128;   // 64 columns of g
  static_assert(C % kDepth == 0, "C in whole K-blocks");
  static_assert(smem <= kMaxSmem, "the ring does not fit in shared memory");
  static_assert(4 * out_half <= kStages * stage, "g and dh fit the ring");
};

struct GdhArgs {
  const bf16 *b1, *h;   // h: the save_h edition's (M, F), or null
  bf16 *g, *dh;         // (M, F)
  float* part;          // (row tiles, C + F): db2 | db1
  int M, F;
};

// the sum over the 8 lanes of a quad column: 16 rows of one accumulator
// column
__device__ __forceinline__ float col_sum8(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// byte offset of (row, col) in a [128][128] bf16 tile stored as two
// swizzled halves of 64 columns
__device__ __forceinline__ uint32_t out_offset(int row, int col) {
  return (col >> 6) * (kRows * 128) + wg::sw128_offset(row, col & 63);
}

template <typename K, bool kSaved>
__global__ void __launch_bounds__(kThreads, 1)
    premlp_bwd_wg_kernel(const __grid_constant__ CUtensorMap xn_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const __grid_constant__ CUtensorMap w1_map,
                         const __grid_constant__ CUtensorMap w2_map,
                         const GdhArgs p, int act) {
  constexpr int C = K::C, NKB = K::NKB;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* sm = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K::off_bar);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, ft = blockIdx.x, nft = gridDim.x;
  const int row0 = blockIdx.y * kRows, f0 = ft * kCols;
  if (tid == 0) {
    // full: the producer's arrival and the bytes; empty: one arrival from
    // each consumer warp, once its products and its db2 reads are done
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumers / 32);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kConsumers) {
    wg::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      constexpr uint32_t bytes =
          kSaved ? K::a_tile + kCols * kDepth * 2 : K::stage;
      for (int kb = 0; kb < NKB; ++kb) {
        const int s = kb % kStages, k0 = kb * kDepth;
        if (kb >= kStages) wg::mbar_wait(&empty[s], (kb / kStages - 1) & 1);
        uint8_t* st = sm + s * K::stage;
        wg::mbar_expect(&full[s], bytes);
        wg::tma_load(st + K::off_dy, &dy_map, k0, row0, &full[s]);
        wg::tma_load(st + K::off_w2, &w2_map, k0, f0, &full[s]);
        if (!kSaved) {
          wg::tma_load(st, &xn_map, k0, row0, &full[s]);
          wg::tma_load(st + K::off_w1, &w1_map, f0, k0, &full[s]);
          wg::tma_load(st + K::off_w1 + K::w_half, &w1_map, f0 + 64, k0,
                       &full[s]);
        }
      }
    }
    return;
  }
  wg::setmaxnreg_inc<kConsumerRegs>();
  const int v = tid >> 7, t = tid & 127, wr = t >> 5, lane = t & 31;
  float* red1 = reinterpret_cast<float*>(sm + K::off_red1);
  float* red2 = reinterpret_cast<float*>(sm + K::off_red2);
  // db2: this warpgroup's rows below M
  const int rows_v = min(64, max(0, p.M - row0 - 64 * v));
  float hacc[64], dacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) hacc[i] = dacc[i] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb) {
    const int s = kb % kStages;
    wg::mbar_wait(&full[s], (kb / kStages) & 1);
    const uint32_t st = smem_u32(sm + s * K::stage);
    const uint32_t a_xn = st + v * 64 * 128, a_dy = a_xn + K::off_dy;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      if (!kSaved)
        wg::wgmma_m64n128<1>(
            hacc, wg::sw128_desc(a_xn + 32 * ks),
            wg::sw128_desc_mn(st + K::off_w1 + 2048 * ks, K::w_half), 1);
      wg::wgmma_m64n128(dacc, wg::sw128_desc(a_dy + 32 * ks),
                        wg::sw128_desc(st + K::off_w2 + 32 * ks), 1);
    }
    wg::commit();
    if (kb % nft == ft && t < 64) {
      // db2: column k0 + t over the warpgroup's rows, read from the stage
      const uint8_t* dyt = sm + s * K::stage + K::off_dy + v * 64 * 128;
      float sum = 0.f;
      for (int r = 0; r < rows_v; ++r)
        sum += __bfloat162float(*reinterpret_cast<const bf16*>(
            dyt + wg::sw128_offset(r, t)));
      red2[v * C + kb * kDepth + t] = sum;
    }
    wg::wait<0>();   // this K-block's products are done
    // each warp releases the stage itself: a warp's wait covers its own
    // lanes, and warps 0 and 1 of a warpgroup read the dy tile for db2
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }
  wg::fence_acc(hacc);
  wg::fence_acc(dacc);
  // both warpgroups' products are done with the ring: g and dh over it
  wg::named_sync(kSync, kConsumers);
  uint8_t* g_t = sm;
  uint8_t* dh_t = sm + 2 * K::out_half;
  const int r0 = 64 * v + 16 * wr + (lane >> 2);   // tile row, + 8 hh
  auto epi = [&](auto a_) {
    constexpr int A = decltype(a_)::value;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 b =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p.b1 + f0 + col));
      uint32_t dhp[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh, row = r0 + 8 * hh;
        const bool live = row0 + row < p.M;
        float h0, h1;
        if constexpr (kSaved) {
          const uint32_t hb =
              live ? *reinterpret_cast<const uint32_t*>(
                         p.h + static_cast<size_t>(row0 + row) * p.F + f0 +
                         col)
                   : 0u;
          h0 = lo_f32(hb);
          h1 = hi_f32(hb);
        } else {
          h0 = hacc[i] + b.x;
          h1 = hacc[i + 1] + b.y;
        }
        float ga0, da0, ga1, da1;
        act_dact<A>(h0, ga0, da0);
        act_dact<A>(h1, ga1, da1);
        dhp[hh] = live ? pack_bf16(dacc[i] * da0, dacc[i + 1] * da1) : 0u;
        const uint32_t off = out_offset(row, col);
        *reinterpret_cast<uint32_t*>(dh_t + off) = dhp[hh];
        *reinterpret_cast<uint32_t*>(g_t + off) = pack_bf16(ga0, ga1);
      }
      // db1 from the cast dh: the warp's 16 rows of both columns
      const float s0 = col_sum8(lo_f32(dhp[0]) + lo_f32(dhp[1]));
      const float s1 = col_sum8(hi_f32(dhp[0]) + hi_f32(dhp[1]));
      if ((lane >> 2) == 0) {
        red1[(4 * v + wr) * kCols + col] = s0;
        red1[(4 * v + wr) * kCols + col + 1] = s1;
      }
    }
  };
  if (act == kRelu)
    epi(std::integral_constant<int, kRelu>());
  else if (act == kQuickGelu)
    epi(std::integral_constant<int, kQuickGelu>());
  else
    epi(std::integral_constant<int, kGelu>());
  wg::named_sync(kSync, kConsumers);
  // g and dh out as 16-byte pieces of rows, rows past M left out
  for (int c = tid; c < 2 * kRows * 16; c += kConsumers) {
    const int which = c / (kRows * 16), r = (c >> 4) & (kRows - 1);
    const int piece = c & 15, row = row0 + r;
    if (row >= p.M) continue;
    const uint8_t* src = (which ? g_t : dh_t) + (piece >> 3) * K::out_half +
                         r * 128 + ((((piece & 7) ^ r) & 7) << 4);
    bf16* dst = (which ? p.g : p.dh) + static_cast<size_t>(row) * p.F + f0 +
                8 * piece;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
  // the row tile's partial row: db1's columns (the 8 warps' 16-row sums in
  // order), db2's K-blocks (the two warpgroups' in order)
  float* part = p.part + static_cast<size_t>(blockIdx.y) * (C + p.F);
  if (tid < kCols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red1[w * kCols + tid];
    part[C + f0 + tid] = s;
  }
  for (int kb = ft; kb < NKB; kb += nft)
    if (tid < kDepth)
      part[kb * kDepth + tid] =
          red2[kb * kDepth + tid] + red2[C + kb * kDepth + tid];
}

// The block plan the launch passes (premlp_bwd_plan in ops/cuda/mlp.py)
struct GdhPlan {
  int rows, f_tile, stages, threads, producer_regs, consumer_regs;
  long long smem;
};

template <int C>
cudaError_t launch_gdh(const void* xn, const void* dy, const void* w1,
                       const void* w2, const GdhArgs& p, int act,
                       const GdhPlan& plan, float* part2, float* sums,
                       int per, cudaStream_t s) {
  using K = GdhCfg<C>;
  const int nb = (p.M + kRows - 1) / kRows;
  if (plan.rows != kRows || plan.f_tile != kCols ||
      plan.stages != kStages || plan.threads != kThreads ||
      plan.producer_regs != kProducerRegs ||
      plan.consumer_regs != kConsumerRegs ||
      plan.smem != static_cast<long long>(K::smem) || p.F % kCols != 0 ||
      nb > 65535)
    return cudaErrorInvalidValue;
  auto kernel = p.h != nullptr ? premlp_bwd_wg_kernel<K, true>
                               : premlp_bwd_wg_kernel<K, false>;
  cudaError_t err = allow_smem(kernel, K::smem);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, dm, m1, m2;
  if ((err = wg::bf16_map(&xm, xn, p.M, C, kRows)) != cudaSuccess ||
      (err = wg::bf16_map(&dm, dy, p.M, C, kRows)) != cudaSuccess ||
      (err = wg::bf16_map(&m1, w1, C, p.F, kDepth)) != cudaSuccess ||
      (err = wg::bf16_map(&m2, w2, p.F, C, kCols)) != cudaSuccess)
    return err;
  kernel<<<dim3(p.F / kCols, nb), kThreads, K::smem, s>>>(xm, dm, m1, m2, p,
                                                          act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return group_sums(p.part, part2, sums, nb, C + p.F, per, s);
}

}  // namespace
}  // namespace idvs

// The wg route's kernel, bf16: xn, dy (M, C); w1 (C, F), w2 (F, C) in (in,
// out) layout, b1 (F,); hsave (the save_h edition's cast h) or null, g, dh
// (M, F); all 16-byte aligned. part: ceil(M / rows) * (C + F) floats,
// part2: ceil(ceil(M / rows) / per) * (C + F), sums: C + F floats = (db2,
// db1). activation: 0 GELU, 1 ReLU, 2 x*sigmoid(1.702x). rows, f_tile,
// stages, threads, producer_regs, consumer_regs, smem: the block plan
// (premlp_bwd_plan), which must be the one built for C; C one of 512, 768,
// 1024 and F a multiple of f_tile.
extern "C" int idvs_premlp_bwd_wg(
    const void* xn, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* hsave, void* g, void* dh, void* part,
    void* part2, void* sums, int M, int C, int F, int activation, int per,
    int rows, int f_tile, int stages, int threads, int producer_regs,
    int consumer_regs, long long smem, int dtype, void* stream) {
  using namespace idvs;
  if (dtype != kBF16 || M < 1 || F < 1 || per < 1 || activation < 0 ||
      activation > 2 || !xn || !dy || !w1 || !b1 || !w2 || !g || !dh ||
      !part || !part2 || !sums)
    return static_cast<int>(cudaErrorInvalidValue);
  const GdhArgs p{static_cast<const bf16*>(b1),
                  static_cast<const bf16*>(hsave),
                  static_cast<bf16*>(g),
                  static_cast<bf16*>(dh),
                  static_cast<float*>(part),
                  M,
                  F};
  const GdhPlan plan{rows,          f_tile,        stages, threads,
                     producer_regs, consumer_regs, smem};
  float* p2 = static_cast<float*>(part2);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 512:
      return static_cast<int>(launch_gdh<512>(xn, dy, w1, w2, p, activation,
                                              plan, p2, sm, per, s));
    case 768:
      return static_cast<int>(launch_gdh<768>(xn, dy, w1, w2, p, activation,
                                              plan, p2, sm, per, s));
    case 1024:
      return static_cast<int>(launch_gdh<1024>(xn, dy, w1, w2, p, activation,
                                               plan, p2, sm, per, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

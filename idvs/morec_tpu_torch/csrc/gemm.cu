// The matrix products of every backward in the port, as one tiled kernel
// with float accumulation and the epilogues those products need.
//
// Replaces the products inside idvs/morec_tpu/ops/pallas/mlp.py
// _bwd_proj_kernel (:759-762: dW = xᵀ dz, dx = dz Wᵀ), _bwd_post_kernel
// (:485-494: dW2 = cast(act(h))ᵀ dz, dg = dz W2ᵀ, dh = cast(dg * act'(h)),
// dW1 = xᵀ dh, dx = dh W1ᵀ + dyp) and _bwd_kernel (:134, the pre-LN MLP's
// recomputed h and its gradients), and those inside the backward of
// attention.py's fused_mha_proj (:597) and fused_mha_proj_band (:873): the
// recomputed qkv, dctx, and the weight and input gradients. On the TPU the
// weight gradients sum over every row of M into a resident buffer across a
// sequential grid; the H100's blocks run in parallel and in no order, so a
// product whose reduction runs over M (K here) is split into `splits`
// slices of K, each block writes its float partial tile, and a second pass
// adds the slices in a fixed order (deterministic, no atomics).
//
//   out[m][n] = epi( sum_k pro(A(m, k)) * B(k, n) )
//   A(m, k) = A[m * sam + k * sak],  B(k, n) = B[k * sbk + n * sbn]
// so a transposed operand is only a pair of strides. pro() is the identity
// or cast(act(.)) (the recomputed activation of the FFN's saved h, which is
// in the compute dtype or, where the backward recomputed it, float; a float
// A is cast to the compute dtype); epi() adds a bias row, a float addend
// and/or multiplies by act'(gate), then casts to the compute dtype or
// stores float.
//
// Bound on the H100, bf16. The text FFN's products (M = 23040 rows, C =
// 512, F = 2048: 48 GFLOP each) are bound by arithmetic, 0.049 ms each at
// the 989 TFLOP/s dense rate. Swin stage 0's (903168 rows for 288 images,
// C = 96, F = 384) are bound by bytes: K is 96 to 384 deep, or M and N are
// 96 to 384 wide, so the operands and the output are read and written
// once at 3.35 TB/s (0.207 ms for the recomputed qkv). Design
// (gemm_mma_kernel): the products run on the tensor cores as mma.sync
// m16n8k16 bf16 with float accumulators (mma.cuh). The operands go to
// shared memory unwidened, by 16-byte cp.async copies in their natural
// layouts ([rows][k] where k is contiguous in device memory, [k][rows]
// where the rows are), in a ring of kStages stages of a 128 x 128 x 32
// block tile, each shared row padded by 16 bytes so that the ldmatrix
// reads (.trans for a [k][rows] tile) are free of bank conflicts. Eight
// warps each own a 64 x 32 tile of float accumulators, two blocks an SM
// (Swin stage 0's 3C = 288 ends in a tile a quarter used). Edges are copies
// that zero-fill the bytes past M, N or K (src-size < 16), so any M, N
// and K are taken as long as every operand row starts 16 bytes aligned
// (the wrapper checks: base aligned, the non-unit stride a multiple of 8).
// An A that needs its prologue (cast(act(h)), or a float A) goes first
// through act_cast_kernel, one elementwise pass that writes cast(act(A))
// in bf16 (act runs once an element, not once for every N tile; rounding
// where JAX rounds, mlp.py:485): it adds a read of A and a write of half
// as many bytes or as many. The epilogue runs after the last K step: the
// accumulator fragments go to a float tile in the stages' shared memory,
// and each thread then takes 8 neighbouring columns of a row at a time,
// so bias, addend, gate and output move as whole 16- and 32-byte pieces of
// rows (element by element only at an edge). For the byte-bound shapes
// the grid walks the N tiles of one M tile together, so A is read from
// device memory once and from L2 again. The split over K is chosen in one
// place (choose_splits, which the wrapper asks for the workspace's size).
// mma.sync reaches well under the card's full bf16 rate, a 128 x 128 x 32
// step reads 64 operations' worth a byte from L2, and this design stays
// well under half the peak at the text shapes (PERF.md): warp-group
// products (wgmma) fed by TMA on larger tiles are the way to the rest,
// later work.
//
// float32: f32 parity rules out TF32, so the products run on the float FMA
// units (67 TFLOP/s): the classic 128 x 128 x 8 register-tiled SGEMM
// (gemm_kernel): 256 threads, each owning an 8 x 8 tile in two 4-row and
// two 4-column groups 64 apart (conflict-free float4 reads of both shared
// tiles), the next K slice loaded into registers during the FMAs and
// double-buffered through shared memory. No main path trains in float32.
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace idvs {
namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kGelu = 1, kRelu = 2, kQuickGelu = 3 };

__device__ __forceinline__ float act(float h, int a) {
  if (a == kRelu) return fmaxf(h, 0.f);
  if (a == kQuickGelu) return h / (1.f + expf(-1.702f * h));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ float dact(float h, int a) {
  if (a == kRelu) return h > 0.f ? 1.f : 0.f;
  if (a == kQuickGelu) {
    const float s = 1.f / (1.f + expf(-1.702f * h));
    return s + h * 1.702f * s * (1.f - s);
  }
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  return cdf + h * 0.39894228040143268f * expf(-0.5f * h * h);
}

struct Operands {
  const void* A;
  const void* B;
  long long sam, sak, sbk, sbn;
  int M, N, K;
  int pro_act;        // Act applied (then cast) to A on load
  int a_f32;          // A holds floats, not the compute dtype
};

struct Epilogue {
  void* out;          // (M, N) row-major, compute dtype or float
  int out_f32;
  const float* add;   // (M, N) float addend, or null
  const void* gate;   // (M, N): multiply by act'(gate)
  int gate_act;
  int gate_f32;       // gate holds floats, not the compute dtype
  const void* bias;   // (N,) compute dtype, added to every row, or null
  int vec;            // N % 8 == 0 and every pointer 16-byte aligned
};

// epi() of the sum v at (m, n), before the store
template <typename T>
__device__ __forceinline__ float epi(const Epilogue& e, int N, int m, int n,
                                     float v) {
  const size_t i = static_cast<size_t>(m) * N + n;
  if (e.bias != nullptr) v += to_f32(static_cast<const T*>(e.bias)[n]);
  if (e.add != nullptr) v += e.add[i];
  if (e.gate != nullptr)
    v *= dact(e.gate_f32 ? static_cast<const float*>(e.gate)[i]
                         : to_f32(static_cast<const T*>(e.gate)[i]),
              e.gate_act);
  return v;
}

template <typename T>
__device__ __forceinline__ void store_out(const Epilogue& e, int M, int N,
                                          int m, int n, float v) {
  if (m >= M || n >= N) return;
  const size_t i = static_cast<size_t>(m) * N + n;
  v = epi<T>(e, N, m, n, v);
  if (e.out_f32)
    static_cast<float*>(e.out)[i] = v;
  else
    static_cast<T*>(e.out)[i] = from_f32<T>(v);
}

// ---- float32: the register-tiled SGEMM on the FMA units -------------------

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;

// One K slice of the A tile (kBM x kBK) and of the B tile (kBK x kBN) in
// registers: 4 elements per thread each.
template <typename T>
struct Stage {
  float a[4], b[4];

  __device__ void load(const Operands& o, int m0, int n0, int k0, int k_end) {
    const T* A = static_cast<const T*>(o.A);
    const float* Af = static_cast<const float*>(o.A);
    const T* B = static_cast<const T*>(o.B);
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // A: k-contiguous -> thread (m = t/2, k = 4(t%2)+c); else
      // m-contiguous -> (k = t/32, m = 4(t%32)+c)
      const int am = o.sak == 1 ? m0 + t / 2 : m0 + 4 * (t % 32) + c;
      const int ak = o.sak == 1 ? k0 + 4 * (t % 2) + c : k0 + t / 32;
      float va = 0.f;
      if (am < o.M && ak < k_end) {
        const long long ia = am * o.sam + ak * o.sak;
        va = o.a_f32 ? Af[ia] : to_f32(A[ia]);
        if (o.pro_act != kNone) va = round_to<T>(act(va, o.pro_act));
      }
      a[c] = va;
      // B: n-contiguous -> (k = t/32, n = 4(t%32)+c); else k-contiguous ->
      // (n = t/2, k = 4(t%2)+c)
      const int bk = o.sbn == 1 ? k0 + t / 32 : k0 + 4 * (t % 2) + c;
      const int bn = o.sbn == 1 ? n0 + 4 * (t % 32) + c : n0 + t / 2;
      b[c] = (bk < k_end && bn < o.N) ? to_f32(B[bk * o.sbk + bn * o.sbn])
                                      : 0.f;
    }
  }

  __device__ void store(const Operands& o, float* As, float* Bs) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (o.sak == 1)
        As[(4 * (t % 2) + c) * kBM + t / 2] = a[c];
      else
        As[(t / 32) * kBM + 4 * (t % 32) + c] = a[c];
      if (o.sbn == 1)
        Bs[(t / 32) * kBN + 4 * (t % 32) + c] = b[c];
      else
        Bs[(4 * (t % 2) + c) * kBN + t / 2] = b[c];
    }
  }
};

// grid (N tiles, M tiles, splits). With one split the epilogue runs here;
// otherwise slice z writes its raw float tile to ws[z] (M x N).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(Operands o, Epilogue e, float* __restrict__ ws) {
  __shared__ __align__(16) float As[2][kBK * kBM];
  __shared__ __align__(16) float Bs[2][kBK * kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int per = (o.K + gridDim.z - 1) / gridDim.z;
  const int k_chunk = (per + kBK - 1) / kBK * kBK;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(o.K, k_begin + k_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8] = {};
  Stage<T> st;
  if (k_begin < k_end) {
    st.load(o, m0, n0, k_begin, k_end);
    st.store(o, As[0], Bs[0]);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const bool more = k0 + kBK < k_end;
    if (more) st.load(o, m0, n0, k0 + kBK, k_end);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float* as = As[buf] + k * kBM + 4 * ty;
      const float* bs = Bs[buf] + k * kBN + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(as);
      const float4 a1 = *reinterpret_cast<const float4*>(as + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bs);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) st.store(o, As[buf ^ 1], Bs[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 4 * tx + (j & 3) + 64 * (j >> 2);
      if (gridDim.z == 1) {
        store_out<T>(e, o.M, o.N, m, n, acc[i][j]);
      } else if (m < o.M && n < o.N) {
        ws[(static_cast<size_t>(blockIdx.z) * o.M + m) * o.N + n] =
            acc[i][j];
      }
    }
  }
}

// ---- bf16: mma.sync on the tensor cores -----------------------------------

constexpr int kTM = 128, kTN = 128, kTK = 32, kStages = 4;
constexpr int kMmaThreads = 256, kWarpsN = 4;   // 2 x 4 warps
constexpr int kWM = 64, kWN = 32;               // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;    // its m16 and n8 tiles
constexpr int kPad = 8;                         // bf16 padding a shared row
constexpr int kBlocksPerSm = 2;
// the float tile the epilogue reads back, [kTM][kLdC]: 16 threads a row,
// 8 columns each
constexpr int kLdC = kTN + 8;
constexpr int kRowThreads = kTN / 8, kRowsAPass = kMmaThreads / kRowThreads;
// Each block slice of K is at least this deep (8 K steps), and a
// product is split over K only while its tiles fill few block slots.
constexpr int kMinDepth = 256;

// One operand's tile of a stage in shared memory: [rows][kTK] when k is
// its contiguous dimension in device memory (KMaj), else [kTK][rows];
// each row padded by kPad elements (16 bytes).
template <bool KMaj, int Rows>
struct Smem {
  static constexpr int kLd = KMaj ? kTK + kPad : Rows + kPad;
  static constexpr int kSize = KMaj ? Rows * kLd : kTK * kLd;   // elements
  // 16-byte chunks (8 elements) a thread copies of a stage
  static constexpr int kChunks = Rows * kTK / 8 / kMmaThreads;
  static_assert(kChunks * kMmaThreads * 8 == Rows * kTK, "whole chunks");

  // (row, k) within the tile of chunk c's first element
  __device__ static void chunk(int c, int& r, int& k) {
    if (KMaj) {
      r = c / (kTK / 8);
      k = c % (kTK / 8) * 8;
    } else {
      k = c / (Rows / 8);
      r = c % (Rows / 8) * 8;
    }
  }
  __device__ static int offset(int r, int k) {
    return KMaj ? r * kLd + k : k * kLd + r;
  }
};

// shared memory of a block: the stages' ring, which the epilogue's float
// tile reuses
template <bool AK, bool BK>
constexpr size_t mma_smem() {
  return std::max(kStages * (Smem<AK, kTM>::kSize + Smem<BK, kTN>::kSize) *
                      sizeof(bf16),
                  sizeof(float) * kTM * kLdC);
}

// cp.async of one operand's stage: its chunks a thread, the bytes past
// `rows` x k_end zero-filled (and not read)
template <bool KMaj, int Rows>
__device__ __forceinline__ void copy_stage(bf16* dst, const bf16* base,
                                           long long sr, long long sk,
                                           int r0, int k0, int rows,
                                           int k_end) {
#pragma unroll
  for (int i = 0; i < Smem<KMaj, Rows>::kChunks; ++i) {
    int r, k;
    Smem<KMaj, Rows>::chunk(threadIdx.x + i * kMmaThreads, r, k);
    r += r0, k += k0;
    // the chunk runs along k (KMaj) or along r
    int n = KMaj ? (r < rows ? k_end - k : 0) : (k < k_end ? rows - r : 0);
    n = max(0, min(8, n));
    const bf16* src = n > 0 ? base + r * sr + k * sk : base;
    cp_async16_zfill(dst + Smem<KMaj, Rows>::offset(r - r0, k - k0), src,
                     2 * n);
  }
}

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// 8 neighbouring sums at (m, n..n+7) through the epilogue to the output:
// 16- and 32-byte loads and stores where e.vec says every (M, N) operand
// and N allow them and the 8 columns lie inside N, else element by element
__device__ __forceinline__ void store_row8(const Epilogue& e, int M, int N,
                                           int m, int n, float (&v)[8]) {
  if (!(e.vec && n + 8 <= N)) {
#pragma unroll
    for (int c = 0; c < 8; ++c) store_out<bf16>(e, M, N, m, n + c, v[c]);
    return;
  }
  const size_t i = static_cast<size_t>(m) * N + n;
  float f[8];
  if (e.bias != nullptr) {
    load8(static_cast<const bf16*>(e.bias) + n, f);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] += f[c];
  }
  if (e.add != nullptr) {
    load8(e.add + i, f);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] += f[c];
  }
  if (e.gate != nullptr) {
    if (e.gate_f32)
      load8(static_cast<const float*>(e.gate) + i, f);
    else
      load8(static_cast<const bf16*>(e.gate) + i, f);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] *= dact(f[c], e.gate_act);
  }
  if (e.out_f32) {
    store8(static_cast<float*>(e.out) + i, v);
  } else {
    *reinterpret_cast<uint4*>(static_cast<bf16*>(e.out) + i) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// One warp's fragments of a 16-deep slice of the stage: A for its kMT m16
// tiles, B for its kNT n8 tiles
template <bool AK, bool BK>
struct Frags {
  uint32_t a[kMT][4], b[kNT][2];

  __device__ __forceinline__ void load(const bf16* as, const bf16* bs,
                                       int kk, int wm, int wn, int lane) {
    using SA = Smem<AK, kTM>;
    using SB = Smem<BK, kTN>;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int m = wm * kWM + i * 16;
      if constexpr (AK)
        ldsm_x4(a[i], smem_u32(as + (m + a_row(lane)) * SA::kLd + kk +
                               a_col(lane)));
      else
        ldsm_x4_t(a[i], smem_u32(as + (kk + bn_row(lane)) * SA::kLd + m +
                                 bn_col(lane)));
    }
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      const int n = wn * kWN + j * 8;
      uint32_t r[4];
      if constexpr (BK)
        ldsm_x4(r, smem_u32(bs + (n + bn_row(lane)) * SB::kLd + kk +
                            bn_col(lane)));
      else
        ldsm_x4_t(r, smem_u32(bs + (kk + bk_row(lane)) * SB::kLd + n +
                              bk_col(lane)));
      b[j][0] = r[0], b[j][1] = r[1];
      b[j + 1][0] = r[2], b[j + 1][1] = r[3];
    }
  }
};

// grid (N tiles, M tiles, splits), as gemm_kernel. AK: A is k-contiguous
// (sak == 1), else m-contiguous; BK: B is k-contiguous (sbk == 1), else
// n-contiguous. A and B in bf16 (a prologue of A ran before, in
// act_cast_kernel).
template <bool AK, bool BK>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSm)
    gemm_mma_kernel(Operands o, Epilogue e, float* __restrict__ ws) {
  using SA = Smem<AK, kTM>;
  using SB = Smem<BK, kTN>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + kStages * SA::kSize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int per = (o.K + gridDim.z - 1) / gridDim.z;
  const int k_chunk = (per + kTK - 1) / kTK * kTK;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(o.K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kTK - 1) / kTK : 0;
  const bf16* A = static_cast<const bf16*>(o.A);
  const bf16* B = static_cast<const bf16*>(o.B);

  // stage t's copies into slot t % kStages
  auto issue = [&](int t) {
    const int k0 = k_begin + t * kTK, s = t % kStages;
    copy_stage<AK, kTM>(As + s * SA::kSize, A, o.sam, o.sak, m0, k0, o.M,
                        k_end);
    copy_stage<BK, kTN>(Bs + s * SB::kSize, B, o.sbn, o.sbk, n0, k0, o.N,
                        k_end);
  };

  float acc[kMT][kNT][4] = {};
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    // stage t has landed; every warp is done with stage t - 1, whose slot
    // stage t + kStages - 1 takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nk) issue(t + kStages - 1);
    cp_async_commit();
    const bf16* as = As + (t % kStages) * SA::kSize;
    const bf16* bs = Bs + (t % kStages) * SB::kSize;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      Frags<AK, BK> f;
      f.load(as, bs, kk, wm, wn, lane);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], f.a[i], f.b[j][0], f.b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages' memory

  // the accumulators to a float tile (fragment (i, j): rows g and g + 8,
  // columns 2q and 2q + 1, mma.cuh; conflict-free 8-byte stores a half
  // warp), then each thread walks 8 columns of a row at a time, so the
  // epilogue reads and writes whole 16- and 32-byte pieces of a row
  float* tile = reinterpret_cast<float*>(gemm_smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            tile + (wm * kWM + i * 16 + g + 8 * h) * kLdC + wn * kWN +
            j * 8 + 2 * q) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  const int c0 = threadIdx.x % kRowThreads * 8, n = n0 + c0;
  if (n >= o.N) return;
#pragma unroll 1
  for (int r = threadIdx.x / kRowThreads; r < kTM; r += kRowsAPass) {
    const int m = m0 + r;
    if (m >= o.M) break;
    float v[8];
    load8(tile + r * kLdC + c0, v);
    if (gridDim.z == 1) {
      store_row8(e, o.M, o.N, m, n, v);
    } else {   // slice z's raw partial, added by splitk_reduce_kernel
      float* w = ws + (static_cast<size_t>(blockIdx.z) * o.M + m) * o.N + n;
      if (e.vec && n + 8 <= o.N) {
        store8(w, v);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (n + c < o.N) w[c] = v[c];
      }
    }
  }
}

// dst[i] = cast(act(src[i])) for i < n, or the cast alone (act kNone): the
// prologue of a bf16 product's A, from bf16 or float, in one pass, so the
// product's blocks copy A as it is and act runs once an element
template <typename S>
__global__ void act_cast_kernel(const S* __restrict__ src,
                                bf16* __restrict__ dst, long long n, int a) {
  const long long chunks = (n + 7) / 8;
  for (long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       c < chunks; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = 8 * c;
    float f[8];
    if (i + 8 <= n) {
      load8(src + i, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = i + j < n ? to_f32(src[i + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (a != kNone) f[j] = act(f[j], a);
    if (i + 8 <= n) {
      *reinterpret_cast<uint4*>(dst + i) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i + j < n) dst[i + j] = __float2bfloat16(f[j]);
    }
  }
}

// out = epi(sum over z, in order, of ws[z])
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                                     int M, int N, Epilogue e) {
  const size_t MN = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < MN; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * MN + i];
    store_out<T>(e, M, N, static_cast<int>(i / N), static_cast<int>(i % N),
                 s);
  }
}

template <typename T>
cudaError_t reduce(const Operands& o, const Epilogue& e, float* ws,
                   int splits, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  splitk_reduce_kernel<T><<<132 * 8, 256, 0, s>>>(ws, splits, o.M, o.N, e);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Operands& o, const Epilogue& e, float* ws,
                       int splits, cudaStream_t s) {
  const dim3 grid((o.N + kBN - 1) / kBN, (o.M + kBM - 1) / kBM, splits);
  gemm_kernel<float><<<grid, kThreads, 0, s>>>(o, e, ws);
  return reduce<float>(o, e, ws, splits, s);
}

// Opts the layout's kernel into its shared memory with the largest
// carveout, once.
template <bool AK, bool BK>
cudaError_t prepare_mma() {
  static const cudaError_t err = [] {
    auto kernel = gemm_mma_kernel<AK, BK>;
    cudaError_t e = allow_smem(kernel, mma_smem<AK, BK>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <bool AK, bool BK>
cudaError_t launch_mma(const Operands& o, const Epilogue& e, float* ws,
                       int splits, cudaStream_t s) {
  const cudaError_t opt = prepare_mma<AK, BK>();
  if (opt != cudaSuccess) return opt;
  constexpr size_t smem = mma_smem<AK, BK>();
  const dim3 grid((o.N + kTN - 1) / kTN, (o.M + kTM - 1) / kTM, splits);
  gemm_mma_kernel<AK, BK><<<grid, kMmaThreads, smem, s>>>(o, e, ws);
  return reduce<bf16>(o, e, ws, splits, s);
}

cudaError_t launch_bf16(const Operands& o, const Epilogue& e, float* ws,
                        int splits, cudaStream_t s) {
  if (o.sak == 1)
    return o.sbk == 1 ? launch_mma<true, true>(o, e, ws, splits, s)
                      : launch_mma<true, false>(o, e, ws, splits, s);
  return o.sbk == 1 ? launch_mma<false, true>(o, e, ws, splits, s)
                    : launch_mma<false, false>(o, e, ws, splits, s);
}

// 16-byte rows: the base 16-byte aligned, the non-unit stride a multiple
// of 8 elements
bool rows_aligned(const void* p, long long s0, long long s1) {
  const long long s = s0 == 1 ? s1 : s0;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s % 8 == 0 &&
         (s0 == 1) != (s1 == 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K slices of an (M, N) product over K that fill the card: a product whose
// output tiles (each a block) fill too few of the card's block slots is cut
// into the fewest slices that fill whole waves of slots to 90 % (the best
// fill below that), each slice at least kMinDepth deep (1024 for the f32
// body, whose rule asks for two waves).
int fill_splits(int M, int N, int K, int dtype) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  if (dtype == kF32) {
    const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
    if (tiles >= 2 * sms) return 1;
    return max(1, min((2 * sms + tiles - 1) / tiles, K / 1024));
  }
  const long long tiles =
      static_cast<long long>((M + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  const long long slots = static_cast<long long>(kBlocksPerSm) * sms;
  if (tiles >= slots) return 1;
  const int most = max(1, K / kMinDepth);
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= most && s <= 4 * slots; ++s) {
    const long long blocks = tiles * s;
    const double fill = static_cast<double>(blocks) /
                        (((blocks + slots - 1) / slots) * slots);
    if (fill >= 0.9) return s;
    if (fill > best_fill) best = s, best_fill = fill;
  }
  return best;
}

// K slices of an (M, N) product over K: the one place they are chosen.
// fill_splits', and in bf16 at least enough that no slice is deeper than
// max_depth (0: no bound). The tensor cores' float accumulation drifts
// further from an IEEE float sum the deeper a slice runs (about 6x
// torch.matmul's float32 error at K = 2048, 2x at 1024, PERF.md), and the
// slices are added in float: a caller whose float output decides a branch,
// a ReLU's kink, bounds the depth.
int choose_splits(int M, int N, int K, int dtype, int max_depth) {
  const int s = fill_splits(M, N, K, dtype);
  if (dtype != kBF16 || max_depth < 1) return s;
  return max(s, (K + max_depth - 1) / max_depth);
}

}  // namespace
}  // namespace idvs

// The K slices idvs_gemm takes for an (M, N) product over K in `dtype`,
// no slice deeper than max_depth in bf16 (0: no bound): the wrapper sizes
// the workspace from it.
extern "C" int idvs_gemm_splits(int M, int N, int K, int dtype,
                                int max_depth) {
  if (M < 1 || N < 1 || K < 1) return 1;
  return idvs::choose_splits(M, N, K, dtype, max_depth);
}

// dst (n,) bf16 = cast(act(src)) elementwise, src (n,) bf16 or float
// (src_f32); act 0 (the cast alone), 1 GELU, 2 ReLU, 3 x*sigmoid(1.702x).
// The prologue pass of a bf16 product's A (idvs_gemm takes bf16 A as it
// is); src and dst 16-byte aligned.
extern "C" int idvs_gemm_act_cast(const void* src, void* dst, long long n,
                                  int act, int src_f32, void* stream) {
  using namespace idvs;
  if (n < 1 || act < 0 || act > 3 || !aligned16(src) || !aligned16(dst))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + 7) / 8;
  const int blocks =
      static_cast<int>(std::min<long long>((chunks + 255) / 256, 132 * 16));
  bf16* d = static_cast<bf16*>(dst);
  if (src_f32)
    act_cast_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(src), d, n, act);
  else
    act_cast_kernel<bf16><<<blocks, 256, 0, s>>>(
        static_cast<const bf16*>(src), d, n, act);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = epi(pro(A) @ B) with A(m, k) = A[m*sam + k*sak] and
// B(k, n) = B[k*sbk + n*sbn], both in the compute dtype (A in float when
// a_f32); one of sam/sak is 1 and one of sbk/sbn is 1. pro_act: 0 none,
// 1 GELU, 2 ReLU, 3 x*sigmoid(1.702x) (applied to A then cast). bias:
// compute-dtype (N,) row or null; add: float (M, N) addend or null; gate:
// (M, N), compute dtype or float (gate_f32), whose act'(gate_act)
// multiplies the sum, or null. out_f32: store float, else the compute
// dtype. splits > 1 needs ws of splits * M * N floats. float32 runs the
// FMA body (with the prologue); bf16 the tensor-core body, which takes A
// and B in bf16 with no prologue (idvs_gemm_act_cast runs it first) and
// with every row 16-byte aligned (base aligned, the non-unit stride a
// multiple of 8).
extern "C" int idvs_gemm(const void* A, const void* B, void* out,
                         const void* add, const void* gate, const void* bias,
                         void* ws, int M, int N, int K, long long sam,
                         long long sak, long long sbk, long long sbn,
                         int splits, int pro_act, int gate_act, int out_f32,
                         int a_f32, int gate_f32, int dtype, void* stream) {
  using namespace idvs;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (splits > 1 && !ws) ||
      (sam != 1 && sak != 1) || (sbk != 1 && sbn != 1) || pro_act < 0 ||
      pro_act > 3 || gate_act < 1 || gate_act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{A, B, sam, sak, sbk, sbn, M, N, K, pro_act, a_f32};
  // whole 8-element pieces of every (M, N) operand's rows
  const int vec = N % 8 == 0 && aligned16(out) && aligned16(add) &&
                  aligned16(gate) && aligned16(bias) && aligned16(ws);
  const Epilogue e{out,  out_f32,  static_cast<const float*>(add),
                   gate, gate_act, gate_f32,
                   bias, vec};
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_f32(o, e, w, splits, s));
  if (dtype == kBF16) {
    if (pro_act != kNone || a_f32 || !rows_aligned(A, sam, sak) ||
        !rows_aligned(B, sbk, sbn))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bf16(o, e, w, splits, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

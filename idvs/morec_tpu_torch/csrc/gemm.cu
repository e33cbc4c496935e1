// The matrix products of every backward in the port, of the post-LN
// tails' forward where a block cannot hold a row (C = 2048) or the dtype is
// float32 (ops/cuda/mlp.py proj_resln_products, mlp_resln_products) and of
// the window attention's output projection, as one tiled kernel with float
// accumulation and the epilogues those products need.
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
// A is cast to the compute dtype, and the forward's float h of the C = 2048
// tail takes act on load too); epi() adds a bias row, a float addend
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
// float32 (the same kernel, gemm_mma_kernel<float>): plain TF32 keeps 10
// mantissa bits, too few for the float32 parity the port holds, and the
// float FMA units (67 TFLOP/s) held the old register-tiled SGEMM to 20
// TFLOP/s on SASRec's products at D = 2048 (PERF.md). So the products run
// on the tensor cores as 3xTF32 (mma.sync m16n8k8 tf32, 495 TFLOP/s, 165
// for three products): each operand value is split into big =
// tf32_rna(a) and small = tf32_rna(a - big), and small.big + big.small +
// big.big is accumulated in float, the small terms first, about float32's
// accuracy (the dropped small.small is 2^-22 of the product). The tensor
// cores' accumulation is no IEEE float sum (it drops the bits of each
// addend below the running sum's; over K = 8192 that left 1.3e-5 of the
// largest output against the plain version, above the 1e-5 its tests
// allow), so each 16-deep stage's products go into zeroed sums that are
// then added to the running sums by float adds, as float32 FMAs would:
// at K = 2048 the mean error against the float64 sum is a quarter of
// torch.matmul float32's (PERF.md). One block an SM (blocks_per_sm).
// Operands
// are copied as they are, floats, by the same cp.async ring (a stage 16
// floats deep, the same bytes as bf16's 32), and split in registers as
// each warp loads its fragments: B's once for the warp's four n8 tiles,
// A's one m16 tile at a time, after act() where A takes its prologue (the
// float C = 2048 tail's second product, cast(act(h)) w2, takes it here).
// Every operand row starts 16-byte aligned, as in bf16. The split over K
// is chosen as in bf16, max_depth included.
#include <algorithm>
#include <type_traits>

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
  int pro_act;        // Act applied to a float A in the body (3xTF32)
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

// ---- the tensor-core body: bf16, and float32 as 3xTF32 --------------------

constexpr int kTM = 128, kTN = 128, kStages = 4;
constexpr int kMmaThreads = 256, kWarpsN = 4;   // 2 x 4 warps
constexpr int kWM = 64, kWN = 32;               // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;    // its m16 and n8 tiles
// blocks an SM: two in bf16 (128 registers a thread); one in float32,
// whose 3xTF32 body holds the running sums, a stage's sums and the split
// fragments in up to 223 registers (at two blocks an SM it spilled 100 to
// 130 bytes and ran at 22-30 TFLOP/s against 37-41 without, PERF.md)
template <typename E>
constexpr int blocks_per_sm() {
  return std::is_same_v<E, bf16> ? 2 : 1;
}
// the float tile the epilogue reads back, [kTM][kLdC]: 16 threads a row,
// 8 columns each
constexpr int kLdC = kTN + 8;
constexpr int kRowThreads = kTN / 8, kRowsAPass = kMmaThreads / kRowThreads;
// Each block slice of K is at least this deep (8 K steps), and a
// product is split over K only while its tiles fill few block slots.
constexpr int kMinDepth = 256;

// One operand's tile of a stage in shared memory, elements E (bf16, or
// float in the 3xTF32 body): [rows][kTK] when k is its contiguous
// dimension in device memory (KMaj), else [kTK][rows]. A stage is 64
// bytes of k deep (32 bf16 or 16 floats); a [rows][k] row is padded by 16
// bytes and a [k][rows] row by 8 elements, so that each warp's fragment
// reads (ldmatrix, or 4-byte loads of a [k][rows] float tile) touch every
// bank once.
template <typename E, bool KMaj, int Rows>
struct Smem {
  static constexpr int kVec = 16 / sizeof(E);   // elements of a 16-byte chunk
  static constexpr int kTK = 64 / sizeof(E);
  static constexpr int kLd = KMaj ? kTK + kVec : Rows + 8;
  static constexpr int kSize = KMaj ? Rows * kLd : kTK * kLd;   // elements
  // 16-byte chunks a thread copies of a stage
  static constexpr int kChunks = Rows * kTK / kVec / kMmaThreads;
  static_assert(kChunks * kMmaThreads * kVec == Rows * kTK, "whole chunks");

  // (row, k) within the tile of chunk c's first element
  __device__ static void chunk(int c, int& r, int& k) {
    if (KMaj) {
      r = c / (kTK / kVec);
      k = c % (kTK / kVec) * kVec;
    } else {
      k = c / (Rows / kVec);
      r = c % (Rows / kVec) * kVec;
    }
  }
  __device__ static int offset(int r, int k) {
    return KMaj ? r * kLd + k : k * kLd + r;
  }
};

// shared memory of a block: the stages' ring, which the epilogue's float
// tile reuses (the same bytes for both element types)
template <typename E, bool AK, bool BK>
constexpr size_t mma_smem() {
  return std::max(kStages *
                      (Smem<E, AK, kTM>::kSize + Smem<E, BK, kTN>::kSize) *
                      sizeof(E),
                  sizeof(float) * kTM * kLdC);
}

// cp.async of one operand's stage: its 16-byte chunks a thread (every row
// starts 16-byte aligned, idvs_gemm refuses others), the elements past
// `rows` x k_end zero-filled (and not read).
template <typename E, bool KMaj, int Rows>
__device__ __forceinline__ void copy_stage(E* dst, const E* base,
                                           long long sr, long long sk,
                                           int r0, int k0, int rows,
                                           int k_end) {
  using S = Smem<E, KMaj, Rows>;
#pragma unroll
  for (int i = 0; i < S::kChunks; ++i) {
    int r, k;
    S::chunk(threadIdx.x + i * kMmaThreads, r, k);
    r += r0, k += k0;
    // the chunk runs along k (KMaj) or along r
    int n = KMaj ? (r < rows ? k_end - k : 0) : (k < k_end ? rows - r : 0);
    n = max(0, min(S::kVec, n));
    const E* src = n > 0 ? base + r * sr + k * sk : base;
    cp_async16_zfill(dst + S::offset(r - r0, k - k0), src,
                     static_cast<int>(sizeof(E)) * n);
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

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// 8 neighbouring sums at (m, n..n+7) through the epilogue to the output,
// T the compute dtype: 16- and 32-byte loads and stores where e.vec says
// every (M, N) operand and N allow them and the 8 columns lie inside N,
// else element by element
template <typename T>
__device__ __forceinline__ void store_row8(const Epilogue& e, int M, int N,
                                           int m, int n, float (&v)[8]) {
  if (!(e.vec && n + 8 <= N)) {
#pragma unroll
    for (int c = 0; c < 8; ++c) store_out<T>(e, M, N, m, n + c, v[c]);
    return;
  }
  const size_t i = static_cast<size_t>(m) * N + n;
  float f[8];
  if (e.bias != nullptr) {
    load8(static_cast<const T*>(e.bias) + n, f);
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
      load8(static_cast<const T*>(e.gate) + i, f);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] *= dact(f[c], e.gate_act);
  }
  if (e.out_f32)
    store8(static_cast<float*>(e.out) + i, v);
  else
    store8(static_cast<T*>(e.out) + i, v);
}

// Lane l's ldmatrix column offset, in elements E, for an A fragment from an
// [m][k] tile and for B from an [n][k] tile (mma.cuh's a_col and bn_col,
// which count bf16): 16 bytes is 8 bf16 or 4 floats
template <typename E>
__device__ __forceinline__ int a_col_of(int l) {
  return (l >> 4) * (16 / static_cast<int>(sizeof(E)));
}
template <typename E>
__device__ __forceinline__ int bn_col_of(int l) {
  return ((l >> 3) & 1) * (16 / static_cast<int>(sizeof(E)));
}

// One 16-deep slice of a bf16 stage: the warp's fragments (A for its kMT
// m16 tiles, B for its kNT n8 tiles), then its kMT x kNT products
template <bool AK, bool BK>
__device__ __forceinline__ void bf16_step(const bf16* as, const bf16* bs,
                                          int kk, int wm, int wn, int lane,
                                          float (&acc)[kMT][kNT][4]) {
  using SA = Smem<bf16, AK, kTM>;
  using SB = Smem<bf16, BK, kTN>;
  uint32_t a[kMT][4], b[kNT][2];
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
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
}

// One 8-deep slice of a float stage as 3xTF32: every operand value split
// into big + small tf32 terms (mma.cuh split_tf32), and each product
// accumulated as small.big + big.small + big.big, the small terms first
// (small.small, 2^-22 of the product, is dropped), into `acc`, the stage's
// sums (the kernel adds them to its running sums in float). B's
// fragments are split
// once for the warp's kNT n8 tiles; A's one m16 tile at a time, after
// act() when A takes its prologue (on the float, before the split), so
// that few registers hold fragments beside the 64 accumulators. [rows][k]
// tiles load by ldmatrix (a float is two b16 halves), [k][rows] tiles by
// 4-byte loads, which the padding keeps free of bank conflicts.
template <bool AK, bool BK>
__device__ __forceinline__ void tf32_step(const float* as, const float* bs,
                                          int kk, int wm, int wn, int lane,
                                          int pro_act,
                                          float (&acc)[kMT][kNT][4]) {
  using SA = Smem<float, AK, kTM>;
  using SB = Smem<float, BK, kTN>;
  const int g = lane >> 2, q = lane & 3;
  uint32_t bb[kNT][2], bsm[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; j += 2) {
    const int n = wn * kWN + j * 8;
    uint32_t r[4];
    if constexpr (BK) {
      ldsm_x4(r, smem_u32(bs + (n + bn_row(lane)) * SB::kLd + kk +
                          bn_col_of<float>(lane)));
    } else {
      const float* p = bs + (kk + q) * SB::kLd + n + g;
      r[0] = __float_as_uint(p[0]);
      r[1] = __float_as_uint(p[4 * SB::kLd]);
      r[2] = __float_as_uint(p[8]);
      r[3] = __float_as_uint(p[4 * SB::kLd + 8]);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h)
      split_tf32(__uint_as_float(r[h]), bb[j + h / 2][h & 1],
                 bsm[j + h / 2][h & 1]);
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int m = wm * kWM + i * 16;
    uint32_t r[4];
    if constexpr (AK) {
      ldsm_x4(r, smem_u32(as + (m + a_row(lane)) * SA::kLd + kk +
                          a_col_of<float>(lane)));
    } else {
      const float* p = as + (kk + q) * SA::kLd + m + g;
      r[0] = __float_as_uint(p[0]);
      r[1] = __float_as_uint(p[8]);
      r[2] = __float_as_uint(p[4 * SA::kLd]);
      r[3] = __float_as_uint(p[4 * SA::kLd + 8]);
    }
    uint32_t ab[4], asm_[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float v = __uint_as_float(r[h]);
      if (pro_act != kNone) v = act(v, pro_act);
      split_tf32(v, ab[h], asm_[h]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], asm_, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ab, bsm[j][0], bsm[j][1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], ab, bb[j][0], bb[j][1]);
  }
}

// grid (N tiles, M tiles, splits). With one split the epilogue runs here;
// otherwise slice z writes its raw float tile to ws[z] (M x N), which
// splitk_reduce_kernel adds in order. E: the operands' elements, bf16 (A
// and B in bf16; a prologue of A ran before, in act_cast_kernel) or float
// (3xTF32; A's prologue runs here). AK: A is k-contiguous (sak == 1), else
// m-contiguous; BK: B is k-contiguous (sbk == 1), else n-contiguous.
template <typename E, bool AK, bool BK>
__global__ void __launch_bounds__(kMmaThreads, blocks_per_sm<E>())
    gemm_mma_kernel(Operands o, Epilogue e, float* __restrict__ ws) {
  using SA = Smem<E, AK, kTM>;
  using SB = Smem<E, BK, kTN>;
  constexpr int kTK = SA::kTK;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  E* As = reinterpret_cast<E*>(gemm_smem);
  E* Bs = As + kStages * SA::kSize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int per = (o.K + gridDim.z - 1) / gridDim.z;
  const int k_chunk = (per + kTK - 1) / kTK * kTK;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(o.K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kTK - 1) / kTK : 0;
  const E* A = static_cast<const E*>(o.A);
  const E* B = static_cast<const E*>(o.B);

  // stage t's copies into slot t % kStages
  auto issue = [&](int t) {
    const int k0 = k_begin + t * kTK, s = t % kStages;
    copy_stage<E, AK, kTM>(As + s * SA::kSize, A, o.sam, o.sak, m0, k0, o.M,
                           k_end);
    copy_stage<E, BK, kTN>(Bs + s * SB::kSize, B, o.sbn, o.sbk, n0, k0, o.N,
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
    const E* as = As + (t % kStages) * SA::kSize;
    const E* bs = Bs + (t % kStages) * SB::kSize;
    if constexpr (std::is_same_v<E, bf16>) {
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16)
        bf16_step<AK, BK>(as, bs, kk, wm, wn, lane, acc);
    } else {
      // the stage's products into zeroed sums, then added to the running
      // sums by float adds (round to nearest): the tensor cores' own
      // accumulation drops the bits of each addend below the running
      // sum's, which over thousands of steps drifts past float32's
      // rounding
      float d[kMT][kNT][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 8)
        tf32_step<AK, BK>(as, bs, kk, wm, wn, lane, o.pro_act, d);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[i][j][h] += d[i][j][h];
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
      store_row8<E>(e, o.M, o.N, m, n, v);
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

// Opts the layout's kernel into its shared memory with the largest
// carveout, once.
template <typename E, bool AK, bool BK>
cudaError_t prepare_mma() {
  static const cudaError_t err = [] {
    auto kernel = gemm_mma_kernel<E, AK, BK>;
    cudaError_t e = allow_smem(kernel, mma_smem<E, AK, BK>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename E, bool AK, bool BK>
cudaError_t launch_mma(const Operands& o, const Epilogue& e, float* ws,
                       int splits, cudaStream_t s) {
  const cudaError_t opt = prepare_mma<E, AK, BK>();
  if (opt != cudaSuccess) return opt;
  constexpr size_t smem = mma_smem<E, AK, BK>();
  const dim3 grid((o.N + kTN - 1) / kTN, (o.M + kTM - 1) / kTM, splits);
  gemm_mma_kernel<E, AK, BK><<<grid, kMmaThreads, smem, s>>>(o, e, ws);
  return reduce<E>(o, e, ws, splits, s);
}

// the layout's instantiation of the body for elements E
template <typename E>
cudaError_t launch(const Operands& o, const Epilogue& e, float* ws,
                   int splits, cudaStream_t s) {
  if (o.sak == 1)
    return o.sbk == 1 ? launch_mma<E, true, true>(o, e, ws, splits, s)
                      : launch_mma<E, true, false>(o, e, ws, splits, s);
  return o.sbk == 1 ? launch_mma<E, false, true>(o, e, ws, splits, s)
                    : launch_mma<E, false, false>(o, e, ws, splits, s);
}

// 16-byte rows: the base 16-byte aligned, the non-unit stride a multiple
// of the elements in 16 bytes (8 bf16 or 4 floats)
bool rows_aligned(const void* p, long long s0, long long s1, int elem) {
  const long long s = s0 == 1 ? s1 : s0;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s % (16 / elem) == 0 &&
         (s0 == 1) != (s1 == 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K slices of an (M, N) product over K that fill the card: a product whose
// output tiles (each a block) fill too few of the card's block slots is cut
// into the fewest slices that fill whole waves of slots to 90 % (the best
// fill below that), each slice at least kMinDepth deep. Both bodies share
// the tile; the slots are blocks_per_sm of the dtype's body an SM. The
// float32 body, at one block an SM, also cuts a product of one to four
// waves whose last wave runs part full (SASRec's h = x w1 at M = 640: 320
// tiles on 132 SMs fill three waves to 81 %, two slices five to 97 %).
int fill_splits(int M, int N, int K, int dtype) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long tiles =
      static_cast<long long>((M + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  const long long slots =
      static_cast<long long>(dtype == kF32 ? blocks_per_sm<float>()
                                           : blocks_per_sm<bf16>()) *
      sms;
  if (tiles >= slots && (dtype != kF32 || tiles >= 4 * slots)) return 1;
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
// fill_splits', and at least enough that no slice is deeper than max_depth
// (0: no bound). The bf16 body's float accumulation on the tensor cores
// drifts further from an IEEE float sum the deeper a slice runs (about 6x
// torch.matmul's float32 error at K = 2048, 2x at 1024, PERF.md), and the
// slices are added in float: a caller whose float output decides a branch,
// a ReLU's kink, bounds the depth. The float32 body adds each step in
// float already; it honours the bound alike.
int choose_splits(int M, int N, int K, int dtype, int max_depth) {
  const int s = fill_splits(M, N, K, dtype);
  if (max_depth < 1) return s;
  return max(s, (K + max_depth - 1) / max_depth);
}

}  // namespace
}  // namespace idvs

// The K slices idvs_gemm takes for an (M, N) product over K in `dtype`, no
// slice deeper than max_depth (0: no bound): the wrapper sizes the
// workspace from it.
extern "C" int idvs_gemm_splits(int M, int N, int K, int dtype,
                                int max_depth) {
  if (M < 1 || N < 1 || K < 1 || (dtype != idvs::kF32 &&
                                  dtype != idvs::kBF16))
    return 1;
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
// B(k, n) = B[k*sbk + n*sbn], both in the compute dtype; one of sam/sak is
// 1 and one of sbk/sbn is 1. pro_act: 0 none, 1 GELU, 2 ReLU, 3
// x*sigmoid(1.702x) (applied to A then cast). bias: compute-dtype (N,) row
// or null; add: float (M, N) addend or null; gate: (M, N), compute dtype
// or float (gate_f32), whose act'(gate_act) multiplies the sum, or null.
// out_f32: store float, else the compute dtype. splits > 1 needs ws of
// splits * M * N floats. Both dtypes run the tensor-core body and take A
// and B with every row 16-byte aligned (base aligned, the non-unit stride
// a multiple of 8 bf16 or 4 floats). bf16 takes A and B in bf16 with no
// prologue (idvs_gemm_act_cast runs it first; a_f32 must be 0); float32
// (3xTF32) takes them in float, with the prologue.
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
  const int elem = dtype == kF32 ? 4 : 2;
  if (!rows_aligned(A, sam, sak, elem) || !rows_aligned(B, sbk, sbn, elem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{A, B, sam, sak, sbk, sbn, M, N, K, pro_act};
  // whole 8-element pieces of every (M, N) operand's rows
  const int vec = N % 8 == 0 && aligned16(out) && aligned16(add) &&
                  aligned16(gate) && aligned16(bias) && aligned16(ws);
  const Epilogue e{out,  out_f32,  static_cast<const float*>(add),
                   gate, gate_act, gate_f32,
                   bias, vec};
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float>(o, e, w, splits, s));
  if (dtype == kBF16) {
    if (pro_act != kNone || a_f32)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<bf16>(o, e, w, splits, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

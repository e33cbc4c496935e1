// The matrix products of the post-LN tails' backward, as one tiled kernel
// with float accumulation and the epilogues those products need.
//
// Replaces the products inside idvs/morec_tpu/ops/pallas/mlp.py
// _bwd_proj_kernel (:759-762: dW = xᵀ dz, dx = dz Wᵀ) and _bwd_post_kernel
// (:486-494: dW2 = cast(act(h))ᵀ dz, dg = dz W2ᵀ, dh = cast(dg * act'(h)),
// dW1 = xᵀ dh, dx = dh W1ᵀ + dyp). On the TPU the weight gradients sum over
// every row of M into a resident buffer across a sequential grid; the
// H100's blocks run in parallel and in no order, so a product whose
// reduction runs over M (K here) is split into `splits` slices of K, each
// block writes its float partial tile, and a second pass adds the slices
// in a fixed order (deterministic, no atomics).
//
//   out[m][n] = epi( sum_k pro(A(m, k)) * B(k, n) )
//   A(m, k) = A[m * sam + k * sak],  B(k, n) = B[k * sbk + n * sbn]
// so a transposed operand is only a pair of strides. pro() is the identity
// or cast(act(.)) (the recomputed activation of the FFN's saved h, which is
// in the compute dtype or, where the backward recomputed it, float);
// epi() adds a bias row, a float addend and/or multiplies by act'(gate),
// then casts to the compute dtype or stores float. The same kernel carries
// the products of the Swin kernels' backward (premlp_bwd.cu,
// win_attn_bwd.cu): the recomputed qkv and h (bias epilogue), dctx, and the
// weight and input gradients.
//
// Bound on the H100: at the train shapes (M = titles x 30 rows, C = 512,
// F = 2048) every product is 2-60 GFLOP, compute-bound on the float FMA
// units (f32 parity rules out TF32; the bf16 edition runs the same float
// FMAs, tensor cores are later work). Design: the classic 128 x 128 x 8
// register-tiled SGEMM: 256 threads, each owning an 8 x 8 tile in two 4-row
// and two 4-column groups 64 apart (conflict-free float4 reads of both
// shared tiles), the next K slice loaded into registers during the FMAs
// and double-buffered through shared memory.
#include "common.cuh"

namespace idvs {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;

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
};

template <typename T>
__device__ __forceinline__ void store_out(const Epilogue& e, int M, int N,
                                          int m, int n, float v) {
  if (m >= M || n >= N) return;
  const size_t i = static_cast<size_t>(m) * N + n;
  if (e.bias != nullptr) v += to_f32(static_cast<const T*>(e.bias)[n]);
  if (e.add != nullptr) v += e.add[i];
  if (e.gate != nullptr)
    v *= dact(e.gate_f32 ? static_cast<const float*>(e.gate)[i]
                         : to_f32(static_cast<const T*>(e.gate)[i]),
              e.gate_act);
  if (e.out_f32)
    static_cast<float*>(e.out)[i] = v;
  else
    static_cast<T*>(e.out)[i] = from_f32<T>(v);
}

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
cudaError_t launch(const Operands& o, const Epilogue& e, float* ws,
                   int splits, cudaStream_t s) {
  const dim3 grid((o.N + kBN - 1) / kBN, (o.M + kBM - 1) / kBM, splits);
  gemm_kernel<T><<<grid, kThreads, 0, s>>>(o, e, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  splitk_reduce_kernel<T><<<132 * 8, 256, 0, s>>>(ws, splits, o.M, o.N, e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace idvs

// out (M, N) = epi(pro(A) @ B) with A(m, k) = A[m*sam + k*sak] and
// B(k, n) = B[k*sbk + n*sbn], both in the compute dtype (A in float when
// a_f32); one of sam/sak is 1 and one of sbk/sbn is 1. pro_act: 0 none,
// 1 GELU, 2 ReLU, 3 x*sigmoid(1.702x) (applied to A then cast). bias:
// compute-dtype (N,) row or null; add: float (M, N) addend or null; gate:
// (M, N), compute dtype or float (gate_f32), whose act'(gate_act)
// multiplies the sum, or null. out_f32: store float, else the compute
// dtype. splits > 1 needs ws of splits * M * N floats.
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
  const Epilogue e{out, out_f32, static_cast<const float*>(add), gate,
                   gate_act, gate_f32, bias};
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float>(o, e, w, splits, s));
  if (dtype == kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(o, e, w, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

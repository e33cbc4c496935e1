// Row-tile building blocks of the float32 FFN tail (mlp_resln.cu's
// mlp_resln_kernel), and the 4-element loads and stores other kernels
// share (load4, store4).
//
// A block of kThreads = 256 threads (8 warps) owns BM = 32 rows and ALL C
// output columns, so the LayerNorm over a row runs in the epilogue with no
// second pass. The warps form a WR x WC grid (Grid<C>): warp (wr, wc) owns
// rows wr*TR .. wr*TR+TR-1 and the column span wc*128*NG .. +128*NG, in
// which lane l owns the 4-column groups 4l + 128j (j < NG). A thread
// therefore holds a TR x 4NG register tile (8 x 8 at C = 512);
// neighbouring lanes read neighbouring 16-byte words of the B tile, and
// the A values are broadcast.
//
// Operand A sits in shared memory transposed, At[k][row] with a row stride
// of LDA = BM + 4 floats (padding against bank conflicts on the transposing
// store); operand B sits row-major, Bs[k][col]. Both hold floats. K is
// walked in BK = 16 deep slices, double-buffered: the next slice is loaded
// into registers while the current one is multiplied, so one barrier per
// slice suffices.
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace idvs {
namespace rowtile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Warp grid for C output columns: WC column warps, NG 4-column groups per
// lane (C = WC * 128 * NG), BM rows a block, BK the depth of a K slice.
template <int C>
struct Grid;
template <>
struct Grid<128> { static constexpr int WC = 1, NG = 1, BM = 32, BK = 16; };
template <>
struct Grid<256> { static constexpr int WC = 1, NG = 2, BM = 32, BK = 16; };
template <>
struct Grid<512> { static constexpr int WC = 2, NG = 2, BM = 32, BK = 16; };

template <int C>
struct Layout {
  static constexpr int WC = Grid<C>::WC;
  static constexpr int NG = Grid<C>::NG;
  static constexpr int BM = Grid<C>::BM;
  static constexpr int BK = Grid<C>::BK;
  static constexpr int LDA = BM + 4;    // row stride of a transposed A tile
  static constexpr int WR = kWarps / WC;
  static constexpr int TR = BM / WR;    // rows per thread
  // shared-memory floats ln_epilogue needs for its cross-warp sums
  static constexpr int kRedFloats = 2 * WC * BM;
  static_assert(WC * 128 * NG == C, "grid must cover C");
  static_assert(TR % 4 == 0, "rows per thread come in float4s");
  __device__ static int wr() { return (threadIdx.x >> 5) % WR; }
  __device__ static int wc() { return (threadIdx.x >> 5) / WR; }
};

// 4 consecutive elements (16-byte aligned floats, 8-byte aligned bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// A slice [BK][NC] of a row-major (K, ldb) matrix from column c0, staged
// in registers: kPer float4s per thread.
template <typename T, int NC, int BK>
struct BSlice {
  static constexpr int kQuads = NC / 4;
  static constexpr int kPer = BK * kQuads / kThreads;
  static_assert(kPer * kThreads == BK * kQuads, "slice must split evenly");
  float4 v[kPer];
  __device__ void load(const T* __restrict__ B, int ldb, int k0, int c0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      v[u] = load4(B + static_cast<size_t>(k0 + i / kQuads) * ldb + c0 +
                   4 * (i % kQuads));
    }
  }
  __device__ void store(float* Bs) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      *reinterpret_cast<float4*>(Bs + (i / kQuads) * NC + 4 * (i % kQuads)) =
          v[u];
    }
  }
};

// acc[r][4j + c] += sum_{k < BK} At[k][row_off + r] *
//                                Bs[k][col_off + 4l + 128j + c]
// with At rows LDA floats apart and Bs rows LDB floats apart.
template <int TR, int NG, int LDB, int BK, int LDA>
__device__ __forceinline__ void fma_slice(float (&acc)[TR][4 * NG],
                                          const float* At, const float* Bs,
                                          int row_off, int col_off) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TR];
#pragma unroll
    for (int q = 0; q < TR / 4; ++q) {
      const float4 t =
          *reinterpret_cast<const float4*>(At + k * LDA + row_off + 4 * q);
      a[4 * q + 0] = t.x;
      a[4 * q + 1] = t.y;
      a[4 * q + 2] = t.z;
      a[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + k * LDB + col_off + 4 * l + 128 * j);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        acc[r][4 * j + 0] = fmaf(a[r], b.x, acc[r][4 * j + 0]);
        acc[r][4 * j + 1] = fmaf(a[r], b.y, acc[r][4 * j + 1]);
        acc[r][4 * j + 2] = fmaf(a[r], b.z, acc[r][4 * j + 2]);
        acc[r][4 * j + 3] = fmaf(a[r], b.w, acc[r][4 * j + 3]);
      }
    }
  }
}

// out = LN(cast(dropout(acc + bias) + resid)) over each row of C columns:
// the pre-LN sum is rounded to the compute dtype BEFORE the float stats
// (mlp.py _fwd_post_body / _fwd_proj_body), the variance is the fast
// E[x^2] - E[x]^2 clamped at 0 (flax nn.LayerNorm), gamma/beta are float.
// The dropout index of element (row, col) is row * C + col. The cast pre-LN
// sum is also stored to ypre when it is given (the training edition's
// residual). A row's sums come from its WC warps through `red`
// (Layout<C>::kRedFloats floats).
template <typename T, int C>
__device__ __forceinline__ void ln_epilogue(
    float (&acc)[Layout<C>::TR][4 * Layout<C>::NG], const T* __restrict__ bias,
    const T* __restrict__ resid, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int row0, int M,
    float eps, float* red, Drop drop, T* __restrict__ ypre) {
  using Lay = Layout<C>;
  constexpr int TR = Lay::TR, NG = Lay::NG, WC = Lay::WC, kBM = Lay::BM;
  const int l = threadIdx.x & 31, wr = Lay::wr(), wc = Lay::wc();
  const int col0 = wc * 128 * NG + 4 * l;
  float sum[TR], sq[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = row0 + wr * TR + r;
    const bool live = row < M;   // warp-uniform: all lanes share the row
    sum[r] = sq[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = col0 + 128 * j;
      const float4 b = load4(bias + col);
      const float4 x = live ? load4(resid + static_cast<size_t>(row) * C +
                                    col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float bb[4] = {b.x, b.y, b.z, b.w}, xx[4] = {x.x, x.y, x.z, x.w};
      const uint32_t index = static_cast<uint32_t>(row) * C + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float y = drop.apply(acc[r][4 * j + c] + bb[c], index + c);
        y = round_to<T>(y + xx[c]);
        acc[r][4 * j + c] = y;
        sum[r] += y;
        sq[r] += y * y;
      }
      if (ypre != nullptr && live)
        store4(ypre + static_cast<size_t>(row) * C + col,
               make_float4(acc[r][4 * j + 0], acc[r][4 * j + 1],
                           acc[r][4 * j + 2], acc[r][4 * j + 3]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum[r] += __shfl_xor_sync(~0u, sum[r], o);
      sq[r] += __shfl_xor_sync(~0u, sq[r], o);
    }
  }
  if (WC > 1) {
    if (l == 0) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        red[(0 * WC + wc) * kBM + wr * TR + r] = sum[r];
        red[(1 * WC + wc) * kBM + wr * TR + r] = sq[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      sum[r] = sq[r] = 0.f;
      for (int c = 0; c < WC; ++c) {
        sum[r] += red[(0 * WC + c) * kBM + wr * TR + r];
        sq[r] += red[(1 * WC + c) * kBM + wr * TR + r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = row0 + wr * TR + r;
    if (row >= M) continue;
    const float mu = sum[r] / C;
    const float var = fmaxf(sq[r] / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = col0 + 128 * j;
      const float4 g = load4(gamma + col), b = load4(beta + col);
      const float4 y = make_float4(
          (acc[r][4 * j + 0] - mu) * rstd * g.x + b.x,
          (acc[r][4 * j + 1] - mu) * rstd * g.y + b.y,
          (acc[r][4 * j + 2] - mu) * rstd * g.z + b.z,
          (acc[r][4 * j + 3] - mu) * rstd * g.w + b.w);
      store4(out + static_cast<size_t>(row) * C + col, y);
    }
  }
}

}  // namespace rowtile
}  // namespace idvs

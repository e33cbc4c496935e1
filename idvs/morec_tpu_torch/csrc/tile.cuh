// Register-tile building blocks of the pre-LN kernels (win_attn.cu,
// premlp.cu), for widths that are multiples of 32 but not of 128 (Swin's
// 96, 192, 384, 768).
//
// The threads of a block form a TY x TX grid (thread t: tx = t % TX,
// ty = t / TX). Thread (ty, tx) owns rows 4*ty .. 4*ty+3 of the block's row
// tile and the 4-column groups 4*tx + 4*TX*j (j < NG): a 4 x 4NG register
// tile, so a tile of N = 4*TX*NG columns needs no power of two. Threads of a
// warp that share ty read neighbouring 16-byte words of the B tile, and the
// A values are broadcast.
//
// Operand A sits in shared memory transposed, At[k][row] (row stride lda, a
// multiple of 4); operand B sits row-major, Bs[k][col]. Both hold floats
// widened from the compute dtype, the products accumulate in float. K is
// walked in KB deep slices, double-buffered: the next slice is loaded into
// registers (ASlice, WSlice) while the current one is multiplied, so one
// barrier per slice suffices. A slice's rows and columns may be gathered:
// the window kernels read a window's tokens from the feature map and one
// head group's q, k and v columns of the packed QKV weight.
#pragma once

#include "rowtile.cuh"

namespace idvs {
namespace tile {

using rowtile::load4;
using rowtile::store4;

// acc[r][4j + c] += sum_{k < KB} At[k*lda + row_off + r] *
//                                Bs[k*ldb + col_off + col_step*j + c]
template <int NG, int KB>
__device__ __forceinline__ void fma_tile(float (&acc)[4][4 * NG],
                                         const float* At, int lda,
                                         const float* Bs, int ldb,
                                         int row_off, int col_off,
                                         int col_step) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float4 a4 =
        *reinterpret_cast<const float4*>(At + k * lda + row_off);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + k * ldb + col_off + col_step * j);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][4 * j + 0] = fmaf(a[r], b.x, acc[r][4 * j + 0]);
        acc[r][4 * j + 1] = fmaf(a[r], b.y, acc[r][4 * j + 1]);
        acc[r][4 * j + 2] = fmaf(a[r], b.z, acc[r][4 * j + 2]);
        acc[r][4 * j + 3] = fmaf(a[r], b.w, acc[r][4 * j + 3]);
      }
    }
  }
}

// A slice [KB][NC] of a row-major weight (rows ldw apart), staged in
// registers, at most MAXQ float4s a thread. Slice column c is the weight's
// column (c / part_w) * part_stride + col_base + c % part_w: part_w = NC
// reads NC consecutive columns from col_base; a smaller part_w gathers
// equally wide column ranges part_stride apart (q, k and v of a head group).
template <typename T, int KB, int MAXQ>
struct WSlice {
  float4 v[MAXQ];
  int goff[MAXQ];   // k * ldw + column in the weight; -1 = no element
  int soff[MAXQ];   // k * NC + c in the shared slice

  __device__ void init(int ldw, int NC, int part_w, int part_stride,
                       int col_base) {
    const int quads = NC / 4;
#pragma unroll
    for (int u = 0; u < MAXQ; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < KB * quads) {
        const int k = i / quads, c = 4 * (i % quads);
        goff[u] = k * ldw + (c / part_w) * part_stride + col_base +
                  c % part_w;
        soff[u] = k * NC + c;
      } else {
        goff[u] = -1;
        soff[u] = 0;
      }
    }
  }
  __device__ void load(const T* __restrict__ W, int ldw, int k0) {
#pragma unroll
    for (int u = 0; u < MAXQ; ++u)
      if (goff[u] >= 0)
        v[u] = load4(W + static_cast<size_t>(k0) * ldw + goff[u]);
  }
  __device__ void store(float* Bs) const {
#pragma unroll
    for (int u = 0; u < MAXQ; ++u)
      if (goff[u] >= 0) *reinterpret_cast<float4*>(Bs + soff[u]) = v[u];
  }
};

// A slice [rows][KB] of a row-major activation (C wide), staged in registers
// and stored transposed, at most MAXQ float4s a thread. Row r of the tile is
// the activation's row row_of[r] (an array in shared memory; -1 = a row
// beyond the data, read as zeros).
template <typename T, int KB, int MAXQ>
struct ASlice {
  float4 v[MAXQ];
  long long goff[MAXQ];   // row_of[r] * C + 4 * quad; -1 = zeros; -2 = none
  int soff[MAXQ];         // 4 * quad * lda + r in the transposed slice

  __device__ void init(const int* row_of, int rows, int C, int lda) {
    constexpr int kQuads = KB / 4;
#pragma unroll
    for (int u = 0; u < MAXQ; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < rows * kQuads) {
        const int r = i / kQuads, q = i % kQuads;
        goff[u] = row_of[r] < 0
                      ? -1
                      : static_cast<long long>(row_of[r]) * C + 4 * q;
        soff[u] = 4 * q * lda + r;
      } else {
        goff[u] = -2;
        soff[u] = 0;
      }
    }
  }
  __device__ void load(const T* __restrict__ A, int k0) {
#pragma unroll
    for (int u = 0; u < MAXQ; ++u) {
      if (goff[u] >= 0)
        v[u] = load4(A + goff[u] + k0);
      else
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ void store(float* At, int lda) const {
#pragma unroll
    for (int u = 0; u < MAXQ; ++u) {
      if (goff[u] == -2) continue;
      float* p = At + soff[u];
      p[0] = v[u].x;
      p[lda] = v[u].y;
      p[2 * lda] = v[u].z;
      p[3 * lda] = v[u].w;
    }
  }
};

}  // namespace tile
}  // namespace idvs

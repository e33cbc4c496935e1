// Tile helpers shared by the attention kernels that hold one head's q, k, v
// and (T, T) scores in shared memory (fused_mha.cu, win_attn_bwd.cu).
#pragma once

#include "common.cuh"

namespace idvs {

// row-wise f32 softmax in place, one warp per query row
__device__ __forceinline__ void softmax_rows(float* ss, int T_) {
  const int lds = T_ + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < T_; i += blockDim.x >> 5) {
    float* si = ss + i * lds;
    float m = -INFINITY;
    for (int j = lane; j < T_; j += 32) m = fmaxf(m, si[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    float sum = 0.f;
    for (int j = lane; j < T_; j += 32) {
      const float e = expf(si[j] - m);
      si[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    for (int j = lane; j < T_; j += 32) si[j] = si[j] / sum;
  }
}

// widens one head's (T, dh) tile, rows row_stride elements apart, into a
// padded [T][dh + 1] float tile
template <typename T>
__device__ __forceinline__ void load_head(const T* __restrict__ src,
                                          size_t row_stride, int T_, int dh,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < T_ * dh; idx += blockDim.x) {
    const int t = idx / dh, d = idx % dh;
    dst[t * (dh + 1) + d] = to_f32(src[t * row_stride + d]);
  }
}

}  // namespace idvs

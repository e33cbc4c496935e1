// The dropout mask shared by every kernel of the port and by its plain
// PyTorch twin (idvs/morec_tpu_torch/ops/dropout.py), bit for bit.
//
// The TPU kernels draw block-shaped random bits from seed + program_id and
// regenerate them in backward, which ties the forward and backward grids
// together (ops/pallas/attention.py:419-427, mlp.py:498-507). Here the bits
// of an element are a pure function of (call key, element index), so any
// kernel can find the mask of any element, whatever its grid:
//
//   key  = mix32(seed)                       (host side, once per call)
//   bits = mix32(index ^ key)                (index: the element's flat
//                                             row-major index, < 2^32)
//   keep = bits >= thresh,  thresh = min(floor(p * 2^32), 2^32 - 1)
//
// as the Pallas _dropout_keep compares its bits. Kept elements are scaled by
// `scale` = float32(1 / (1 - p)). mix32 is the "lowbias32" integer hash.
#pragma once

#include <cstdint>

namespace idvs {

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// One dropout call: off when thresh == 0 (p == 0).
struct Drop {
  uint32_t key;
  uint32_t thresh;
  float scale;
  __device__ __forceinline__ bool on() const { return thresh != 0u; }
  __device__ __forceinline__ bool keep(uint32_t index) const {
    return mix32(index ^ key) >= thresh;
  }
  // x scaled if kept, 0 if dropped (x itself when off)
  __device__ __forceinline__ float apply(float x, uint32_t index) const {
    if (!on()) return x;
    return keep(index) ? x * scale : 0.f;
  }
};

}  // namespace idvs

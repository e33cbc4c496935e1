// The 4-element loads and stores the row kernels share (load4, store4):
// resln_bwd.cu, inbatch_ce.cu, tile.cuh and mlp_resln.cu's row pass.
#pragma once

#include "common.cuh"

namespace idvs {
namespace rowtile {

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

}  // namespace rowtile
}  // namespace idvs

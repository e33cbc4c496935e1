// Deterministic second pass of the reductions that run over rows: every
// block of a first pass writes one partial vector, and this pass adds the
// partials in a fixed order (no atomics, so two runs give the same bits).
#pragma once

#include "common.cuh"

namespace idvs {

// out[e] = sum over b < nb, in order, of part[b * E + e]
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int nb,
                                           int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[static_cast<size_t>(b) * E + e];
  out[e] = s;
}

inline cudaError_t sum_partials(const float* part, float* out, int nb, int E,
                                cudaStream_t s) {
  sum_partials_kernel<<<(E + 255) / 256, 256, 0, s>>>(part, out, nb, E);
  return cudaGetLastError();
}

}  // namespace idvs

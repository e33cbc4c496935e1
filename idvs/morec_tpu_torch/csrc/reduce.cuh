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

// part2[y][e] = the sum, in order, of part[b][e] over the rows b in
// [y per, min(nb, y per + per)): the first of the two fixed-order passes
// over the blocks' partial rows (the second is sum_partials)
static __global__ void group_sums_kernel(const float* __restrict__ part,
                                         float* __restrict__ part2, int nb,
                                         int E, int per) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int b0 = blockIdx.y * per, b1 = min(nb, b0 + per);
  float s = 0.f;
  for (int b = b0; b < b1; ++b) s += part[static_cast<size_t>(b) * E + e];
  part2[static_cast<size_t>(blockIdx.y) * E + e] = s;
}

inline cudaError_t sum_partials(const float* part, float* out, int nb, int E,
                                cudaStream_t s) {
  sum_partials_kernel<<<(E + 255) / 256, 256, 0, s>>>(part, out, nb, E);
  return cudaGetLastError();
}

// sums (E,) = the nb partial rows of part added in groups of `per` in
// order, then the groups in order (part2: ceil(nb / per) * E floats)
inline cudaError_t group_sums(const float* part, float* part2, float* sums,
                              int nb, int E, int per, cudaStream_t s) {
  const int groups = (nb + per - 1) / per;
  group_sums_kernel<<<dim3((E + 255) / 256, groups), 256, 0, s>>>(
      part, part2, nb, E, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part2, sums, groups, E, s);
}

}  // namespace idvs

// fused_mha's float32 backward, both editions, and its dbias edition's
// chunks: fused_mha.cu's entry points call these for the float32 compute
// dtype. They live in a file of their own so that nvcc compiles the
// float32 backward's kernels (mha_mma.cuh mha_bwd_tf32_kernel, 3xTF32 on
// mma.sync m16n8k8) in parallel with fused_mha.cu's. The design is in
// fused_mha.cu's header.
#include "mha_mma.cuh"

// The arguments of idvs_fused_mha_bwd (chunks = 0) or of
// idvs_fused_mha_bwd_dbias (chunks > 0, mode 1), which checks them first.
extern "C" int idvs_fused_mha_bwd_f32(const void* qkv, const void* bias,
                                      const void* dout, void* dqkv,
                                      void* part, int B, int T_, int nh,
                                      int dh, int mode, int P, int chunks,
                                      long long bias_sp, long long bias_sh,
                                      float scale, unsigned drop_key,
                                      unsigned drop_thresh, float drop_scale,
                                      void* stream) {
  using namespace idvs;
  const Geometry g{T_, nh, dh, mode, P, bias_sp, bias_sh, scale};
  return fused_mha_backward<float>(
      qkv, static_cast<const float*>(bias), dout, dqkv,
      static_cast<float*>(part), B, chunks, g,
      choose_f32(T_, dh, chunks > 0 ? kBwdDbias : kBwd),
      Drop{drop_key, drop_thresh, drop_scale},
      static_cast<cudaStream_t>(stream));
}

// idvs_fused_mha_dbias_chunks for float32, its arguments checked
extern "C" int idvs_fused_mha_dbias_chunks_f32(int B, int T_, int nh, int dh,
                                               int P) {
  using namespace idvs;
  return fused_mha_dbias_chunks(B, P, nh, choose_f32(T_, dh, kBwdDbias));
}

// fused_mha's float32 backward, both editions, and its dbias edition's
// chunks: fused_mha.cu's entry points call these for the float32 compute
// dtype. They live in a file of their own so that nvcc compiles the
// float32 backward's kernels (mha_mma.cuh mha_bwd_tf32_kernel, 3xTF32 on
// mma.sync m16n8k8) in parallel with fused_mha.cu's; the unswizzled
// layouts' kernels (mha_mma.cuh kBwdLayouts) are in
// fused_mha_f32_packed.cu, compiled in parallel too. The design is in
// fused_mha.cu's header.
#include "mha_mma.cuh"

// fused_mha_f32_packed.cu: the same two entries for the unswizzled layouts
extern "C" int idvs_fused_mha_bwd_f32_packed(
    const void* qkv, const void* bias, const void* dout, void* dqkv,
    void* part, int B, int T_, int nh, int dh, int mode, int P, int chunks,
    long long bias_sp, long long bias_sh, float scale, unsigned drop_key,
    unsigned drop_thresh, float drop_scale, void* stream);
extern "C" int idvs_fused_mha_dbias_chunks_f32_packed(int B, int T_, int nh,
                                                      int dh, int P);

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
  if (choose_f32(T_, dh, chunks > 0 ? kBwdDbias : kBwd).sw != kSwizzle)
    return idvs_fused_mha_bwd_f32_packed(
        qkv, bias, dout, dqkv, part, B, T_, nh, dh, mode, P, chunks, bias_sp,
        bias_sh, scale, drop_key, drop_thresh, drop_scale, stream);
  return fused_mha_backward_f32<kSwizzle>(
      qkv, bias, dout, dqkv, part, B, T_, nh, dh, mode, P, chunks, bias_sp,
      bias_sh, scale, drop_key, drop_thresh, drop_scale, stream);
}

// idvs_fused_mha_dbias_chunks for float32, its arguments checked
extern "C" int idvs_fused_mha_dbias_chunks_f32(int B, int T_, int nh, int dh,
                                               int P) {
  using namespace idvs;
  const F32Blocking k = choose_f32(T_, dh, kBwdDbias);
  if (k.sw != kSwizzle)
    return idvs_fused_mha_dbias_chunks_f32_packed(B, T_, nh, dh, P);
  return fused_mha_dbias_chunks(B, P, nh, k);
}

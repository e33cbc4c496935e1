// fused_mha's float32 backward in the unswizzled layouts that
// mha_mma.cuh kBwdLayouts falls back to (heads of 417+ columns at T
// 16-33, which the swizzled planes do not fit): fused_mha_f32.cu's entries
// call these where the plan takes such a layout. A file of its own so
// that nvcc compiles these kernels in parallel with the others.
#include "mha_mma.cuh"

extern "C" int idvs_fused_mha_bwd_f32_packed(
    const void* qkv, const void* bias, const void* dout, void* dqkv,
    void* part, int B, int T_, int nh, int dh, int mode, int P, int chunks,
    long long bias_sp, long long bias_sh, float scale, unsigned drop_key,
    unsigned drop_thresh, float drop_scale, void* stream) {
  return idvs::fused_mha_backward_f32<0>(
      qkv, bias, dout, dqkv, part, B, T_, nh, dh, mode, P, chunks, bias_sp,
      bias_sh, scale, drop_key, drop_thresh, drop_scale, stream);
}

extern "C" int idvs_fused_mha_dbias_chunks_f32_packed(int B, int T_, int nh,
                                                      int dh, int P) {
  using namespace idvs;
  return fused_mha_dbias_chunks<0>(B, P, nh, choose_f32(T_, dh, kBwdDbias));
}

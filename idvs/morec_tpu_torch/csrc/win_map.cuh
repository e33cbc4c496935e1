// Where a window's tokens sit in device memory: the row index map of the
// Swin kernels (win_attn.cu, win_attn_bwd.cu, and fused_mha.cu's attention
// tiles, which read a tile of T consecutive rows).
//
// The window layout (band = 0) holds window b's token t at row b * T + t of
// a (windows, T, C) tensor. The band layout (band = 1) reads the windows
// straight from an (N, Hp, Wp, C) feature map: images of nwr x nwc windows
// of w x w tokens, windows in raster order within an image, tokens in
// raster order within a window, so that window_partition and its reverse
// never exist in device memory. A shifted block's map is rolled by the
// caller first. A row is the base row of the window plus an offset that
// depends on the token alone, so a kernel divides by the runtime widths
// once a window (base) and once a block (offset, into a table).
#pragma once

namespace idvs {

struct TokenMap {
  int band;            // 1: (N, Hp, Wp, C) map; 0: (windows, T, C)
  int w, nwc, nwr;     // window side, windows per row and per column

  // the row of token 0 of window b
  __host__ __device__ long long base(int b, int T) const {
    if (!band) return static_cast<long long>(b) * T;
    const int nW = nwc * nwr, img = b / nW, wi = b % nW;
    return (static_cast<long long>(img) * nwr * w + (wi / nwc) * w) *
               (nwc * w) +
           (wi % nwc) * w;
  }
  // how many rows past its window's token 0 token t sits
  __host__ __device__ int offset(int t) const {
    return band ? (t / w) * (nwc * w) + t % w : t;
  }
  __host__ __device__ long long row(int b, int t, int T) const {
    return base(b, T) + offset(t);
  }
};

}  // namespace idvs

// Windowed multi-head self-attention with its projections (Swin), forward:
//   qkv = cast(x @ Wqkv + bqkv)                 per window of T = w*w tokens
//   s   = f32(q . k) * dh^-1/2 + bias[window % P, head]
//   p   = cast(softmax_f32(s))
//   ctx = cast(f32(p . v))
//   out = cast(ctx @ Wo + bo)
// One device body, two index maps: the window layout reads window r from a
// (B, T, C) tensor; the band layout reads a window's tokens from the
// (N, Hp, Wp, C) feature map and writes them back there, so the window
// partition and its reverse never exist in device memory.
//
// Replaces idvs/morec_tpu/ops/pallas/attention.py _pfwd_kernel (reached
// through fused_mha_proj) and _bfwd_kernel (fused_mha_proj_band), bodies
// _p_proj and _p_attention. The TPU wrapper's 7 -> 8 window padding is a
// Mosaic constraint and is not carried over: its padded keys get -1e9 and
// its padded queries are sliced off, which equals the 49-token math done
// here. The bias arrives already cast to the compute dtype (and widened to
// float), as the TPU wrapper casts it.
//
// Bound on the H100: per window 8*T*C*C flops of projections against
// 4*T*T*C of attention, so at Swin's widths the projections are 95 % or
// more of the work; in float32 (no TF32, for parity) and, for now, in bf16
// too (widened to float) it is bound by the float FMA rate. Design: two
// launches. The first gives a block G windows (one at T = 49) and HG heads
// (3 or 4): it streams the windows' rows of x and the head group's q, k, v
// columns of Wqkv through shared memory in 16-deep slices into a 4 x 12
// register tile per thread (tile.cuh), parks the cast q, k, v of its heads
// in shared memory (a window's qkv for ALL heads is 451 KB at C = 768, above
// the 227 KB a block has; a head group's is 80 KB), runs the (T, T) scores,
// the float softmax and p . v there (4 x 4 register tiles: at C = 96 the
// attention is a fifth of the operations, and one output a thread cost
// 3 ms more of the kernel's 8 ms there: bf16, 256 images, one H100 at
// 700 W), and writes its heads' context into a scratch in x's layout. Splitting heads over blocks keeps 132 SMs busy at
// the last stage (one window per image) with no product computed twice;
// only x is read nh/HG times, from L2. The output projection sums over all
// heads, so a second launch (linear_kernel, a row tile owning all C
// columns) projects the scratch: it costs one round trip of (rows, C).
#include "tile.cuh"

namespace idvs {
namespace {

constexpr int kKB = 16;            // depth of a K slice in win_attn_kernel
constexpr int kMaxThreads = 512;   // of a win_attn_kernel block

struct WinGeom {
  int windows, T, C, nh, dh;
  int G, HG;                       // windows and heads per block
  int P;                           // bias period: window r takes bias[r % P]
  long long bias_sp, bias_sh;      // bias strides of the period and the head
  int band;                        // 1: (N, Hp, Wp, C) map; 0: (B, T, C)
  int w, nwc, nwr;                 // window side, windows per row and column
  float scale;
};

// the row (in units of C elements) of token t of window widx; -1 beyond
__device__ __forceinline__ int token_row(const WinGeom& g, int widx, int t) {
  if (widx >= g.windows) return -1;
  if (!g.band) return widx * g.T + t;
  const int nW = g.nwc * g.nwr;
  const int img = widx / nW, wi = widx % nW;
  const int y = (wi / g.nwc) * g.w + t / g.w;
  const int x = (wi % g.nwc) * g.w + t % g.w;
  return (img * g.nwr * g.w + y) * (g.nwc * g.w) + x;
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// shared-memory bytes of a win_attn_kernel block
inline size_t win_smem(const WinGeom& g) {
  const int R4 = round4(g.G * g.T), NC = 3 * g.HG * g.dh;
  return sizeof(float) * (static_cast<size_t>(R4) + 2 * kKB * (R4 + 4) +
                          2 * kKB * NC + static_cast<size_t>(R4) * (NC + 1) +
                          static_cast<size_t>(g.G) * g.HG * g.T * (g.T + 1));
}

// The one place that chooses a block's share: G windows for a row tile of
// at least 45 tokens (TY = ceil(G * T / 4) >= 12), and the largest group of
// at most 4 heads that divides nh, is at least 32 columns wide (TX >= 8) and
// fits the block's threads and shared memory. False: no such blocking.
inline bool choose_blocking(WinGeom& g) {
  g.G = (45 + g.T - 1) / g.T;
  const int TY = round4(g.G * g.T) / 4;
  for (g.HG = 4; g.HG >= 1; --g.HG) {
    const int TX = g.HG * g.dh / 4;
    if (g.nh % g.HG == 0 && TX >= 8 && TX * TY <= kMaxThreads &&
        win_smem(g) <= kMaxSmem)
      return true;
  }
  return false;
}

// grid (window groups, head groups); block TX * TY threads with
// TX = HG * dh / 4 and TY = ceil(G * T / 4)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    win_attn_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                    T* __restrict__ ctx, WinGeom g) {
  extern __shared__ float4 smem4[];
  const int R = g.G * g.T, R4 = round4(R), lda = R4 + 4;
  const int HD = g.HG * g.dh, NC = 3 * HD, ldq = NC + 1, lds = g.T + 1;
  int* row_of = reinterpret_cast<int*>(smem4);          // [R4]
  float* At = reinterpret_cast<float*>(smem4) + R4;     // 2 x [kKB][lda]
  float* Bs = At + 2 * kKB * lda;                       // 2 x [kKB][NC]
  float* Q = Bs + 2 * kKB * NC;                         // [R4][ldq] q|k|v
  float* S = Q + R4 * ldq;                              // [G*HG*T][lds]
  const int TX = HD / 4;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int win0 = blockIdx.x * g.G, h0 = blockIdx.y * g.HG;

  for (int r = threadIdx.x; r < R4; r += blockDim.x)
    row_of[r] = r < R ? token_row(g, win0 + r / g.T, r % g.T) : -1;
  __syncthreads();

  // q, k, v of the block's heads: (R4, C) x (C, NC), columns gathered from
  // the three ranges of Wqkv
  float acc[4][12] = {};
  tile::ASlice<T, kKB, 2> a;
  tile::WSlice<T, kKB, 4> b;
  a.init(row_of, R4, g.C, lda);
  b.init(3 * g.C, NC, HD, g.C, h0 * g.dh);
  const int slices = g.C / kKB;
  a.load(x, 0);
  b.load(wqkv, 3 * g.C, 0);
  for (int s = 0; s < slices; ++s) {
    float* at = At + (s & 1) * kKB * lda;
    float* bs = Bs + (s & 1) * kKB * NC;
    a.store(at, lda);
    b.store(bs);
    __syncthreads();
    if (s + 1 < slices) {      // next slice in flight during the FMAs
      a.load(x, (s + 1) * kKB);
      b.load(wqkv, 3 * g.C, (s + 1) * kKB);
    }
    tile::fma_tile<3, kKB>(acc, at, lda, bs, NC, 4 * ty, 4 * tx, 4 * TX);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + 4 * TX * j + c;
      const float bv =
          to_f32(bqkv[(col / HD) * g.C + h0 * g.dh + col % HD]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        Q[(4 * ty + r) * ldq + col] = round_to<T>(acc[r][4 * j + c] + bv);
    }
  }
  __syncthreads();

  // scores of every (window, head) of the block, a 4 x 4 tile of (query,
  // key) pairs a thread: 8 shared-memory loads feed 16 FMAs. The rows of a
  // ragged edge tile (T = 49 is no multiple of 4) are clamped for the loads
  // and left out of the stores
  const int planes = g.G * g.HG, nt = (g.T + 3) / 4;
  for (int tile = threadIdx.x; tile < planes * nt * nt; tile += blockDim.x) {
    const int gh = tile / (nt * nt), rem = tile % (nt * nt);
    const int i0 = 4 * (rem / nt), j0 = 4 * (rem % nt);
    const int gw = gh / g.HG, hl = gh % g.HG, widx = win0 + gw;
    const float *q[4], *k[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      q[r] = Q + (gw * g.T + min(i0 + r, g.T - 1)) * ldq + hl * g.dh;
      k[r] = Q + (gw * g.T + min(j0 + r, g.T - 1)) * ldq + HD + hl * g.dh;
    }
    float s[4][4] = {};
    for (int d = 0; d < g.dh; ++d) {
      const float qv[4] = {q[0][d], q[1][d], q[2][d], q[3][d]};
      const float kv[4] = {k[0][d], k[1][d], k[2][d], k[3][d]};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
    const bool live = widx < g.windows;
    const float* brow =
        bias + (live ? (widx % g.P) * g.bias_sp + (h0 + hl) * g.bias_sh : 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i0 + r >= g.T) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + c >= g.T) continue;
        S[(gh * g.T + i0 + r) * lds + j0 + c] =
            live ? s[r][c] * g.scale + brow[(i0 + r) * g.T + j0 + c] : 0.f;
      }
    }
  }
  __syncthreads();

  // float softmax over each row, one warp a row; the probabilities are
  // cast. A block need not be whole warps (TX * TY threads): the last,
  // partial warp sits out, the shuffles need all 32 lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int row = warp < warps ? warp : planes * g.T; row < planes * g.T;
       row += warps) {
    float* si = S + row * lds;
    float m = -INFINITY;
    for (int j = lane; j < g.T; j += 32) m = fmaxf(m, si[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    float sum = 0.f;
    for (int j = lane; j < g.T; j += 32) {
      const float e = expf(si[j] - m);
      si[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    for (int j = lane; j < g.T; j += 32) si[j] = round_to<T>(si[j] / sum);
  }
  __syncthreads();

  // ctx = p . v into the scratch, at the tokens' own rows: a 4 x 4 tile
  // of (query, feature) pairs a thread
  const int nd = g.dh / 4;
  for (int tile = threadIdx.x; tile < planes * nt * nd; tile += blockDim.x) {
    const int gh = tile / (nt * nd), rem = tile % (nt * nd);
    const int i0 = 4 * (rem / nd), d0 = 4 * (rem % nd);
    const int gw = gh / g.HG, hl = gh % g.HG;
    const float* p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[r] = S + (gh * g.T + min(i0 + r, g.T - 1)) * lds;
    const float* v = Q + gw * g.T * ldq + 2 * HD + hl * g.dh + d0;
    float o[4][4] = {};
    for (int j = 0; j < g.T; ++j) {
      const float pv[4] = {p[0][j], p[1][j], p[2][j], p[3][j]};
      const float* vj = v + j * ldq;
      const float vv[4] = {vj[0], vj[1], vj[2], vj[3]};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = fmaf(pv[r], vv[c], o[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + r < g.T ? row_of[gw * g.T + i0 + r] : -1;
      if (row < 0) continue;
      tile::store4(ctx + static_cast<size_t>(row) * g.C + (h0 + hl) * g.dh +
                       d0,
                   make_float4(o[r][0], o[r][1], o[r][2], o[r][3]));
    }
  }
}

// out = cast(A @ W + b): A (M, C), W (C, C) in (in, out) layout, a block of
// 256 threads owning 4 * (256 / TX) rows and all C = 4 * TX * NG columns.
template <typename T, int TX, int NG, int KB>
__global__ void __launch_bounds__(256)
    linear_kernel(const T* __restrict__ A, const T* __restrict__ W,
                  const T* __restrict__ b, T* __restrict__ out, int M) {
  constexpr int C = 4 * TX * NG, TY = 256 / TX, BM = 4 * TY, lda = BM + 4;
  constexpr int kQa = (BM * KB / 4 + 255) / 256;
  constexpr int kQb = (KB * C / 4 + 255) / 256;
  extern __shared__ float4 smem4[];
  int* row_of = reinterpret_cast<int*>(smem4);          // [BM]
  float* At = reinterpret_cast<float*>(smem4) + BM;     // 2 x [KB][lda]
  float* Bs = At + 2 * KB * lda;                        // 2 x [KB][C]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;
  for (int r = threadIdx.x; r < BM; r += 256)
    row_of[r] = row0 + r < M ? row0 + r : -1;
  __syncthreads();

  float acc[4][4 * NG] = {};
  tile::ASlice<T, KB, kQa> a;
  tile::WSlice<T, KB, kQb> w;
  a.init(row_of, BM, C, lda);
  w.init(C, C, C, 0, 0);
  a.load(A, 0);
  w.load(W, C, 0);
  for (int s = 0; s < C / KB; ++s) {
    float* at = At + (s & 1) * KB * lda;
    float* bs = Bs + (s & 1) * KB * C;
    a.store(at, lda);
    w.store(bs);
    __syncthreads();
    if (s + 1 < C / KB) {
      a.load(A, (s + 1) * KB);
      w.load(W, C, (s + 1) * KB);
    }
    tile::fma_tile<NG, KB>(acc, at, lda, bs, C, 4 * ty, 4 * tx, 4 * TX);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * ty + r;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = 4 * tx + 4 * TX * j;
      const float4 bv = tile::load4(b + col);
      tile::store4(out + static_cast<size_t>(row) * C + col,
                   make_float4(acc[r][4 * j + 0] + bv.x,
                               acc[r][4 * j + 1] + bv.y,
                               acc[r][4 * j + 2] + bv.z,
                               acc[r][4 * j + 3] + bv.w));
    }
  }
}

template <typename T, int TX, int NG, int KB>
cudaError_t launch_linear(const void* A, const void* W, const void* b,
                          void* out, int M, cudaStream_t s) {
  constexpr int C = 4 * TX * NG, BM = 4 * (256 / TX);
  const size_t smem =
      sizeof(float) * (BM + 2 * KB * (BM + 4) + 2 * KB * C);
  auto kernel = linear_kernel<T, TX, NG, KB>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + BM - 1) / BM, 256, smem, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(W),
      static_cast<const T*>(b), static_cast<T*>(out), M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t linear(const void* A, const void* W, const void* b, void* out,
                   int M, int C, cudaStream_t s) {
  switch (C) {
    case 32: return launch_linear<T, 8, 1, 16>(A, W, b, out, M, s);
    case 64: return launch_linear<T, 16, 1, 16>(A, W, b, out, M, s);
    case 96: return launch_linear<T, 8, 3, 16>(A, W, b, out, M, s);
    case 128: return launch_linear<T, 32, 1, 16>(A, W, b, out, M, s);
    case 192: return launch_linear<T, 16, 3, 16>(A, W, b, out, M, s);
    case 256: return launch_linear<T, 32, 2, 16>(A, W, b, out, M, s);
    case 384: return launch_linear<T, 32, 3, 16>(A, W, b, out, M, s);
    case 512: return launch_linear<T, 32, 4, 16>(A, W, b, out, M, s);
    case 768: return launch_linear<T, 32, 6, 8>(A, W, b, out, M, s);
    case 1024: return launch_linear<T, 32, 8, 8>(A, W, b, out, M, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* x, const float* bias, const void* wqkv,
                const void* bqkv, const void* wo, const void* bo, void* ctx,
                void* out, const WinGeom& g, cudaStream_t s) {
  const size_t smem = win_smem(g);
  auto kernel = win_attn_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = g.HG * g.dh / 4 * (round4(g.G * g.T) / 4);
  const dim3 grid((g.windows + g.G - 1) / g.G, g.nh / g.HG);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<T*>(ctx), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return linear<T>(ctx, wo, bo, out, g.windows * g.T, g.C, s);
}

}  // namespace
}  // namespace idvs

// x, ctx (scratch), out: windows * T rows of C in the compute dtype, in the
// window layout (band = 0: window r is rows r*T .. r*T+T-1) or the band
// layout (band = 1: images of nwr x nwc windows of w x w tokens, row-major
// maps). wqkv (C, 3C), bqkv (3C,), wo (C, C), bo (C,) in the compute dtype,
// (in, out) layouts. bias: float, element (p, h, i, j) at p*bias_sp +
// h*bias_sh + i*T + j; window r takes p = r % P. dh is a multiple of 4 and
// C a multiple of 16 that linear_kernel is built for. Returns
// cudaErrorInvalidValue for a geometry that choose_blocking cannot place.
extern "C" int idvs_win_attn_fwd(const void* x, const void* bias,
                                 const void* wqkv, const void* bqkv,
                                 const void* wo, const void* bo, void* ctx,
                                 void* out, int windows, int T, int C, int nh,
                                 int P, long long bias_sp, long long bias_sh,
                                 int band, int w, int nwc, int nwr,
                                 float scale, int dtype, void* stream) {
  using namespace idvs;
  if (windows < 1 || T < 1 || nh < 1 || C % nh || C % kKB || P < 1 ||
      (C / nh) % 4 ||
      (band && (w * w != T || nwc < 1 || nwr < 1 ||
                windows % (nwc * nwr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WinGeom g{windows, T, C, nh, C / nh, 0, 0, P, bias_sp, bias_sh,
            band, w, nwc, nwr, scale};
  if (!choose_blocking(g)) return static_cast<int>(cudaErrorInvalidValue);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        run<float>(x, bf, wqkv, bqkv, wo, bo, ctx, out, g, s));
  if (dtype == kBF16)
    return static_cast<int>(
        run<__nv_bfloat16>(x, bf, wqkv, bqkv, wo, bo, ctx, out, g, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// SSIM of two (C, H, W) float32 images with the 11-tap sigma = 1.5 Gaussian
// window, zero-padded SAME at the border, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package (omnigs_tpu/ops/loss.py) runs the
// separable window as two banded matrix products per map (B_v . img . B_h),
// which the TPU's matrix unit does well. On the card those are dense float32
// GEMMs over band matrices that are 99% zeros (~234 GFLOP a 3x900x1920
// training loss, forward and backward). These kernels run the window as the
// stencil it is.
//
// Forward (ssim_fwd_kernel). A block takes a TH x TW tile of one channel:
//   1. stages the tile of x and y with its 5-pixel halo on each side in
//      shared memory (pixels outside the image are 0: the SAME padding);
//   2. horizontal pass: for every staged row and every column of the tile,
//      the 11-tap sums of x, y, x*x, y*y and x*y, in tap order;
//   3. vertical pass over those rows, in tap order, RPT consecutive rows a
//      thread (the 14 rows it needs held in registers), giving mu1, mu2,
//      E[x^2], E[y^2], E[xy] a pixel, and from them the SSIM value S;
//   4. writes S (map mode), and, when the input needs a gradient, the three
//      partials of S: dS/dmu1 (with the -2 mu1 term of sigma1^2 =
//      E[x^2] - mu1^2 and the -mu2 term of sigma12 = E[xy] - mu1 mu2 in
//      place), dS/dsigma1^2 and dS/dsigma12;
//   5. in mean mode, the tile's sum of S into its own slot: each thread sums
//      its RPT rows in order, a warp its 32 lanes in the butterfly's tree
//      (lane i + lane i + half, halves 16..1), then the NTY warp sums left
//      to right. ssim_sum_kernel then adds the slots in a fixed order (a
//      strided sequential sum a thread, the same warp tree, the 32 warp sums
//      left to right) and divides by the pixel count. No float atomics: a
//      replay reproduces bit for bit.
// Backward (ssim_bwd_kernel). The window is symmetric, so the adjoint of the
// zero-padded conv is the same conv. A block stages G * P for the three
// partial maps P (G the upstream gradient of S: a map, or the mean's scalar
// over the pixel count), runs the same two passes over them, and writes
//   dx = conv(G dS/dmu1) + 2 x conv(G dS/dsigma1^2) + y conv(G dS/dsigma12).
//
// Every product and sum is taken in the order of the plain version
// (omnigs_torch/ops/loss.py: _conv_plain, _ssim_terms, _map_sum,
// _slot_sum), and nvcc runs with --fmad=false, so the kernels equal it bit
// for bit. The inputs are read through their strides (a cropped view is not
// copied); the outputs are contiguous.
//
// Row blocks. The forward gives the R map rows from image row row0 on
// (C, R, W), staging the block's halo from the image (rows outside
// [0, H) are 0), so its rows equal the whole map's bit for bit: the sharded
// loss's row block (ssim_rows). Rows past the image come from the zero
// padding. The backward takes that block's partials and gradient and
// writes dx over the image rows the block's window reaches,
// [max(row0 - 5, 0), min(row0 + R + 5, H)). The whole image is row0 = 0,
// R = H.
//
// Bound. Device memory: the forward reads x and y (8 B a pixel) and writes
// three partials (12 B) or the map (4 B); the backward reads x, y and the
// partials (20 B) and writes dx (4 B): ~230 MB for a 3x900x1920 training
// loss, 0.07 ms at 3.35 TB/s. The stencil's ~350 fp32 operations a pixel
// (1.8 GFLOP) keep it near the line between the two bounds; the halo reads
// (42 x 42 staged for a 32 x 32 tile) hit L2.

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int WIN = 11;
constexpr int HALO = WIN / 2;
constexpr int TW = 32;            // tile columns: one warp's lanes
constexpr int NTY = 8;            // warps a block
constexpr int RPT = 4;            // consecutive output rows a thread
constexpr int TH = NTY * RPT;     // tile rows
constexpr int SW = TW + 2 * HALO; // staged columns
constexpr int SH = TH + 2 * HALO; // staged rows
constexpr int THREADS = TW * NTY;
constexpr int SUM_THREADS = 1024;

struct Taps {
  float g[WIN];
};

// a (C, H, W) float32 operand read through its element strides
struct Strided {
  const float* p;
  long long sc, sr, sw;
  __device__ __forceinline__ float at(int c, int r, int q) const {
    return p[c * sc + r * sr + q * sw];
  }
};

// acc = g[0] v[0]; acc = acc + g[k] v[k], k = 1..10
__device__ __forceinline__ float tap_sum(const Taps& t, const float* v) {
  float acc = t.g[0] * v[0];
#pragma unroll
  for (int k = 1; k < WIN; ++k) acc = acc + t.g[k] * v[k];
  return acc;
}

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, half);
  return v;
}

// the vertical pass of one map for this thread's RPT rows: out[i] at
// tile row r0 + i, from staged rows r0 + i .. r0 + i + 10 of column tx
__device__ __forceinline__ void vertical(const Taps& t, const float (*h)[TW], int r0, int tx,
                                         float* out) {
  float v[RPT + 2 * HALO];
#pragma unroll
  for (int k = 0; k < RPT + 2 * HALO; ++k) v[k] = h[r0 + k][tx];
#pragma unroll
  for (int i = 0; i < RPT; ++i) out[i] = tap_sum(t, v + i);
}

__global__ void __launch_bounds__(THREADS) ssim_fwd_kernel(
    Strided x, Strided y, int H, int W, int row0, int R, Taps taps, float c1, float c2,
    float* __restrict__ map, float* __restrict__ dmu, float* __restrict__ dsig,
    float* __restrict__ dcov, float* __restrict__ slots) {
  __shared__ float sx[SH][SW], sy[SH][SW];
  __shared__ float hs[5][SH][TW];
  __shared__ float wsum[NTY];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int c = blockIdx.z, tr0 = blockIdx.y * TH, col0 = blockIdx.x * TW;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int rr = i / SW, cc = i % SW;
    const int r = row0 + tr0 - HALO + rr, q = col0 - HALO + cc;
    const bool in = r >= 0 && r < H && q >= 0 && q < W;
    sx[rr][cc] = in ? x.at(c, r, q) : 0.0f;
    sy[rr][cc] = in ? y.at(c, r, q) : 0.0f;
  }
  __syncthreads();

  for (int rr = ty; rr < SH; rr += NTY) {
    float vx[WIN], vy[WIN], vxx[WIN], vyy[WIN], vxy[WIN];
#pragma unroll
    for (int k = 0; k < WIN; ++k) {
      vx[k] = sx[rr][tx + k];
      vy[k] = sy[rr][tx + k];
      vxx[k] = vx[k] * vx[k];
      vyy[k] = vy[k] * vy[k];
      vxy[k] = vx[k] * vy[k];
    }
    hs[0][rr][tx] = tap_sum(taps, vx);
    hs[1][rr][tx] = tap_sum(taps, vy);
    hs[2][rr][tx] = tap_sum(taps, vxx);
    hs[3][rr][tx] = tap_sum(taps, vyy);
    hs[4][rr][tx] = tap_sum(taps, vxy);
  }
  __syncthreads();

  float m[5][RPT];
#pragma unroll
  for (int j = 0; j < 5; ++j) vertical(taps, hs[j], ty * RPT, tx, m[j]);

  const int q = col0 + tx;
  float tsum = 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr0 + ty * RPT + i;  // the output's row
    const bool in = r < R && q < W;
    const float mu1 = m[0][i], mu2 = m[1][i];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float s1 = m[2][i] - mu1_sq, s2 = m[3][i] - mu2_sq, s12 = m[4][i] - mu1_mu2;
    const float a1 = 2.0f * mu1_mu2 + c1;
    const float a2 = 2.0f * s12 + c2;
    const float b1 = (mu1_sq + mu2_sq) + c1;
    const float b2 = (s1 + s2) + c2;
    const float den = b1 * b2;
    const float s = (a1 * a2) / den;
    const long long o = (static_cast<long long>(c) * R + r) * W + q;
    if (in && map) map[o] = s;
    if (in && dmu) {
      const float d_s = -s / b2;
      const float d_c = (2.0f * a1) / den;
      const float d_m = ((2.0f * mu2) * a2) / den - ((2.0f * mu1) * s) / b1;
      dmu[o] = (d_m - (2.0f * mu1) * d_s) - mu2 * d_c;
      dsig[o] = d_s;
      dcov[o] = d_c;
    }
    const float v = in ? s : 0.0f;
    tsum = i == 0 ? v : tsum + v;
  }
  if (slots == nullptr) return;
  tsum = warp_tree(tsum);
  if (tx == 0) wsum[ty] = tsum;
  __syncthreads();
  if (tid == 0) {
    float b = wsum[0];
#pragma unroll
    for (int w = 1; w < NTY; ++w) b = b + wsum[w];
    slots[(static_cast<long long>(c) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = b;
  }
}

__global__ void __launch_bounds__(SUM_THREADS) ssim_sum_kernel(
    const float* __restrict__ slots, int n, float count, float* __restrict__ out) {
  __shared__ float wsum[SUM_THREADS / 32];
  const int t = threadIdx.x;
  const int padded = (n + SUM_THREADS - 1) / SUM_THREADS * SUM_THREADS;
  float acc = 0.0f;
  for (int j = t; j < padded; j += SUM_THREADS) acc = acc + (j < n ? slots[j] : 0.0f);
  acc = warp_tree(acc);
  if ((t & 31) == 0) wsum[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float s = wsum[0];
    for (int w = 1; w < SUM_THREADS / 32; ++w) s = s + wsum[w];
    out[0] = s / count;
  }
}

__global__ void __launch_bounds__(THREADS) ssim_bwd_kernel(
    Strided x, Strided y, int H, int W, int row0, int R, int d0, int D, Taps taps,
    const float* __restrict__ dmu, const float* __restrict__ dsig,
    const float* __restrict__ dcov, Strided g, float gdiv, float* __restrict__ dx) {
  __shared__ float sp[3][SH][SW];
  __shared__ float hs[3][SH][TW];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int c = blockIdx.z, tr0 = blockIdx.y * TH, col0 = blockIdx.x * TW;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int rr = i / SW, cc = i % SW;
    const int r = d0 + tr0 - HALO + rr, q = col0 - HALO + cc;
    const int pr = r - row0;  // the block's row
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    if (r >= 0 && r < H && pr >= 0 && pr < R && q >= 0 && q < W) {
      const long long o = (static_cast<long long>(c) * R + pr) * W + q;
      const float gv = g.at(c, pr, q) / gdiv;
      p0 = dmu[o] * gv;
      p1 = dsig[o] * gv;
      p2 = dcov[o] * gv;
    }
    sp[0][rr][cc] = p0;
    sp[1][rr][cc] = p1;
    sp[2][rr][cc] = p2;
  }
  __syncthreads();

  for (int rr = ty; rr < SH; rr += NTY) {
#pragma unroll
    for (int j = 0; j < 3; ++j) hs[j][rr][tx] = tap_sum(taps, &sp[j][rr][tx]);
  }
  __syncthreads();

  float v[3][RPT];
#pragma unroll
  for (int j = 0; j < 3; ++j) vertical(taps, hs[j], ty * RPT, tx, v[j]);

  const int q = col0 + tx;
  if (q >= W) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int lr = tr0 + ty * RPT + i;
    if (lr >= D) break;
    const int r = d0 + lr;
    const float xv = x.at(c, r, q), yv = y.at(c, r, q);
    dx[(static_cast<long long>(c) * H + r) * W + q] = (v[0][i] + (2.0f * xv) * v[1][i]) + yv * v[2][i];
  }
}

Strided strided(const void* p, const long long* s) {
  return Strided{static_cast<const float*>(p), s[0], s[1], s[2]};
}

Taps taps_of(const float* g) {
  Taps t;
  for (int k = 0; k < WIN; ++k) t.g[k] = g[k];
  return t;
}

dim3 tiles(int C, int H, int W) { return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, C); }

}  // namespace

// Forward. x, y: (C, H, W) float32 with element strides xs[3], ys[3]; taps:
// 11 host floats; the R map rows from image row row0 on. Writes S to `map`
// if it is not null, the three partials if `dmu` is not null (then dsig,
// dcov too), and, if `slots` is not null, the tiles' sums there (one float
// a tile) and their mean over C * R * W pixels to out[0]. All outputs are
// contiguous (C, R, W) float32.
extern "C" int omnigs_ssim_fwd(const void* x, const long long* xs, const void* y,
                               const long long* ys, int C, int H, int W, int row0, int R,
                               const float* taps, float c1, float c2, void* map, void* dmu,
                               void* dsig, void* dcov, void* slots, void* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tiles(C, R, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssim_fwd_kernel<<<grid, dim3(TW, NTY), 0, s>>>(
      strided(x, xs), strided(y, ys), H, W, row0, R, taps_of(taps), c1, c2,
      static_cast<float*>(map), static_cast<float*>(dmu), static_cast<float*>(dsig),
      static_cast<float*>(dcov), static_cast<float*>(slots));
  err = cudaGetLastError();
  if (err != cudaSuccess || slots == nullptr) return static_cast<int>(err);
  const long long n = static_cast<long long>(grid.x) * grid.y * grid.z;
  ssim_sum_kernel<<<1, SUM_THREADS, 0, s>>>(static_cast<const float*>(slots), static_cast<int>(n),
                                            static_cast<float>(static_cast<long long>(C) * R * W),
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Backward. The partials (C, R, W) as the forward wrote them for the rows
// from row0 on; g: the upstream gradient of S, (C, R, W) read through its
// strides gs[3] (all 0 for the mean's scalar) and divided by gdiv (the pixel
// count for the mean, 1 for a map). Writes the image rows [d0, d0 + D) of
// dx, contiguous (C, H, W): those the block's window reaches.
extern "C" int omnigs_ssim_bwd(const void* x, const long long* xs, const void* y,
                               const long long* ys, int C, int H, int W, int row0, int R,
                               int d0, int D, const float* taps, const void* dmu,
                               const void* dsig, const void* dcov, const void* g,
                               const long long* gs, float gdiv, void* dx, int device,
                               void* stream) {
  if (D <= 0) return 0;  // a block past the image's last row reaches none
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_bwd_kernel<<<tiles(C, D, W), dim3(TW, NTY), 0, static_cast<cudaStream_t>(stream)>>>(
      strided(x, xs), strided(y, ys), H, W, row0, R, d0, D, taps_of(taps),
      static_cast<const float*>(dmu), static_cast<const float*>(dsig),
      static_cast<const float*>(dcov), strided(g, gs), gdiv, static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// The per-tile compositing math of the five compositing kernels for Hopper
// (sm_90a), their constants, and the walk of kernel #5 (the fused
// tile-major backward, composite_tile_bwd.cu, second launcher). Kernels
// #1-#4 run the walk of composite_seg_walk.cuh, with this arithmetic in this
// order; their outputs equal this walk's bit for bit.
//
// Tile t composites the depth-sorted instances of its segment [start,
// start + n) of the (16, rpad) instance slab (rows x, y, A, B, C, opacity,
// r, g, b) over its 256 pixels at integer coordinates (px, py). Per
// pixel-instance pair:
//
//   dx = x - px, dy = y - py
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy
//   G = exp(min(power, 0)), alpha = min(0.99, op G), live iff power <= 0
//       and alpha >= 1/255
//   N_excl = exp(sum of log1p(-alpha) over earlier composited instances)
//   composites iff N_excl (1 - alpha) >= 1e-4; a pixel stops at its first
//   live instance that does not (transmittance only falls from there)
//   color += rgb alpha N_excl, log_T += log1p(-alpha) when compositing
//
// #5's walk: one 256-thread block per tile, one thread per pixel;
// instances are staged in batches through shared memory (row-major slab
// rows, so each staging load is coalesced; threads then read each instance
// as a shared memory broadcast), every warp visits every instance, and the
// block stops reading once every pixel of the tile has stopped
// (__syncthreads_count). Transmittance is carried in the log domain. Built
// with --fmad=false, so every mul/add rounds as the plain PyTorch versions'
// elementwise ops do and the forward and backward walks make the same stop
// decisions.

#pragma once

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace omnigs_composite {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // threads per block, one per pixel
constexpr int NWARP = PX / 32;
constexpr int NSTAGE = 9;  // slab rows read: x y A B C op r g b
constexpr int NGRAD = 9;   // gradient rows: x y A B C op r g b
constexpr int FWD_BATCH = 256;  // instances staged per forward batch
constexpr int BWD_BATCH = 64;   // instances staged per backward batch
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1.0e-4f;
constexpr unsigned FULL = 0xffffffffu;

// The backward walk. For every instance i of the block's segment, given
// color_full (T, 3, 256), the forward color with bg * final_T blended in,
// and dL = dL/dcolor_full (T, 3, 256):
//
//   per pixel, in forward order (alpha and the stop exactly as the forward):
//     w = alpha N_excl, u = dL . rgb
//     dL_dot_B = dL . color_full - sum_{j <= i} w_j u_j
//     dL/dalpha = N_excl u - dL_dot_B / (1 - alpha)  (0 unless composited)
//     V = dL/dalpha * op G   (the 0.99 clamp is ignored, as the reference)
//   per instance, summed over the tile's 256 pixels:
//     dx = -(A sum V dx + B sum V dy), dy = -(C sum V dy + B sum V dx)
//     dA = -1/2 sum V dx^2, dB = -sum V dx dy, dC = -1/2 sum V dy^2
//     dop = sum dL/dalpha G, drgb = sum dL w
//
// The nine rows are added with atomicAdd into row ids[lane] of out (p, 9)
// (kernel #5; kernel #4 writes the same rows at their lanes, through
// composite_seg_walk.cuh's bwd_walk).
//
// Each thread carries its pixel's log-T, the running sum of w u, dL and
// dL . color_full through ONE forward walk (color_full is saved by the
// forward, so there is no reverse pass). Per instance a warp-shuffle
// butterfly sums the nine partials in a fixed order (skipped, with zeros
// written, when __any_sync finds no pixel of the warp composites it), and
// after the batch one thread per instance sums the eight warp partials in
// warp order.
__device__ __forceinline__ void composite_bwd_walk(
    const float* __restrict__ inst, long long rpad, long long start, int n,
    float px, float py, int tile, const float* __restrict__ color_full,
    const float* __restrict__ dcolor, const int* __restrict__ ids,
    long long n_ids, int p, float* __restrict__ out) {
  __shared__ float stage[NSTAGE][BWD_BATCH];
  __shared__ float red[NWARP][NGRAD][BWD_BATCH];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long long pix = static_cast<long long>(tile) * 3 * PX + tid;
  const float dlr = dcolor[pix];
  const float dlg = dcolor[pix + PX];
  const float dlb = dcolor[pix + 2 * PX];
  const float dl_cf = dlr * color_full[pix] + dlg * color_full[pix + PX] +
                      dlb * color_full[pix + 2 * PX];

  float s = 0.f;       // log of the transmittance before the next instance
  float wu_acc = 0.f;  // sum of w u over the composited instances so far
  bool done = false;
  for (int base = 0; base < n; base += BWD_BATCH) {
    const int m = min(BWD_BATCH, n - base);
    for (int k = tid; k < NSTAGE * BWD_BATCH; k += PX) {
      const int row = k / BWD_BATCH;
      const int j = k % BWD_BATCH;
      stage[row][j] = j < m ? inst[row * rpad + start + base + j] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float g[NGRAD];
      bool gated = false;
      if (!done) {
        const float dx = stage[0][j] - px;
        const float dy = stage[1][j] - py;
        const float power =
            -0.5f * (stage[2][j] * dx * dx + stage[4][j] * dy * dy) -
            stage[3][j] * dx * dy;
        const float gauss = expf(fminf(power, 0.f));
        const float op_g = stage[5][j] * gauss;
        const float alpha = fminf(op_g, ALPHA_MAX);
        if (power <= 0.f && alpha >= ALPHA_MIN) {
          const float l = log1pf(-alpha);
          const float n_excl = expf(s);
          const float one_m = 1.f - alpha;
          if (!(n_excl * one_m >= T_STOP)) {
            done = true;
          } else {
            const float w = alpha * n_excl;
            const float u =
                dlr * stage[6][j] + dlg * stage[7][j] + dlb * stage[8][j];
            wu_acc += w * u;
            const float dl_da = n_excl * u - (dl_cf - wu_acc) / one_m;
            const float v = dl_da * op_g;
            const float vdx = v * dx;
            const float vdy = v * dy;
            g[0] = vdx;
            g[1] = vdy;
            g[2] = vdx * dx;
            g[3] = vdx * dy;
            g[4] = vdy * dy;
            g[5] = dl_da * gauss;
            g[6] = dlr * w;
            g[7] = dlg * w;
            g[8] = dlb * w;
            s += l;
            gated = true;
          }
        }
      }
      if (__any_sync(FULL, gated)) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) {
          float v = gated ? g[q] : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v += __shfl_xor_sync(FULL, v, off);
          }
          if (lane == 0) red[warp][q][j] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) red[warp][q][j] = 0.f;
      }
    }
    __syncthreads();
    // one thread per instance of the batch: warp partials in warp order,
    // then the nine rows of the instance
    if (tid < m) {
      float sum[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) {
        float acc = red[0][q][tid];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) acc += red[w][q][tid];
        sum[q] = acc;
      }
      const float A = stage[2][tid];
      const float B = stage[3][tid];
      const float C = stage[4][tid];
      float rows[NGRAD];
      rows[0] = -(A * sum[0] + B * sum[1]);
      rows[1] = -(C * sum[1] + B * sum[0]);
      rows[2] = -0.5f * sum[2];
      rows[3] = -sum[3];
      rows[4] = -0.5f * sum[4];
      rows[5] = sum[5];
      rows[6] = sum[6];
      rows[7] = sum[7];
      rows[8] = sum[8];
      const long long at = start + base + tid;
      const int id = at < n_ids ? ids[at] : -1;
      if (id >= 0 && id < p) {
        float* row = out + static_cast<long long>(id) * NGRAD;
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) atomicAdd(row + q, rows[q]);
      }
    }
    // also the barrier before the next batch overwrites stage and red
    if (__syncthreads_count(!done) == 0) break;
  }
}

}  // namespace omnigs_composite

// The per-tile compositing walks shared by the four compositing kernels for
// Hopper (sm_90a): composite_seg_fwd.cu, composite_seg_bwd.cu (the
// segmented layout) and composite_tile_fwd.cu, composite_tile_bwd.cu (the
// tile-major compact layout). The kernels differ only in where a tile's
// segment starts and how its pixel origin is found; the walk over the
// segment is this file's.
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
// One 256-thread block per tile, one thread per pixel; instances are
// staged in batches through shared memory (row-major slab rows, so each
// staging load is coalesced; threads then read each instance as a shared
// memory broadcast), and the block stops reading once every pixel of the
// tile has stopped (__syncthreads_count). Transmittance is carried in the
// log domain. Built with --fmad=false, so every mul/add rounds as the plain
// PyTorch versions' elementwise ops do and the forward and backward walks
// make the same stop decisions.

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

// What the forward walk leaves in one pixel's thread.
struct FwdPixel {
  float r, g, b;  // sum of rgb alpha N_excl over the composited instances
  float log_t;    // sum of log1p(-alpha) over them
  int nc;         // the last k + 1 at which it composited (WANT_NC only)
};

// The forward walk of the calling thread's pixel over the block's segment.
template <bool WANT_NC>
__device__ __forceinline__ FwdPixel composite_fwd_walk(
    const float* __restrict__ inst, long long rpad, long long start, int n,
    float px, float py) {
  __shared__ float stage[NSTAGE][FWD_BATCH];
  const int tid = threadIdx.x;
  FwdPixel o{0.f, 0.f, 0.f, 0.f, 0};
  bool done = false;
  for (int base = 0; base < n; base += FWD_BATCH) {
    const int m = min(FWD_BATCH, n - base);
    for (int k = tid; k < NSTAGE * FWD_BATCH; k += PX) {
      const int row = k / FWD_BATCH;
      const int j = k % FWD_BATCH;
      stage[row][j] = j < m ? inst[row * rpad + start + base + j] : 0.f;
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < m; ++j) {
        const float dx = stage[0][j] - px;
        const float dy = stage[1][j] - py;
        const float power =
            -0.5f * (stage[2][j] * dx * dx + stage[4][j] * dy * dy) -
            stage[3][j] * dx * dy;
        const float alpha =
            fminf(stage[5][j] * expf(fminf(power, 0.f)), ALPHA_MAX);
        if (!(power <= 0.f && alpha >= ALPHA_MIN)) continue;
        const float l = log1pf(-alpha);
        const float n_excl = expf(o.log_t);
        if (!(n_excl * (1.f - alpha) >= T_STOP)) {
          done = true;
          break;
        }
        const float w = alpha * n_excl;
        o.r += stage[6][j] * w;
        o.g += stage[7][j] * w;
        o.b += stage[8][j] * w;
        o.log_t += l;
        if constexpr (WANT_NC) o.nc = base + j + 1;
      }
    }
    // also the barrier before the next batch overwrites the stage
    if (__syncthreads_count(!done) == 0) break;
  }
  return o;
}

// Writes one pixel's color (T, 3, 256) and final_T = exp(log_T) (T, 256).
__device__ __forceinline__ void store_fwd(const FwdPixel& o, int tile,
                                          float* __restrict__ color,
                                          float* __restrict__ final_t) {
  const int tid = threadIdx.x;
  float* c = color + static_cast<long long>(tile) * 3 * PX + tid;
  c[0] = o.r;
  c[PX] = o.g;
  c[2 * PX] = o.b;
  final_t[static_cast<long long>(tile) * PX + tid] = expf(o.log_t);
}

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
// FUSED = false: the nine rows go to the instance's own lane of out (16,
// rpad); each lane belongs to exactly one tile, so every lane is written by
// one block, without atomics, and the result is deterministic. FUSED =
// true: they are added with atomicAdd into row ids[lane] of out (p, 9).
//
// Each thread carries its pixel's log-T, the running sum of w u, dL and
// dL . color_full through ONE forward walk (color_full is saved by the
// forward, so there is no reverse pass). Per instance a warp-shuffle
// butterfly sums the nine partials in a fixed order (skipped, with zeros
// written, when __any_sync finds no pixel of the warp composites it), and
// after the batch one thread per instance sums the eight warp partials in
// warp order.
template <bool FUSED>
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
      if constexpr (FUSED) {
        const int id = at < n_ids ? ids[at] : -1;
        if (id >= 0 && id < p) {
          float* row = out + static_cast<long long>(id) * NGRAD;
#pragma unroll
          for (int q = 0; q < NGRAD; ++q) atomicAdd(row + q, rows[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) out[q * rpad + at] = rows[q];
      }
    }
    // also the barrier before the next batch overwrites stage and red
    if (__syncthreads_count(!done) == 0) break;
  }
}

}  // namespace omnigs_composite

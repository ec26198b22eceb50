// The per-tile compositing math of the five compositing kernels for Hopper
// (sm_90a) and their constants. No walk lives here: all five kernels run
// composite_seg_walk.cuh (fwd_walk / bwd_walk), with this arithmetic in this
// order, and the plain PyTorch versions repeat it.
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
// The backward, for every instance i of the segment, given color_full (T,
// 3, 256), the forward color with bg * final_T blended in, and dL =
// dL/dcolor_full (T, 3, 256):
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
// Each pixel carries its log-T, the running sum of w u, dL and dL .
// color_full through ONE forward walk (color_full is saved by the forward,
// so there is no reverse pass). Transmittance is carried in the log domain.
// The kernels are built with --fmad=false, so every mul/add rounds as the
// plain PyTorch versions' elementwise ops do and the forward and backward
// walks make the same stop decisions.

#pragma once

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace omnigs_composite {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // backward threads per block, one per pixel
constexpr int NWARP = PX / 32;
constexpr int NSTAGE = 9;  // slab rows read: x y A B C op r g b
constexpr int NGRAD = 9;   // gradient rows: x y A B C op r g b
constexpr int FWD_BATCH = 256;  // instances staged per forward batch
constexpr int BWD_BATCH = 64;   // instances staged per backward batch
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1.0e-4f;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace omnigs_composite

// Segmented front-to-back alpha compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_bwd_seg_kernel
// (launched by composite_seg_bwd). Same function: for every 16x16 tile t and
// every instance i of the tile's segment [starts8[t], starts8[t] + counts[t])
// of the (16, R8) instance slab, given color_full (T, 3, 256), the forward
// color with bg * final_T blended in, and dL = dL/dcolor_full (T, 3, 256),
// write nine gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) at the
// instance's own lane of dinst (16, R8) (the math and the walk in
// composite.cuh, composite_bwd_walk<false>). Every other lane keeps the
// zeros the wrapper allocated.
//
// Design. The TPU kernel walks the slab in 128-lane chunks straddling tiles,
// carries transmittance and the dL.w.u prefix across chunks, broadcasts
// per-tile rows to lanes with one-hot matrix products and forms the pixel
// sums as moments S = Ut V on the MXU; all of that exists because a TPU grid
// runs in order on one core with a matrix unit. Here one 256-thread block
// per tile, one thread per pixel, one forward walk per pixel from the saved
// color_full (no reverse pass), warp-shuffle pixel sums and a fixed-order
// sum over the eight warps. Each slab lane belongs to exactly one tile, so
// the block writes its lanes alone: no atomics, and the result is
// deterministic.
//
// Bound. Per visited pixel-instance pair the forward's ~17 fp32 operations;
// per contributing pair ~31 more (transmittance, dL/dalpha with one
// division, nine partials) and 9 adds of the reduction. Device memory is
// read once (9 floats per instance, 6 per pixel) and written once (9 floats
// per instance, plus the wrapper's zero fill of the output), so the kernel
// is bound by operations, like the forward. This first version spends
// nothing on memory pipelining or on warp-level culling.

#include "composite.cuh"

namespace {

using namespace omnigs_composite;

__global__ void __launch_bounds__(PX) composite_seg_bwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    int gx, int tile_lo, float* __restrict__ dinst) {
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int gid = tile + tile_lo;
  const float px = static_cast<float>((gid % gx) * TILE + p % TILE);
  const float py = static_cast<float>((gid / gx) * TILE + p / TILE);
  composite_bwd_walk<false>(inst, r8, starts8[tile], counts[tile], px, py,
                            tile, color_full, dcolor, nullptr, 0, 0, dinst);
}

}  // namespace

extern "C" int omnigs_composite_seg_bwd(
    const void* inst, long long r8, const void* starts8, const void* counts,
    const void* color_full, const void* dcolor, int num_tiles, int gx,
    int tile_lo, void* dinst, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_seg_bwd_kernel<<<num_tiles, PX, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), r8, static_cast<const int*>(starts8),
      static_cast<const int*>(counts), static_cast<const float*>(color_full),
      static_cast<const float*>(dcolor), gx, tile_lo,
      static_cast<float*>(dinst));
  return static_cast<int>(cudaGetLastError());
}

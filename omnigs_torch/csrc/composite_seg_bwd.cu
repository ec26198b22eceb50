// Segmented front-to-back alpha compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_bwd_seg_kernel
// (launched by composite_seg_bwd). Same function: for every 16x16 tile t and
// every instance i of the tile's segment [starts8[t], starts8[t] + counts[t])
// of the (16, R8) instance slab, given color_full (T, 3, 256), the forward
// color with bg * final_T blended in, and dL = dL/dcolor_full (T, 3, 256),
// write nine gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) at the
// instance's own lane of dinst (16, R8) (the math of composite.cuh). Every
// other lane keeps the zeros the wrapper allocated.
//
// Design. The TPU kernel walks the slab in 128-lane chunks straddling tiles,
// carries transmittance and the dL.w.u prefix across chunks, broadcasts
// per-tile rows to lanes with one-hot matrix products and forms the pixel
// sums as moments S = Ut V on the MXU; all of that exists because a TPU grid
// runs in order on one core with a matrix unit. Here the kernel places its
// tile (origin from its id, segment from starts8) and runs bwd_walk of
// composite_seg_walk.cuh with its lane sink, the walk the tile-major
// backwards (#4, #5) share: one 256-thread block per tile, one thread per
// pixel, one forward walk per pixel from the saved color_full (no reverse
// pass). A warp (two pixel rows) visits
// only the instances whose strip mask has its bit, and sums each visited
// instance's nine partials over its lanes by recursive halving; after each
// batch one thread per instance adds the eight warp sums in warp order (a
// warp that did not visit the instance, or had no composited pixel, adds 0 as
// before). Each slab lane belongs to exactly one tile, so the block writes
// its lanes alone: no atomics, and the result is deterministic.
//
// Bound. Per visited pixel-instance pair the forward's ~17 fp32 operations;
// per contributing pair ~31 more (transmittance, dL/dalpha with one
// division, nine partials) and 9 adds of the reduction. Device memory is
// read once (9 floats per instance, 6 per pixel) and written once (9 floats
// per instance, plus the wrapper's zero fill of the output), so the kernel
// is bound by issue, like the forward. The butterflies it replaced spent 45
// shuffles (one a clock per SM) per warp-instance; the halving spends 12,
// and the strip masks drop the warp-instance pairs no pixel of the warp can
// composite.

#include "composite_seg_walk.cuh"

namespace {

using namespace omnigs_seg;

__global__ void __launch_bounds__(PX) composite_seg_bwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    int gx, int tile_lo, float* __restrict__ dinst) {
  const int tile = blockIdx.x;
  const int gid = tile + tile_lo;
  bwd_walk(inst, r8, starts8[tile], counts[tile], (gid % gx) * TILE,
           (gid / gx) * TILE, tile, color_full, dcolor,
           LaneSink{dinst, r8});
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

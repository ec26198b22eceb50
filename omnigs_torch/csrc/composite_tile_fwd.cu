// Tile-major front-to-back alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_raster.py::_fwd_kernel
// (launched by composite_pallas_fwd). Same function: for every 16x16 tile t,
// composite the instances of its compact-layout segment [starts[t],
// starts[t] + counts[t]), an unaligned range, over its pixels at (x0[t] +
// p % 16, y0[t] + p / 16) and write
//
//   color (T, 3, 256) = sum of rgb alpha N_excl over composited instances
//   final_T (T, 256) = exp(sum of log1p(-alpha) over them)
//   n_contrib (T, 256) int32 = the last k + 1 at which the pixel composited
//       a live instance, k its index in the segment (zeros when the caller
//       does not want it)
//
// Empty tiles give color 0, final_T 1 and n_contrib 0. The transmittance is
// carried in the log domain; the TPU kernel carries a product across
// 128-lane chunks, so the two differ in rounding only.
//
// Design. The TPU kernel DMAs 128-lane windows aligned to the slab, masks
// the head lanes of each tile's unaligned segment and carries its state
// across a sequential grid. None of that exists here: the kernel places its
// tile (origin x0/y0, segment from starts) and runs the segmented forward
// kernel's walk (composite_seg_walk.cuh, fwd_walk), staged straight from
// the segment's unaligned start: one FWD_THREADS block per tile, FWD_ROWS
// pixel rows per thread, strip masks at staging so a warp visits only the
// instances that can be live in its rows. n_contrib is one integer per row
// a thread, set at each composited pair, compiled out when not wanted.
//
// Bound. Each visited pixel-instance pair is ~17 fp32 operations, ~13 more
// when it composites, against a few bytes of shared memory: the kernel is
// bound by operations (fp32 ALU, the SFU and shared-memory loads), not by
// device memory, which it reads once (9 floats per instance) and writes
// once (5 words per pixel). The strip masks remove the pairs of warps that
// no instance reaches; two pixels per thread halve the shared-memory loads
// per pair.

#include "composite_seg_walk.cuh"

namespace {

using namespace omnigs_seg;

template <bool WANT_NC>
__global__ void __launch_bounds__(FWD_THREADS) composite_tile_fwd_kernel(
    const float* __restrict__ inst, long long rpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ x0, const int* __restrict__ y0,
    float* __restrict__ color, float* __restrict__ final_t,
    int* __restrict__ ncontrib) {
  const int tile = blockIdx.x;
  fwd_walk<WANT_NC>(inst, rpad, starts[tile], counts[tile], x0[tile],
                    y0[tile], tile, color, final_t, ncontrib);
}

}  // namespace

extern "C" int omnigs_composite_tile_fwd(
    const void* inst, long long rpad, const void* starts, const void* counts,
    const void* x0, const void* y0, int num_tiles, int want_ncontrib,
    void* color, void* final_t, void* ncontrib, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = want_ncontrib ? composite_tile_fwd_kernel<true>
                              : composite_tile_fwd_kernel<false>;
  kernel<<<num_tiles, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<float*>(color),
      static_cast<float*>(final_t), static_cast<int*>(ncontrib));
  return static_cast<int>(cudaGetLastError());
}

// Segmented front-to-back alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel
// (launched by composite_seg_fwd). Same function: for every 16x16 tile t,
// composite the depth-sorted instances of the tile's segment
// [starts8[t], starts8[t] + counts[t]) of the (16, R8) instance slab over
// the tile's 256 pixels and write color (T, 3, 256) and
// final_T = exp(log_T) (T, 256). The transmittance stays in the TPU
// kernel's log domain, so the two differ only in summation order. Empty
// tiles give color 0 and T = 1.
//
// Design. The TPU kernel walks the slab linearly in 128-lane chunks that
// straddle tile boundaries, with dense-tile windows, ride rows and a boundary
// re-read, because a TPU grid runs in order on one core. None of that is
// needed here: the kernel places its tile (origin from its id, segment from
// starts8) and runs fwd_walk of composite_seg_walk.cuh, the walk the
// tile-major forward (#3) shares: one block per tile, FWD_ROWS vertically
// adjacent pixels per thread, instances staged in batches through shared
// memory with a strip mask each; a warp visits only the instances that can be
// live in its pixel rows. Dead pairs skip the transmittance math; a pixel
// stops at its first contribution failure, a warp once all its pixels have,
// the block once every pixel of the tile has.
//
// Bound. Each visited pixel-instance pair is ~17 fp32 operations and 1 to 3
// transcendentals against a few bytes of shared memory: the kernel is bound
// by issue (fp32 ALU, the SFU and shared-memory loads), not by device
// memory, which it reads once (9 floats per instance) and writes once (4
// floats per pixel). The strip masks remove the pairs of warps that no
// instance reaches; two pixels per thread halve the shared-memory loads per
// pair.

#include "composite_seg_walk.cuh"

namespace {

using namespace omnigs_seg;

__global__ void __launch_bounds__(FWD_THREADS) composite_seg_fwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts, int gx,
    int tile_lo, float* __restrict__ color, float* __restrict__ final_t) {
  const int tile = blockIdx.x;
  const int gid = tile + tile_lo;
  fwd_walk<false>(inst, r8, starts8[tile], counts[tile], (gid % gx) * TILE,
                  (gid / gx) * TILE, tile, color, final_t, nullptr);
}

}  // namespace

extern "C" int omnigs_composite_seg_fwd(
    const void* inst, long long r8, const void* starts8, const void* counts,
    int num_tiles, int gx, int tile_lo, void* color, void* final_t,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_seg_fwd_kernel<<<num_tiles, FWD_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), r8, static_cast<const int*>(starts8),
      static_cast<const int*>(counts), gx, tile_lo,
      static_cast<float*>(color), static_cast<float*>(final_t));
  return static_cast<int>(cudaGetLastError());
}

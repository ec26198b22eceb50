// Segmented front-to-back alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel
// (launched by composite_seg_fwd). Same function: for every 16x16 tile t,
// composite the depth-sorted instances of the tile's segment
// [starts8[t], starts8[t] + counts[t]) of the (16, R8) instance slab over
// the tile's 256 pixels (the per-pair math and the walk in composite.cuh)
// and write color (T, 3, 256) and final_T = exp(log_T) (T, 256). The
// transmittance stays in the TPU kernel's log domain, so the two differ
// only in summation order. Empty tiles give color 0 and T = 1.
//
// Design. The TPU kernel walks the slab linearly in 128-lane chunks that
// straddle tile boundaries, with dense-tile windows, ride rows and a
// boundary re-read, because a TPU grid runs in order on one core. None of
// that is needed here: one 256-thread block per tile, one thread per pixel,
// instances staged in batches through shared memory. Dead pairs (alpha
// below the floor) skip the transmittance math; a pixel stops at its first
// contribution failure, and the block leaves early once no pixel of the
// tile is still contributing.
//
// Bound. Each pixel-instance pair is ~25 fp32 operations and 1 to 3
// transcendentals against a few bytes of shared memory: the kernel is bound
// by operations (fp32 ALU and the SFU), not by device memory, which it
// reads once (9 floats per instance) and writes once (4 floats per pixel).
// The design therefore spends nothing on memory pipelining; making it
// faster means fewer operations per pair (warp-level culling of dead
// instances, several pixels per thread), which is later work.

#include "composite.cuh"

namespace {

using namespace omnigs_composite;

__global__ void __launch_bounds__(PX) composite_seg_fwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts, int gx,
    int tile_lo, float* __restrict__ color, float* __restrict__ final_t) {
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int gid = tile + tile_lo;
  const float px = static_cast<float>((gid % gx) * TILE + p % TILE);
  const float py = static_cast<float>((gid / gx) * TILE + p / TILE);
  const FwdPixel o = composite_fwd_walk<false>(inst, r8, starts8[tile],
                                               counts[tile], px, py);
  store_fwd(o, tile, color, final_t);
}

}  // namespace

extern "C" int omnigs_composite_seg_fwd(
    const void* inst, long long r8, const void* starts8, const void* counts,
    int num_tiles, int gx, int tile_lo, void* color, void* final_t,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_seg_fwd_kernel<<<num_tiles, PX, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), r8, static_cast<const int*>(starts8),
      static_cast<const int*>(counts), gx, tile_lo,
      static_cast<float*>(color), static_cast<float*>(final_t));
  return static_cast<int>(cudaGetLastError());
}

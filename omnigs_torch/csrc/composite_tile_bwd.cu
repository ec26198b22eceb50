// Tile-major front-to-back alpha compositing, backward, for Hopper
// (sm_90a): two kernels, each on its own walk.
//
// omnigs_composite_tile_bwd replaces the TPU kernel
// omnigs_tpu/ops/pallas_raster.py::_bwd_kernel (with _bwd_tile and
// _bwd_chunk_math; launched by composite_pallas_bwd). Same function: nine
// gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) at each lane of each
// tile's compact-layout segment of dinst (16, rpad), zeros everywhere else
// (the wrapper allocates them) — the TPU result after its merge of the
// per-tile heads. It places its tile (origin x0/y0, segment from starts)
// and runs the segmented backward kernel's walk (composite_seg_walk.cuh,
// bwd_walk).
//
// omnigs_composite_tile_bwd_fused replaces _bwd_kernel_fused (launched by
// composite_pallas_bwd_fused): the same rows, summed per ids[lane] (the
// depth rank under a depth presort) into acc (p, 9), which the wrapper
// zeroes. It runs the walk of composite.cuh (composite_bwd_walk).
//
// Design. The TPU kernel writes each tile's first 128-lane chunk, which a
// neighbouring tile may share in the unaligned layout, to a private "heads"
// array and merges it by a scatter-add afterwards; it forms the pixel sums
// as moments on the MXU. Here one block per tile owns exactly its segment's
// lanes, so the unfused kernel writes them directly: no heads, no merge, no
// atomics, and the output is deterministic. Its walk skips the
// warp-instance pairs whose strip mask lacks the warp's bit and sums each
// visited instance's nine partials by recursive halving (12 shuffles, not
// 45). The TPU fused kernel keeps the (P, 16) table in on-chip memory across
// a sequential grid; blocks here run in parallel, so each instance's nine
// tile-summed rows go to device memory with atomicAdd: no per-instance
// gradient slab and no reduction pass, but the order of the float additions
// into a Gaussian's row changes from run to run, so its sums are not
// bitwise repeatable. The caller takes the fused route only where the JAX
// package does (fused_reduce=True, no emission payload, P <= 163,840).
//
// Bound. Per visited pixel-instance pair the forward's ~17 fp32 operations;
// per composited pair ~39 more (transmittance, dL/dalpha with one division,
// nine partials and their warp sums); per instance 72 for the warp sums and
// the rows (+ 9 atomic adds fused). Device memory is read once (9 floats per
// instance, 6 per pixel) and written once (9 floats per instance plus the
// zero fill of the output, or the (p, 9) table): bound by operations, like
// the forward.

#include "composite_seg_walk.cuh"

namespace {

using namespace omnigs_composite;

__global__ void __launch_bounds__(PX) composite_tile_bwd_kernel(
    const float* __restrict__ inst, long long rpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ x0, const int* __restrict__ y0,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    float* __restrict__ dinst) {
  const int tile = blockIdx.x;
  omnigs_seg::bwd_walk(inst, rpad, starts[tile], counts[tile], x0[tile],
                       y0[tile], tile, color_full, dcolor, dinst);
}

__global__ void __launch_bounds__(PX) composite_tile_bwd_fused_kernel(
    const float* __restrict__ inst, long long rpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ x0, const int* __restrict__ y0,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    const int* __restrict__ ids, long long n_ids, int p,
    float* __restrict__ acc) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = static_cast<float>(x0[tile] + tid % TILE);
  const float py = static_cast<float>(y0[tile] + tid / TILE);
  composite_bwd_walk(inst, rpad, starts[tile], counts[tile], px, py, tile,
                     color_full, dcolor, ids, n_ids, p, acc);
}

}  // namespace

extern "C" int omnigs_composite_tile_bwd(
    const void* inst, long long rpad, const void* starts, const void* counts,
    const void* x0, const void* y0, const void* color_full,
    const void* dcolor, int num_tiles, void* dinst, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tile_bwd_kernel<<<num_tiles, PX, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<const float*>(color_full),
      static_cast<const float*>(dcolor), static_cast<float*>(dinst));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int omnigs_composite_tile_bwd_fused(
    const void* inst, long long rpad, const void* ids, long long n_ids,
    const void* starts, const void* counts, const void* x0, const void* y0,
    const void* color_full, const void* dcolor, int num_tiles, int p,
    void* acc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tile_bwd_fused_kernel<<<num_tiles, PX, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<const float*>(color_full),
      static_cast<const float*>(dcolor), static_cast<const int*>(ids), n_ids,
      p, static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}

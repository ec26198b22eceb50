// Segmented front-to-back alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel
// (launched by composite_seg_fwd). Same function: for every 16x16 tile t,
// composite the depth-sorted instances of the tile's segment
// [starts8[t], starts8[t] + counts[t]) of the (16, R8) instance slab over
// the tile's 256 pixels (the walk in composite_seg_walk.cuh, with the
// per-pair arithmetic of composite.cuh) and write color (T, 3, 256) and
// final_T = exp(log_T) (T, 256). The transmittance stays in the TPU
// kernel's log domain, so the two differ only in summation order. Empty
// tiles give color 0 and T = 1.
//
// Design. The TPU kernel walks the slab linearly in 128-lane chunks that
// straddle tile boundaries, with dense-tile windows, ride rows and a
// boundary re-read, because a TPU grid runs in order on one core. None of
// that is needed here: one block per tile, FWD_ROWS vertically adjacent
// pixels per thread, instances staged in batches through shared memory with
// a strip mask each; a warp visits only the instances that can be live in
// its pixel rows. Dead pairs skip the transmittance math; a pixel stops at
// its first contribution failure, a warp once all its pixels have, the
// block once every pixel of the tile has.
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
  __shared__ Stage<FWD_BATCH> s;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = tile + tile_lo;
  const int tx0 = (gid % gx) * TILE;
  const int ty0 = (gid / gx) * TILE;
  // rows row0 .. row0 + FWD_ROWS - 1 of the warp's strip, column lane % 16
  const int row0 = warp * FWD_STRIP + (lane / TILE) * FWD_ROWS;
  const float px = static_cast<float>(tx0 + lane % TILE);
  float py[FWD_ROWS];
  FwdPixel o[FWD_ROWS];
  bool done[FWD_ROWS];
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) {
    py[r] = static_cast<float>(ty0 + row0 + r);
    o[r] = FwdPixel{0.f, 0.f, 0.f, 0.f};
    done[r] = false;
  }
  const auto all_done = [&done]() {
    bool all = true;
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r) all = all && done[r];
    return all;
  };
  const long long start = starts8[tile];
  const int n = counts[tile];
  for (int base = 0; base < n; base += FWD_BATCH) {
    const int m = min(FWD_BATCH, n - base);
    stage_batch<FWD_BATCH, FWD_THREADS, FWD_STRIP>(s, inst, r8, start + base,
                                                   m, tx0, ty0);
    __syncthreads();
    for (int j0 = 0; j0 < m; j0 += 32) {
      if (__all_sync(FULL, all_done())) break;
      unsigned bits = strip_ballot(s, j0, m, warp, lane);
      while (bits) {
        const int j = j0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 geo = s.geo[j];
        const float4 opc = s.opc[j];
#pragma unroll
        for (int r = 0; r < FWD_ROWS; ++r) {
          if (!done[r]) {
            done[r] = fwd_pair(geo, opc, &s.blue[j], px, py[r], o[r]);
          }
        }
      }
    }
    // also the barrier before the next batch overwrites the stage
    if (__syncthreads_count(!all_done()) == 0) break;
  }
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) {
    const int p = (row0 + r) * TILE + lane % TILE;
    float* c = color + static_cast<long long>(tile) * 3 * PX + p;
    c[0] = o[r].r;
    c[PX] = o[r].g;
    c[2 * PX] = o[r].b;
    final_t[static_cast<long long>(tile) * PX + p] = expf(o[r].log_t);
  }
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

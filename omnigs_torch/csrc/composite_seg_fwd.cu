// Segmented front-to-back alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel
// (launched by composite_seg_fwd). Same function: for every 16x16 tile t,
// composite the depth-sorted instances of the tile's segment
// [starts8[t], starts8[t] + counts[t]) of the (16, R8) instance slab
// (rows x, y, A, B, C, opacity, r, g, b) over the tile's 256 pixels:
//
//   dx = x - px, dy = y - py   (px, py integer pixel coordinates)
//   power = -0.5 (A dx^2 + C dy^2) - B dx dy
//   alpha = min(0.99, op exp(min(power, 0))), live iff power <= 0 and
//           alpha >= 1/255
//   N_excl = exp(sum of log1p(-alpha) over earlier live instances)
//   contributes iff N_excl (1 - alpha) >= 1e-4
//   color += rgb alpha N_excl, log_T += log1p(-alpha) when contributing
//
// and write color (T, 3, 256) and final_T = exp(log_T) (T, 256). The
// transmittance stays in the TPU kernel's log domain, so the two differ
// only in summation order. Empty tiles give color 0 and T = 1.
//
// Design. The TPU kernel walks the slab linearly in 128-lane chunks that
// straddle tile boundaries, with dense-tile windows, ride rows and a
// boundary re-read, because a TPU grid runs in order on one core. None of
// that is needed here: one 256-thread block per tile, one thread per pixel,
// instances staged in batches through shared memory (row-major slab rows,
// so each staging load is coalesced; threads then read each instance as a
// shared-memory broadcast). Dead pairs (alpha below the floor) skip the
// transmittance math; a pixel stops at its first contribution failure
// (transmittance only falls from there), and the block leaves early once no
// pixel of the tile is still contributing (__syncthreads_count).
//
// Bound. Each pixel-instance pair is ~25 fp32 operations and 1 to 3
// transcendentals against a few bytes of shared memory: the kernel is bound
// by operations (fp32 ALU and the SFU), not by device memory, which it
// reads once (9 floats per instance) and writes once (4 floats per pixel).
// The design therefore spends nothing on memory pipelining; making it
// faster means fewer operations per pair (warp-level culling of dead
// instances, several pixels per thread), which is later work.
//
// Built with --fmad=false so every mul/add rounds as the plain PyTorch
// version's elementwise ops do.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // threads per block, one per pixel
constexpr int BATCH = 256;       // instances staged per shared-memory batch
constexpr int NSTAGE = 9;        // slab rows used: x y A B C op r g b
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1.0e-4f;

__global__ void __launch_bounds__(PX) composite_seg_fwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts, int gx,
    int tile_lo, float* __restrict__ color, float* __restrict__ final_t) {
  __shared__ float stage[NSTAGE][BATCH];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int gid = tile + tile_lo;
  const float px = static_cast<float>((gid % gx) * TILE + p % TILE);
  const float py = static_cast<float>((gid / gx) * TILE + p / TILE);
  const long long start = starts8[tile];
  const int n = counts[tile];

  float s = 0.f;  // log of the transmittance before the next instance
  float log_t = 0.f;
  float cr = 0.f, cg = 0.f, cb = 0.f;
  bool done = false;
  for (int base = 0; base < n; base += BATCH) {
    const int m = min(BATCH, n - base);
    for (int k = p; k < NSTAGE * BATCH; k += PX) {
      const int row = k / BATCH;
      const int lane = k % BATCH;
      stage[row][lane] =
          lane < m ? inst[row * r8 + start + base + lane] : 0.f;
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
        const float n_excl = expf(s);
        if (!(n_excl * (1.f - alpha) >= T_STOP)) {
          done = true;
          break;
        }
        const float w = alpha * n_excl;
        cr += stage[6][j] * w;
        cg += stage[7][j] * w;
        cb += stage[8][j] * w;
        log_t += l;
        s += l;
      }
    }
    // also the barrier before the next batch overwrites the stage
    if (__syncthreads_count(!done) == 0) break;
  }
  float* c = color + static_cast<long long>(tile) * 3 * PX + p;
  c[0] = cr;
  c[PX] = cg;
  c[2 * PX] = cb;
  final_t[static_cast<long long>(tile) * PX + p] = expf(log_t);
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

extern "C" const char* omnigs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

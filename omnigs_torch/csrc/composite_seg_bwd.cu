// Segmented front-to-back alpha compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_bwd_seg_kernel
// (launched by composite_seg_bwd). Same function: for every 16x16 tile t and
// every instance i of the tile's segment [starts8[t], starts8[t] + counts[t])
// of the (16, R8) instance slab (rows x, y, A, B, C, opacity, r, g, b), given
// color_full (T, 3, 256), the forward color with bg * final_T blended in,
// and dL = dL/dcolor_full (T, 3, 256), write nine gradient rows at the
// instance's own lane of dinst (16, R8):
//
//   per pixel, in forward order (alpha and the stop exactly as the forward):
//     G = exp(min(power, 0)), alpha = min(0.99, op G), live as the forward
//     N_excl = exp(log-T before i); contributes iff N_excl (1 - alpha) >= 1e-4
//     w = alpha N_excl, u = dL . rgb
//     dL_dot_B = dL . color_full - sum_{j <= i} w_j u_j
//     dL/dalpha = N_excl u - dL_dot_B / (1 - alpha)   (0 unless contributing)
//     V = dL/dalpha * op G   (the 0.99 clamp is ignored, as the reference)
//   per instance, summed over the tile's 256 pixels:
//     dx = -(A sum V dx + B sum V dy), dy = -(C sum V dy + B sum V dx)
//     dA = -1/2 sum V dx^2, dB = -sum V dx dy, dC = -1/2 sum V dy^2
//     dop = sum dL/dalpha G, drgb = sum dL w
//
// Every other lane keeps the zeros the wrapper allocated.
//
// Design. The TPU kernel walks the slab in 128-lane chunks straddling tiles,
// carries transmittance and the dL.w.u prefix across chunks, broadcasts
// per-tile rows to lanes with one-hot matrix products and forms the pixel
// sums as moments S = Ut V on the MXU; all of that exists because a TPU grid
// runs in order on one core with a matrix unit. Here one 256-thread block
// per tile, one thread per pixel, as in composite_seg_fwd.cu. Each thread
// carries its pixel's log-T, the running sum of w u, dL and dL . color_full
// through ONE forward walk: color_full is saved by the forward, so no
// reverse pass is needed. Instances are staged through shared memory in
// batches. Per instance each thread forms its nine partials; a warp-shuffle
// butterfly sums them in a fixed order (skipped, with zeros written, when
// __any_sync says no pixel of the warp contributes), and after the batch the
// eight warp partials are summed in warp order through shared memory. Each
// slab lane belongs to exactly one tile, so the block writes its lanes
// alone: no atomics, and the result is deterministic. The block stops
// reading once every pixel of the tile has stopped.
//
// Bound. Per visited pixel-instance pair the forward's ~17 fp32 operations;
// per contributing pair ~31 more (transmittance, dL/dalpha with one
// division, nine partials) and 9 adds of the reduction. Device memory is
// read once (9 floats per instance, 6 per pixel) and written once (9 floats
// per instance, plus the wrapper's zero fill of the output), so the kernel
// is bound by operations, like the forward. This first version spends
// nothing on memory pipelining or on warp-level culling.
//
// Built with --fmad=false, like the forward: alpha, the log-domain
// transmittance (sequential sum) and the stop test round exactly as in
// composite_seg_fwd.cu, so both kernels make the same stop decisions.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;  // threads per block, one per pixel
constexpr int NWARP = PX / 32;
constexpr int BATCH = 64;  // instances staged per shared-memory batch
constexpr int NSTAGE = 9;  // slab rows used: x y A B C op r g b
constexpr int NGRAD = 9;   // gradient rows written
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1.0e-4f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PX) composite_seg_bwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    int gx, int tile_lo, float* __restrict__ dinst) {
  __shared__ float stage[NSTAGE][BATCH];
  __shared__ float red[NWARP][NGRAD][BATCH];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int gid = tile + tile_lo;
  const float px = static_cast<float>((gid % gx) * TILE + p % TILE);
  const float py = static_cast<float>((gid / gx) * TILE + p / TILE);
  const long long start = starts8[tile];
  const int n = counts[tile];

  const long long pix = static_cast<long long>(tile) * 3 * PX + p;
  const float dlr = dcolor[pix];
  const float dlg = dcolor[pix + PX];
  const float dlb = dcolor[pix + 2 * PX];
  const float dl_cf = dlr * color_full[pix] + dlg * color_full[pix + PX] +
                      dlb * color_full[pix + 2 * PX];

  float s = 0.f;       // log of the transmittance before the next instance
  float wu_acc = 0.f;  // sum of w u over the instances so far
  bool done = false;
  for (int base = 0; base < n; base += BATCH) {
    const int m = min(BATCH, n - base);
    for (int k = p; k < NSTAGE * BATCH; k += PX) {
      const int row = k / BATCH;
      const int j = k % BATCH;
      stage[row][j] = j < m ? inst[row * r8 + start + base + j] : 0.f;
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
            const float dl_dot_b = dl_cf - wu_acc;
            const float dl_da = n_excl * u - dl_dot_b / one_m;
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
    // then the nine rows at the instance's own lane
    if (p < m) {
      float sum[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) {
        float acc = red[0][q][p];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) acc += red[w][q][p];
        sum[q] = acc;
      }
      const float A = stage[2][p];
      const float B = stage[3][p];
      const float C = stage[4][p];
      float* out = dinst + start + base + p;
      out[0] = -(A * sum[0] + B * sum[1]);
      out[r8] = -(C * sum[1] + B * sum[0]);
      out[2 * r8] = -0.5f * sum[2];
      out[3 * r8] = -sum[3];
      out[4 * r8] = -0.5f * sum[4];
      out[5 * r8] = sum[5];
      out[6 * r8] = sum[6];
      out[7 * r8] = sum[7];
      out[8 * r8] = sum[8];
    }
    // also the barrier before the next batch overwrites stage and red
    if (__syncthreads_count(!done) == 0) break;
  }
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

extern "C" const char* omnigs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

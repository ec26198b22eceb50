// Segmented front-to-back alpha compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel omnigs_tpu/ops/pallas_seg.py::_bwd_seg_kernel
// (launched by composite_seg_bwd). Same function: for every 16x16 tile t and
// every instance i of the tile's segment [starts8[t], starts8[t] + counts[t])
// of the (16, R8) instance slab, given color_full (T, 3, 256), the forward
// color with bg * final_T blended in, and dL = dL/dcolor_full (T, 3, 256),
// write nine gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) at the
// instance's own lane of dinst (16, R8) (the math as composite.cuh's
// composite_bwd_walk, the walk in composite_seg_walk.cuh). Every other lane
// keeps the zeros the wrapper allocated.
//
// Design. The TPU kernel walks the slab in 128-lane chunks straddling tiles,
// carries transmittance and the dL.w.u prefix across chunks, broadcasts
// per-tile rows to lanes with one-hot matrix products and forms the pixel
// sums as moments S = Ut V on the MXU; all of that exists because a TPU grid
// runs in order on one core with a matrix unit. Here one 256-thread block
// per tile, one thread per pixel, one forward walk per pixel from the saved
// color_full (no reverse pass). A warp (two pixel rows) visits only the
// instances whose strip mask has its bit, and sums each visited instance's
// nine partials over its lanes by recursive halving; after each batch one
// thread per instance adds the eight warp sums in warp order (a warp that
// did not visit the instance, or had no composited pixel, adds 0 as before).
// Each slab lane belongs to exactly one tile, so the block writes its lanes
// alone: no atomics, and the result is deterministic.
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

constexpr int GROUPS = BWD_BATCH / 32;  // ballots per warp and batch

__global__ void __launch_bounds__(PX) composite_seg_bwd_kernel(
    const float* __restrict__ inst, long long r8,
    const int* __restrict__ starts8, const int* __restrict__ counts,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    int gx, int tile_lo, float* __restrict__ dinst) {
  __shared__ Stage<BWD_BATCH> s;
  // warp sums; the stride BWD_BATCH + 1 puts the nine writer lanes on nine
  // banks
  __shared__ float red[NWARP][NGRAD][BWD_BATCH + 1];
  __shared__ unsigned wrote[NWARP][GROUPS];  // which red entries were set
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = tile + tile_lo;
  const int tx0 = (gid % gx) * TILE;
  const int ty0 = (gid / gx) * TILE;
  const float px = static_cast<float>(tx0 + tid % TILE);
  const float py = static_cast<float>(ty0 + tid / TILE);
  const int slot = halving_slot(lane);

  const long long pix = static_cast<long long>(tile) * 3 * PX + tid;
  const float dlr = dcolor[pix];
  const float dlg = dcolor[pix + PX];
  const float dlb = dcolor[pix + 2 * PX];
  const float dl_cf = dlr * color_full[pix] + dlg * color_full[pix + PX] +
                      dlb * color_full[pix + 2 * PX];

  const long long start = starts8[tile];
  const int n = counts[tile];
  float s_log = 0.f;   // log of the transmittance before the next instance
  float wu_acc = 0.f;  // sum of w u over the composited instances so far
  bool done = false;
  for (int base = 0; base < n; base += BWD_BATCH) {
    const int m = min(BWD_BATCH, n - base);
    stage_batch<BWD_BATCH, PX, BWD_STRIP>(s, inst, r8, start + base, m, tx0,
                                          ty0);
    __syncthreads();
#pragma unroll
    for (int grp = 0; grp < GROUPS; ++grp) {
      const int j0 = grp * 32;
      unsigned bits = 0u;
      if (j0 < m && !__all_sync(FULL, done)) {
        bits = strip_ballot(s, j0, m, warp, lane);
      }
      unsigned set = 0u;
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        const int j = j0 + k;
        float g[NGRAD];
        bool gated = false;
        if (!done) {
          const float4 geo = s.geo[j];
          const float4 opc = s.opc[j];
          const float dx = geo.x - px;
          const float dy = geo.y - py;
          const float power =
              -0.5f * (geo.z * dx * dx + opc.x * dy * dy) - geo.w * dx * dy;
          const float gauss = expf(fminf(power, 0.f));
          const float op_g = opc.y * gauss;
          const float alpha = fminf(op_g, ALPHA_MAX);
          if (power <= 0.f && alpha >= ALPHA_MIN) {
            const float l = log1pf(-alpha);
            const float n_excl = expf(s_log);
            const float one_m = 1.f - alpha;
            if (!(n_excl * one_m >= T_STOP)) {
              done = true;
            } else {
              const float w = alpha * n_excl;
              const float u =
                  dlr * opc.z + dlg * opc.w + dlb * s.blue[j];
              wu_acc += w * u;
              const float dl_da = n_excl * u - (dl_cf - wu_acc) / one_m;
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
              s_log += l;
              gated = true;
            }
          }
        }
        if (__any_sync(FULL, gated)) {
#pragma unroll
          for (int q = 0; q < NGRAD; ++q) g[q] = gated ? g[q] : 0.f;
          warp_sum_halving(g, lane);
          if (slot >= 0) red[warp][slot][j] = g[0];
          set |= 1u << k;
        }
      }
      if (lane == 0) wrote[warp][grp] = set;
    }
    __syncthreads();
    // one thread per instance of the batch: warp sums in warp order, then
    // the nine rows of the instance
    if (tid < m) {
      const int grp = tid / 32;
      const unsigned bit = 1u << (tid % 32);
      float sum[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) {
        float acc = (wrote[0][grp] & bit) ? red[0][q][tid] : 0.f;
#pragma unroll
        for (int w = 1; w < NWARP; ++w) {
          acc += (wrote[w][grp] & bit) ? red[w][q][tid] : 0.f;
        }
        sum[q] = acc;
      }
      const float A = s.geo[tid].z;
      const float B = s.geo[tid].w;
      const float C = s.opc[tid].x;
      float rows[NGRAD];
      rows[0] = -(A * sum[0] + B * sum[1]);
      rows[1] = -(C * sum[1] + B * sum[0]);
      rows[2] = -0.5f * sum[2];
      rows[3] = -sum[3];
      rows[4] = -0.5f * sum[4];
      rows[5] = sum[5];
      rows[6] = sum[6];
      rows[7] = sum[7];
      rows[8] = sum[8];
      const long long at = start + base + tid;
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) dinst[q * r8 + at] = rows[q];
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

// The superblock pre-cull of the tile binning, for Hopper (sm_90a): for every
// Gaussian row, the 64-bit mask of the blocks of its tile rect whose box the
// ellipse can reach at alpha >= 1/255, and the block geometry the expansion
// decodes it with.
//
// Replaces no TPU kernel: the JAX package (omnigs_tpu/ops/binning.py,
// _precull_masks) and the plain version (omnigs_torch/ops/binning.py,
// _precull_masks_plain) broadcast every row over MASK_TILES = 64 lanes and
// run ~85 elementwise passes over (P, 64) float32 / int64 tensors: ~28 GB of
// device traffic at P = 524,288 for a result of 24 B a row. This kernel reads
// each row once and writes its six integers once.
//
// Outputs, six (P,) int32 rows of one (6, P) buffer, as the plain version
// returns them: lo, hi (the mask's words as int32 bit patterns, bit 31
// included), tiles_eff = popcount(mask) * sx * sy, sx, sy, wb. Per row:
//   w = max(x1 - x0, 1), h = max(y1 - y0, 1); a rect of at most MASK_TILES
//   tiles (tiles_touched) takes 1 x 1 blocks, a larger one ceil(w / 8) x
//   ceil(h / 8) tiles a block; wb, hb blocks a row and a column, nb = wb hb.
//   Block b < min(nb, 64) of a live row (tiles_touched > 0) keeps its bit iff
//   op * exp(-0.5 qmin) >= 1/255, qmin the least of the conic's quadratic
//   form over the block's pixel box (0 if the box holds the mean, else the
//   least of the four edge minima clamped into the box).
// Dead rows (tiles_touched <= 0: three quarters of a training step's
// capacity rows) get a zero mask, sx = sy = 1 and wb = w, as the plain
// version gives them.
//
// Bit for bit with the plain version on the card: the block test is
// alpha_box.cuh's, shared with the expansion (csrc/expand_keys.cu), which
// repeats PyTorch's elementwise rounding and NaN rules in the plain
// version's order; nvcc runs with --fmad=false. Rect coordinates are the
// tile grid's (preprocess clips them to [0, grid]), so no integer step
// wraps and floor division is C's.
//
// Design. Bound by bytes and latency, with little arithmetic: ~68 B a row
// (rect 16, tiles_touched 4, means2d 8, conic 12, opacity 4 in; 24 out),
// 36 MB at P = 524,288, ~11 us at 3.35 TB/s. A warp takes 32 consecutive
// rows: each lane loads one row (the warp's loads cover contiguous rows) and
// works out its geometry; a ballot finds the warp's live rows, and for each
// the whole warp tests its blocks, lane l block l and, where nb > 32, block
// l + 32, the two words coming from two __ballot_sync; the row's lane keeps
// them. Dead rows cost their loads and stores only. Each lane then writes
// its row's six outputs, coalesced across the warp. No shared memory, no
// atomics: a replay reproduces bit for bit.

#include <cuda_runtime.h>

#include "alpha_box.cuh"
#include "cuda_error.cuh"

namespace {

constexpr int TILE = 16;        // tile edge in pixels (ops/preprocess.py TILE)
constexpr int MASK_TILES = 64;  // mask width (ops/binning.py MASK_TILES): two words
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

static_assert(MASK_TILES == 64, "the mask is two 32-bit ballots");

// one live row, as every lane of the warp holds it while the warp tests it
struct Row {
  int x0, y0, sx, sy, wb;
  float mx, my, A, B, C, op;
};

// block b of the row: does the max alpha over its pixel box reach 1/255?
__device__ bool block_survives(const Row& r, int b) {
  const int bx = b % r.wb, by = b / r.wb;
  const float px0 = static_cast<float>((r.x0 + bx * r.sx) * TILE);
  const float py0 = static_cast<float>((r.y0 + by * r.sy) * TILE);
  const float ex = static_cast<float>(r.sx * TILE - 1);
  const float ey = static_cast<float>(r.sy * TILE - 1);
  const float qmin = alpha_box::min_quad_over_box(r.A, r.B, r.C, px0 - r.mx, (px0 + ex) - r.mx,
                                                  py0 - r.my, (py0 + ey) - r.my);
  return alpha_box::alpha_reaches_min(r.op, qmin);
}

__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(FULL, v, src); }
__device__ __forceinline__ int shfl(int v, int src) { return __shfl_sync(FULL, v, src); }

__global__ void __launch_bounds__(THREADS) precull_kernel(
    const int* __restrict__ rect, long long rs0, long long rs1,
    const int* __restrict__ tiles, long long ts,
    const float* __restrict__ means, long long ms0, long long ms1,
    const float* __restrict__ conic, long long cs0, long long cs1,
    const float* __restrict__ opac, long long os, long long P, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool in = row < P;

  // this lane's row: geometry (dead rows and lanes past P included)
  int x0 = 0, y0 = 0, sx = 1, sy = 1, wb = 1, nb = 0, area = 0;
  float mx = 0.0f, my = 0.0f, A = 0.0f, B = 0.0f, C = 0.0f, op = 0.0f;
  if (in) {
    const int* rr = rect + row * rs0;
    x0 = rr[0];
    y0 = rr[rs1];
    const int w = max(rr[2 * rs1] - x0, 1), h = max(rr[3 * rs1] - y0, 1);
    area = tiles[row * ts];
    if (area > MASK_TILES) {
      sx = (w + 7) / 8;
      sy = (h + 7) / 8;
    }
    wb = (w + sx - 1) / sx;
    nb = wb * ((h + sy - 1) / sy);
    if (area > 0) {
      mx = means[row * ms0];
      my = means[row * ms0 + ms1];
      A = conic[row * cs0];
      B = conic[row * cs0 + cs1];
      C = conic[row * cs0 + 2 * cs1];
      op = opac[row * os];
    }
  }

  // the warp's live rows, one at a time, 32 blocks a pass
  unsigned lo = 0u, hi = 0u;
  unsigned live = __ballot_sync(FULL, in && area > 0);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    const Row r{shfl(x0, src), shfl(y0, src), shfl(sx, src), shfl(sy, src), shfl(wb, src),
                shfl(mx, src), shfl(my, src), shfl(A, src),  shfl(B, src),  shfl(C, src),
                shfl(op, src)};
    const int n = shfl(nb, src);
    const unsigned w0 = __ballot_sync(FULL, lane < n && block_survives(r, lane));
    const unsigned w1 = n > 32 ? __ballot_sync(FULL, lane + 32 < n && block_survives(r, lane + 32)) : 0u;
    if (lane == src) {
      lo = w0;
      hi = w1;
    }
  }

  if (!in) return;
  const int count = __popc(lo) + __popc(hi);
  out[row] = static_cast<int>(lo);
  out[P + row] = static_cast<int>(hi);
  out[2 * P + row] = count * (sx * sy);
  out[3 * P + row] = sx;
  out[4 * P + row] = sy;
  out[5 * P + row] = wb;
}

}  // namespace

// rect (P, 4) int32, tiles_touched (P,) int32, means2d (P, 2), conic (P, 3),
// opacity (P,) float32, each read through its element strides; out: the
// contiguous (6, P) int32 buffer of (lo, hi, tiles_eff, sx, sy, wb).
extern "C" int omnigs_precull(const void* rect, long long rs0, long long rs1, const void* tiles,
                              long long ts, const void* means, long long ms0, long long ms1,
                              const void* conic, long long cs0, long long cs1, const void* opac,
                              long long os, long long P, void* out, int device, void* stream) {
  if (P <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((P + THREADS - 1) / THREADS);
  precull_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rect), rs0, rs1, static_cast<const int*>(tiles), ts,
      static_cast<const float*>(means), ms0, ms1, static_cast<const float*>(conic), cs0, cs1,
      static_cast<const float*>(opac), os, P, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

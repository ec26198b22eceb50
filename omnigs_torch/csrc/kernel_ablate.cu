// Ablations of the elementwise tile-major forward compositing, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel scripts/kernel_ablate.py::make_kernel(mode)
// (launched by run), a microbenchmark that times the chunked elementwise
// forward with parts removed. Six variants of one function, template
// <int MODE>: 0 dma, 1 alpha, 2 notrans, 3 nocumsum, 4 lowprec, 5 full.
// Tile t reads its chunk-aligned slab segment of inst (16, rpad) f32 (rows
// x, y, A, B, C, opacity, r, g, b), 128 lanes per chunk, and writes a
// (3, 256) color plane per tile to out (T, 3, 256) f32:
//
//   n_chunks = ceil(counts[t] / 128); chunk c holds lanes start + 128 c +
//   k, k < 128, whatever the count (lanes at or past rpad read as 0);
//   before each chunk the tile goes on only while c < n_chunks and max over
//   its pixels of N >= 1e-4 (N = 1 at the start). Per pixel (px, py) =
//   (x0[t] + p % 16, y0[t] + p / 16) and lane k, with kk = 128 c + k:
//     dx = x - px, dy = y - py, power = -0.5 (A dx dx + C dy dy) - B dx dy
//     alpha = min(0.99, op exp(min(power, 0)))
//     a = alpha if 0 <= kk < count, power <= 0 and alpha >= 1/255, else 0
//   and per chunk, with cs the inclusive prefix over the chunk's lanes:
//     dma      color += sum over lanes of rows x, y, A
//     alpha    color += sum of a (all three planes); N *= 0.9999
//     notrans  N_incl = N (1 + cs(-a)), w = a N_incl, color += rgb . w;
//              N *= 1 - 1e-6 sum of a
//     nocumsum l = log1p(-a), N_incl = N exp(l), w = a N_incl,
//              color += rgb . w; N *= exp(sum of l)
//     lowprec  l = log1p(-a), N_incl = N exp(cs(bf16(l))),
//              w = bf16(a N_incl), color += bf16(rgb) . w (fp32 sums);
//              N *= exp(sum of l)
//     full     l = log1p(-a), N_incl = N exp(cs(l)), N_excl = N_incl /
//              (1 - a), w = a N_excl [N_incl >= 1e-4], color += rgb . w;
//              N *= exp(sum of l)
//
// What the modes mean on this card. All six run one staging and one walk,
// so "mode - dma" is what the mode's arithmetic costs here. dma is the
// staging floor (the TPU's double-buffered DMA windows hid load latency in
// a grid that runs in order; here other resident blocks do). alpha is the
// alpha math of the visited pairs, notrans adds the compositing without
// transcendentals, nocumsum the log1p/exp pair per live pair, full the
// prefix, the division and the mask. lowprec rounds the operands to bf16:
// on the TPU that saved matrix-unit passes of the prefix and color
// products; here those are sequential per pixel, so it only adds
// conversions.
//
// Design. One block of FWD_THREADS threads per tile, FWD_ROWS vertically
// adjacent pixels per thread and FWD_STRIP pixel rows per warp
// (composite_seg_walk.cuh, the walk of kernels #1-#5, whose staging this
// kernel shares):
//
// 1. A chunk is staged once, with strip masks (strip_mask<FWD_STRIP>), and
//    only its lanes below min(128, count - 128 c, rpad - base): the lanes
//    past the count or at or past rpad are dead and never visited.
// 2. One broadcast read of a staged lane serves FWD_ROWS pairs, and their
//    transcendental chains are independent. The stop vote stays the
//    block's (__syncthreads_or over both pixels of every thread).
// 3. A warp visits only the lanes whose strip bit it has (one ballot per 32
//    lanes); alpha and the live test run per pixel, and in nocumsum,
//    lowprec and full the mode's tail (log1p, prefix, exp, division,
//    weights) only where some pixel of the warp is live (a second ballot;
//    notrans's tail of a few multiply-adds costs less than that ballot, so
//    it runs on every visited lane). In full, a warp whose pixels all have
//    N < 1e-4 at a chunk's start skips the chunk: every weight it would
//    form is masked to 0, and its pixels vote to stop either way.
// 4. dma: the sums are the same for every pixel of the tile, so three
//    threads take them once per chunk, one row each, in lane order; they
//    reach every pixel's planes through shared memory at the end.
//
// Exactness. A skipped pair is dead (a = +0, bf16(-0) = -0), so its update
// would leave every carried value as it is: cs + (-0), sum + (+-0),
// wr + r 0 and N 0.9999 for a chunk are unchanged, given finite colors
// (the precondition of the skips: r 0 is NaN for an infinite r). In full,
// a pixel with N < 1e-4 at a chunk's start has N_incl <= N, so all its
// weights in the chunk are masked to 0, and its N only falls. So every
// mode's output is that of the walk over all 128 lanes bit for bit, and
// the plain PyTorch version's (kernel_ablate_plain), which walks them all.
// Built with --fmad=false, so every mul/add rounds as the plain version's
// elementwise ops do.
//
// Bound. Per lane-pixel pair with the lane below the count in a visited
// chunk the alpha math (19 fp32 operations, a transcendental counted as
// one); per live pair the mode's tail (1 to 17 more); against 36 bytes of
// device memory per staged lane (12 for dma), read once: every mode but
// dma is bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "composite_seg_walk.cuh"
#include "cuda_error.cuh"

namespace {

using omnigs_seg::ALPHA_MAX;
using omnigs_seg::ALPHA_MIN;
using omnigs_seg::FWD_ROWS;
using omnigs_seg::FWD_STRIP;
using omnigs_seg::FWD_THREADS;
using omnigs_seg::PX;
using omnigs_seg::Stage;
using omnigs_seg::T_STOP;
using omnigs_seg::TILE;

constexpr unsigned WARP_ALL = 0xffffffffu;
constexpr int CHUNK = 128;
constexpr int DMA_ROWS = 3;  // x y A

// The design elements, each taken out by one ablation
// (omnigs_torch/utils/kernel_variants.py, ABLATE_ABLATIONS).
constexpr bool COUNT_TRIM = true;  // stage and visit only lanes below the count
constexpr bool LIVE_SKIP = true;   // a log1p tail only where a pixel of the warp is live
constexpr bool WARP_STOP = true;   // full: a warp of stopped pixels skips the chunk
constexpr bool DMA_ONCE = true;    // dma: three threads take the tile's sums

enum Mode { DMA = 0, ALPHA = 1, NOTRANS = 2, NOCUMSUM = 3, LOWPREC = 4, FULL = 5 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dma: the chunk's rows x, y, A summed over its 128 lanes, added to every
// pixel's planes.
__device__ __forceinline__ void dma_tile(const float* __restrict__ inst,
                                         long long rpad, long long start,
                                         int count, float* __restrict__ o) {
  __shared__ float s[DMA_ROWS][CHUNK];
  __shared__ float total[DMA_ROWS];
  const int tid = threadIdx.x;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  float acc = 0.0f;                          // DMA_ONCE: row tid's total
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;     // otherwise: every thread's
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // before the staging overwrites s
    const long long base = start + static_cast<long long>(c) * CHUNK;
    for (int i = tid; i < DMA_ROWS * CHUNK; i += FWD_THREADS) {
      const int q = i / CHUNK;
      const long long at = base + i % CHUNK;
      s[q][i % CHUNK] = at < rpad ? inst[q * rpad + at] : 0.0f;
    }
    __syncthreads();
    if constexpr (DMA_ONCE) {
      if (tid < DMA_ROWS) {
        float sum = 0.0f;
        for (int k = 0; k < CHUNK; ++k) sum = sum + s[tid][k];
        acc = acc + sum;
      }
    } else {
      float sr = 0.0f, sg = 0.0f, sb = 0.0f;
      for (int k = 0; k < CHUNK; ++k) {
        sr = sr + s[0][k];
        sg = sg + s[1][k];
        sb = sb + s[2][k];
      }
      cr = cr + sr;
      cg = cg + sg;
      cb = cb + sb;
    }
  }
  if constexpr (DMA_ONCE) {
    if (tid < DMA_ROWS) total[tid] = acc;
    __syncthreads();
    cr = total[0];
    cg = total[1];
    cb = total[2];
  }
  for (int p = tid; p < PX; p += FWD_THREADS) {
    o[p] = cr;
    o[PX + p] = cg;
    o[2 * PX + p] = cb;
  }
}

// The other modes: the walk of design elements 1-3 over the tile's chunks.
template <int MODE>
__device__ __forceinline__ void mode_tile(const float* __restrict__ inst,
                                          long long rpad, long long start,
                                          int count, int tx0, int ty0,
                                          float* __restrict__ o) {
  __shared__ Stage<CHUNK> s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // rows row0 .. row0 + FWD_ROWS - 1 of the warp's strip, column lane % 16
  const int row0 = warp * FWD_STRIP + (lane / TILE) * FWD_ROWS;
  const float px = static_cast<float>(tx0 + lane % TILE);
  float py[FWD_ROWS], n[FWD_ROWS], cr[FWD_ROWS], cg[FWD_ROWS], cb[FWD_ROWS];
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) {
    py[r] = static_cast<float>(ty0 + row0 + r);
    n[r] = 1.0f;
    cr[r] = cg[r] = cb[r] = 0.0f;
  }
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    bool go = false;
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r) go = go || n[r] >= T_STOP;
    // the stop vote is also the barrier before the staging overwrites s
    if (!__syncthreads_or(go)) break;
    const long long base = start + static_cast<long long>(c) * CHUNK;
    const int below = COUNT_TRIM ? min(CHUNK, count - c * CHUNK) : CHUNK;
    const int m = static_cast<int>(min(static_cast<long long>(below), rpad - base));
    omnigs_seg::stage_batch<CHUNK, FWD_THREADS, FWD_STRIP>(s, inst, rpad, base, m,
                                                           tx0, ty0);
    __syncthreads();
    // of a (alpha, notrans) or of l (the others); inclusive lane prefix;
    // the chunk's color sums
    float sum[FWD_ROWS], cs[FWD_ROWS], wr[FWD_ROWS], wg[FWD_ROWS], wb[FWD_ROWS];
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r) sum[r] = cs[r] = wr[r] = wg[r] = wb[r] = 0.0f;
    const bool skip = MODE == FULL && WARP_STOP && __all_sync(WARP_ALL, !go);
    for (int j0 = 0; j0 < m && !skip; j0 += 32) {
      unsigned bits = omnigs_seg::strip_ballot(s, j0, m, warp, lane);
      while (bits) {
        const int j = j0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 geo = s.geo[j];  // x y A B
        const float4 opc = s.opc[j];  // C op r g
        float a[FWD_ROWS];
        bool any = false;
#pragma unroll
        for (int r = 0; r < FWD_ROWS; ++r) {
          const float dx = geo.x - px;
          const float dy = geo.y - py[r];
          const float power =
              -0.5f * (geo.z * dx * dx + opc.x * dy * dy) - geo.w * dx * dy;
          const float alpha = fminf(opc.y * expf(fminf(power, 0.0f)), ALPHA_MAX);
          const bool live = (COUNT_TRIM || c * CHUNK + j < count) && power <= 0.0f &&
                            alpha >= ALPHA_MIN;
          a[r] = live ? alpha : 0.0f;
          any = any || live;
        }
        if constexpr (MODE == ALPHA) {
#pragma unroll
          for (int r = 0; r < FWD_ROWS; ++r) sum[r] = sum[r] + a[r];
          continue;
        }
        if (LIVE_SKIP && MODE != NOTRANS && !__any_sync(WARP_ALL, any)) continue;
        float red = opc.z, green = opc.w, blue = s.blue[j];
        if constexpr (MODE == LOWPREC) {
          red = bf16_round(red);
          green = bf16_round(green);
          blue = bf16_round(blue);
        }
#pragma unroll
        for (int r = 0; r < FWD_ROWS; ++r) {
          float w;
          if constexpr (MODE == NOTRANS) {
            cs[r] = cs[r] + (-a[r]);
            w = a[r] * (n[r] * (1.0f + cs[r]));
            sum[r] = sum[r] + a[r];
          } else {
            const float l = log1pf(-a[r]);
            sum[r] = sum[r] + l;
            if constexpr (MODE == NOCUMSUM) {
              w = a[r] * (n[r] * expf(l));
            } else if constexpr (MODE == LOWPREC) {
              cs[r] = cs[r] + bf16_round(l);
              w = bf16_round(a[r] * (n[r] * expf(cs[r])));
            } else {  // FULL
              cs[r] = cs[r] + l;
              const float n_incl = n[r] * expf(cs[r]);
              w = a[r] * (n_incl / (1.0f - a[r])) * (n_incl >= T_STOP ? 1.0f : 0.0f);
            }
          }
          wr[r] = wr[r] + red * w;
          wg[r] = wg[r] + green * w;
          wb[r] = wb[r] + blue * w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r) {
      if constexpr (MODE == ALPHA) {
        cr[r] = cr[r] + sum[r];
        cg[r] = cg[r] + sum[r];
        cb[r] = cb[r] + sum[r];
        n[r] = n[r] * 0.9999f;
      } else {
        cr[r] = cr[r] + wr[r];
        cg[r] = cg[r] + wg[r];
        cb[r] = cb[r] + wb[r];
        n[r] = MODE == NOTRANS ? n[r] * (1.0f - sum[r] * 1e-6f) : n[r] * expf(sum[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) {
    const int p = (row0 + r) * TILE + lane % TILE;
    o[p] = cr[r];
    o[PX + p] = cg[r];
    o[2 * PX + p] = cb[r];
  }
}

template <int MODE>
__global__ void __launch_bounds__(FWD_THREADS) kernel_ablate_kernel(
    const float* __restrict__ inst, long long rpad, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ x0,
    const int* __restrict__ y0, float* __restrict__ out) {
  const int tile = blockIdx.x;
  float* o = out + static_cast<long long>(tile) * 3 * PX;
  if constexpr (MODE == DMA) {
    dma_tile(inst, rpad, starts[tile], counts[tile], o);
  } else {
    mode_tile<MODE>(inst, rpad, starts[tile], counts[tile], x0[tile], y0[tile], o);
  }
}

template <int MODE>
void launch(const float* inst, long long rpad, const int* starts, const int* counts,
            const int* x0, const int* y0, int num_tiles, float* out,
            cudaStream_t stream) {
  kernel_ablate_kernel<MODE><<<num_tiles, FWD_THREADS, 0, stream>>>(
      inst, rpad, starts, counts, x0, y0, out);
}

}  // namespace

// mode: 0 dma, 1 alpha, 2 notrans, 3 nocumsum, 4 lowprec, 5 full.
extern "C" int omnigs_kernel_ablate(int mode, const void* inst, long long rpad,
                                    const void* starts, const void* counts,
                                    const void* x0, const void* y0, int num_tiles,
                                    void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return 0;
  auto* fn = launch<FULL>;
  switch (mode) {
    case DMA: fn = launch<DMA>; break;
    case ALPHA: fn = launch<ALPHA>; break;
    case NOTRANS: fn = launch<NOTRANS>; break;
    case NOCUMSUM: fn = launch<NOCUMSUM>; break;
    case LOWPREC: fn = launch<LOWPREC>; break;
    case FULL: break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  fn(static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
     static_cast<const int*>(counts), static_cast<const int*>(x0),
     static_cast<const int*>(y0), num_tiles, static_cast<float*>(out),
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

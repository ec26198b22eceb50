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
//   k, k < 128, whatever the count; before each chunk the tile goes on only
//   while c < n_chunks and max over its pixels of N >= 1e-4 (N = 1 at the
//   start). Per pixel (px, py) = (x0[t] + p % 16, y0[t] + p / 16) and lane
//   k, with kk = 128 c + k:
//     dx = x - px, dy = y - py, power = -0.5 (A dx dx + C dy dy) - B dx dy
//     alpha = min(0.99, op exp(min(power, 0)))
//     a = alpha if 0 <= kk < count, power <= 0 and alpha >= 1/255, else 0
//   and per chunk, with cs the inclusive prefix over the chunk's lanes:
//     dma      color += sum over lanes of rows x, y, A (the copy floor)
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
// Design. The TPU kernel packs TPB tiles into one program of a sequential
// grid and double-buffers 128-lane DMA windows. Here one 256-thread block
// takes one tile, one thread per pixel; each chunk's rows are staged in
// shared memory (coalesced loads, then broadcast reads), the stop test is a
// block vote (__syncthreads_or), and each thread walks the chunk's lanes in
// order: the prefix sums cs, the lane sums and the 3x128 . 128x256 color
// product are sequential per pixel in the kernel's own body (no library
// GEMM). Built with --fmad=false, so every mul/add rounds as the plain
// PyTorch version's elementwise ops do.
//
// Bound. Per visited lane-pixel pair ~17 fp32 operations for alpha and
// ~10-15 more for the compositing modes (a transcendental counted as one),
// against 36 bytes of device memory per staged lane (12 for dma), read
// once: every mode but dma is bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int NSTAGE = 9;  // x y A B C op r g b
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1.0e-4f;

enum Mode { DMA = 0, ALPHA = 1, NOTRANS = 2, NOCUMSUM = 3, LOWPREC = 4, FULL = 5 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__global__ void __launch_bounds__(PX) kernel_ablate_kernel(
    const float* __restrict__ inst, long long rpad, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ x0,
    const int* __restrict__ y0, float* __restrict__ out) {
  constexpr int kRows = MODE == DMA ? 3 : NSTAGE;
  __shared__ float s[kRows][CHUNK];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const long long start = starts[tile];
  const int count = counts[tile];
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  const float px = static_cast<float>(x0[tile] + tid % TILE);
  const float py = static_cast<float>(y0[tile] + tid / TILE);
  float n = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    // the stop vote is also the barrier before the staging overwrites s
    if (!__syncthreads_or(n >= T_STOP)) break;
    const long long base = start + static_cast<long long>(c) * CHUNK;
    for (int i = tid; i < kRows * CHUNK; i += PX) {
      const int q = i / CHUNK;
      const long long at = base + i % CHUNK;
      s[q][i % CHUNK] = at < rpad ? inst[q * rpad + at] : 0.0f;
    }
    __syncthreads();
    if constexpr (MODE == DMA) {
      float sr = 0.0f, sg = 0.0f, sb = 0.0f;
      for (int k = 0; k < CHUNK; ++k) {
        sr = sr + s[0][k];
        sg = sg + s[1][k];
        sb = sb + s[2][k];
      }
      cr = cr + sr;
      cg = cg + sg;
      cb = cb + sb;
    } else {
      float sum = 0.0f;  // of a (alpha, notrans) or of l (the others)
      float cs = 0.0f;   // inclusive lane prefix
      float wr = 0.0f, wg = 0.0f, wb = 0.0f;
      for (int k = 0; k < CHUNK; ++k) {
        const int kk = c * CHUNK + k;
        const float dx = s[0][k] - px;
        const float dy = s[1][k] - py;
        const float power = -0.5f * (s[2][k] * dx * dx + s[4][k] * dy * dy) - s[3][k] * dx * dy;
        const float alpha = fminf(s[5][k] * expf(fminf(power, 0.0f)), ALPHA_MAX);
        const bool live = kk >= 0 && kk < count && power <= 0.0f && alpha >= ALPHA_MIN;
        const float a = live ? alpha : 0.0f;
        if constexpr (MODE == ALPHA) {
          sum = sum + a;
          continue;
        }
        float w, r = s[6][k], g = s[7][k], b = s[8][k];
        if constexpr (MODE == NOTRANS) {
          cs = cs + (-a);
          w = a * (n * (1.0f + cs));
          sum = sum + a;
        } else {
          const float l = log1pf(-a);
          sum = sum + l;
          if constexpr (MODE == NOCUMSUM) {
            w = a * (n * expf(l));
          } else if constexpr (MODE == LOWPREC) {
            cs = cs + bf16_round(l);
            w = bf16_round(a * (n * expf(cs)));
            r = bf16_round(r);
            g = bf16_round(g);
            b = bf16_round(b);
          } else {  // FULL
            cs = cs + l;
            const float n_incl = n * expf(cs);
            w = a * (n_incl / (1.0f - a)) * (n_incl >= T_STOP ? 1.0f : 0.0f);
          }
        }
        wr = wr + r * w;
        wg = wg + g * w;
        wb = wb + b * w;
      }
      if constexpr (MODE == ALPHA) {
        cr = cr + sum;
        cg = cg + sum;
        cb = cb + sum;
        n = n * 0.9999f;
      } else {
        cr = cr + wr;
        cg = cg + wg;
        cb = cb + wb;
        n = MODE == NOTRANS ? n * (1.0f - sum * 1e-6f) : n * expf(sum);
      }
    }
  }
  float* o = out + static_cast<long long>(tile) * 3 * PX + tid;
  o[0] = cr;
  o[PX] = cg;
  o[2 * PX] = cb;
}

template <int MODE>
void launch(const float* inst, long long rpad, const int* starts, const int* counts,
            const int* x0, const int* y0, int num_tiles, float* out,
            cudaStream_t stream) {
  kernel_ablate_kernel<MODE>
      <<<num_tiles, PX, 0, stream>>>(inst, rpad, starts, counts, x0, y0, out);
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

// The per-tile compositing walks for Hopper (sm_90a) of the five
// compositing kernels: the segmented kernels composite_seg_fwd.cu (#1) /
// composite_seg_bwd.cu (#2) and the tile-major kernels composite_tile_fwd.cu
// (#3) / composite_tile_bwd.cu (#4 and the fused #5). A kernel only places
// its tile -- the pixel origin (tx0, ty0), the segment [start, start + n) of
// the (16, rpad) instance slab and the tile's index into the (T, ...) pixel
// arrays -- and calls fwd_walk, or bwd_walk with a sink for the rows (#2 and
// #4 write them at their lanes, #5 adds them into a per-Gaussian table).
// The per-pair arithmetic, its order and its rounding are those that
// composite.cuh states and of the plain PyTorch versions
// (composite_seg._walk_fwd_plain / _walk_bwd_plain), so every output bit of
// #1-#4 is theirs; what differs is which work is done.
//
// 1. Strip masks at staging. While a batch of instances is staged into
//    shared memory, the thread that loads instance j also decides, once, in
//    which horizontal strips of the tile (a warp's pixel rows) the instance
//    can hold a live pair (alpha >= 1/255 with power <= 0). A warp walks
//    only the instances whose bit it has: it takes 32 instances' bits with
//    one ballot and visits the set ones in order, so a dead instance costs it
//    nothing. The test is conservative (strip_mask below): a skipped pair is
//    dead under the kernels' own float arithmetic, so skipping it changes no
//    bit. It reads only the instance and the tile origin, so unaligned
//    segment starts and zero rows (mask 0: opacity 0) change nothing.
// 2. In the backward, the nine pixel sums of a warp by recursive halving
//    (warp_sum_halving): 12 shuffles an instance instead of nine butterflies
//    of five (45). Each addition pairs the same two values as the butterfly
//    (IEEE addition commutes), so the nine sums are the butterfly's bit for
//    bit; lane L ends with sum halving_slot(L).
// 3. In the forward, FWD_ROWS vertically adjacent pixels per thread: one
//    shared-memory read of an instance serves FWD_ROWS pairs, and the pairs'
//    transcendental chains are independent.
//
// Instances are staged as float4 (x, y, A, B), float4 (C, op, r, g) and b,
// so a warp reads an instance with two broadcast 16-byte loads.

#pragma once

#include <cuda_runtime.h>

#include "composite.cuh"

namespace omnigs_seg {

using omnigs_composite::ALPHA_MAX;
using omnigs_composite::ALPHA_MIN;
using omnigs_composite::BWD_BATCH;
using omnigs_composite::FULL;
using omnigs_composite::FWD_BATCH;
using omnigs_composite::NGRAD;
using omnigs_composite::NSTAGE;
using omnigs_composite::NWARP;
using omnigs_composite::PX;
using omnigs_composite::T_STOP;
using omnigs_composite::TILE;

constexpr int FWD_ROWS = 2;                   // pixel rows per forward thread
constexpr int FWD_THREADS = PX / FWD_ROWS;    // forward threads per tile
constexpr int FWD_STRIP = 2 * FWD_ROWS;       // pixel rows per forward warp
constexpr int BWD_STRIP = 2;                  // pixel rows per backward warp
constexpr int GROUPS = BWD_BATCH / 32;        // ballots per warp and batch

// Slack of the strip test (strip_mask): a live pair satisfies
// Q(dx, dy) <= tau + 10u + 4u S in float32, u = 2^-24, where Q = A dx^2 +
// 2B dx dy + C dy^2, tau = 2 ln(op / ALPHA_MIN), S <= kappa Q the sum of
// |terms| and kappa = (A + C)^2 / det. The test bounds Q by (max(tau, 0) +
// CULL_ABS) / (1 - CULL_REL kappa): four times the rounding term, and
// CULL_ABS far above 10u and the error of its own logf. It gives up (all
// strips) where CULL_REL kappa >= 1/2, and culls everything where tau <
// TAU_FLOOR, since power <= 0 means Q >= 0 there. The half-extents get
// CULL_PAD (relative, far above the float rounding of the test) and one
// pixel.
constexpr float CULL_REL = 16.0f * 5.9604644775390625e-08f;
constexpr float CULL_ABS = 1e-4f;
constexpr float TAU_FLOOR = -1e-5f;
constexpr float CULL_PAD = 1e-6f;
constexpr float LOG_ALPHA_MIN = -5.541263580322266f;  // logf(ALPHA_MIN)

// Bit s: pixel rows [ty0 + s H, ty0 + s H + H) x columns [tx0, tx0 + 16) may
// hold a live pair of the instance (x, y, A, B, C, op). In float32 (float64
// registers cost the kernels occupancy), except det = A C - B^2, which
// float32 would cancel; distances to the tile and the strips as gaps, whose
// rounding is relative.
template <int H>
__device__ __forceinline__ unsigned strip_mask(float x, float y, float A,
                                               float B, float C, float op,
                                               int tx0, int ty0) {
  constexpr unsigned ALL = (1u << (TILE / H)) - 1u;
  if (!(isfinite(x) && isfinite(y) && isfinite(A) && isfinite(B) &&
        isfinite(C) && isfinite(op))) {
    return ALL;  // a NaN opacity passes fminf as 0.99
  }
  if (!(op > 0.f)) return 0u;
  const float tau = 2.f * (logf(op) - LOG_ALPHA_MIN);
  if (tau < TAU_FLOOR) return 0u;
  const float det = static_cast<float>(static_cast<double>(A) * C -
                                       static_cast<double>(B) * B);
  if (!(A > 0.f && C > 0.f && det > 0.f)) return ALL;
  const float eps = CULL_REL * ((A + C) * (A + C) / det);
  if (!(eps < 0.5f)) return ALL;
  const float t = (fmaxf(tau, 0.f) + CULL_ABS) / (1.f - eps);
  const float hx = sqrtf(t * C / det) * (1.f + CULL_PAD) + 1.f;
  const float hy = sqrtf(t * A / det) * (1.f + CULL_PAD) + 1.f;
  const float lo_x = static_cast<float>(tx0);
  const float gap_x = fmaxf(fmaxf(lo_x - x, x - (lo_x + (TILE - 1))), 0.f);
  if (gap_x > hx) return 0u;
  unsigned m = 0u;
#pragma unroll
  for (int s = 0; s < TILE / H; ++s) {
    const float lo = static_cast<float>(ty0 + s * H);
    const float gap_y = fmaxf(fmaxf(lo - y, y - (lo + (H - 1))), 0.f);
    if (gap_y <= hy) m |= 1u << s;
  }
  return m;
}

// One batch of instances in shared memory.
template <int BATCH>
struct Stage {
  float4 geo[BATCH];     // x, y, A, B
  float4 opc[BATCH];     // C, opacity, r, g
  float blue[BATCH];     // b
  unsigned mask[BATCH];  // strip_mask
};

// Stages instances [first, first + m) of the (16, rpad) slab; strip height H.
template <int BATCH, int THREADS, int H>
__device__ __forceinline__ void stage_batch(Stage<BATCH>& s,
                                            const float* __restrict__ inst,
                                            long long rpad, long long first,
                                            int m, int tx0, int ty0) {
  for (int j = threadIdx.x; j < m; j += THREADS) {
    float v[NSTAGE];
#pragma unroll
    for (int r = 0; r < NSTAGE; ++r) v[r] = inst[r * rpad + first + j];
    s.geo[j] = make_float4(v[0], v[1], v[2], v[3]);
    s.opc[j] = make_float4(v[4], v[5], v[6], v[7]);
    s.blue[j] = v[8];
    s.mask[j] = strip_mask<H>(v[0], v[1], v[2], v[3], v[4], v[5], tx0, ty0);
  }
}

// Instances j0 .. j0 + 31 (below m) whose strip bit `strip` is set.
template <int BATCH>
__device__ __forceinline__ unsigned strip_ballot(const Stage<BATCH>& s,
                                                 int j0, int m, int strip,
                                                 int lane) {
  const int j = j0 + lane;
  return __ballot_sync(FULL, j < m && ((s.mask[j] >> strip) & 1u));
}

// What the forward walk carries for one pixel.
struct FwdPixel {
  float r, g, b;  // sum of rgb alpha N_excl over the composited instances
  float log_t;    // sum of log1p(-alpha) over them
};

// One forward pair, as composite.cuh states it. Returns true when
// the pixel stops here (its first live instance that fails the T test).
// With WANT_NC, nc takes k1 (the instance's index in the segment, plus 1)
// when the pair composites.
template <bool WANT_NC>
__device__ __forceinline__ bool fwd_pair(const float4 geo, const float4 opc,
                                         const float* blue, float px,
                                         float py, FwdPixel& o, int& nc,
                                         int k1) {
  const float dx = geo.x - px;
  const float dy = geo.y - py;
  const float power =
      -0.5f * (geo.z * dx * dx + opc.x * dy * dy) - geo.w * dx * dy;
  const float alpha = fminf(opc.y * expf(fminf(power, 0.f)), ALPHA_MAX);
  if (!(power <= 0.f && alpha >= ALPHA_MIN)) return false;
  const float l = log1pf(-alpha);
  const float n_excl = expf(o.log_t);
  if (!(n_excl * (1.f - alpha) >= T_STOP)) return true;
  const float w = alpha * n_excl;
  o.r += opc.z * w;
  o.g += opc.w * w;
  o.b += *blue * w;
  o.log_t += l;
  if constexpr (WANT_NC) nc = k1;
  return false;
}

// The forward walk of one tile, FWD_THREADS threads: composites instances
// [start, start + n) of the slab over the pixels (tx0 + p % 16, ty0 + p /
// 16) and writes color (T, 3, 256) and final_T = exp(log_T) (T, 256) at
// tile `out`; where ncontrib is given, n_contrib (T, 256), the last k + 1
// at which the pixel composited (WANT_NC), else zeros. A pixel stops at its
// first contribution failure, a warp once all its pixels have, the block
// once every pixel of the tile has.
template <bool WANT_NC>
__device__ __forceinline__ void fwd_walk(const float* __restrict__ inst,
                                         long long rpad, long long start,
                                         int n, int tx0, int ty0,
                                         long long out,
                                         float* __restrict__ color,
                                         float* __restrict__ final_t,
                                         int* __restrict__ ncontrib) {
  __shared__ Stage<FWD_BATCH> s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // rows row0 .. row0 + FWD_ROWS - 1 of the warp's strip, column lane % 16
  const int row0 = warp * FWD_STRIP + (lane / TILE) * FWD_ROWS;
  const float px = static_cast<float>(tx0 + lane % TILE);
  float py[FWD_ROWS];
  FwdPixel o[FWD_ROWS];
  bool done[FWD_ROWS];
  int nc[FWD_ROWS];
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r) {
    py[r] = static_cast<float>(ty0 + row0 + r);
    o[r] = FwdPixel{0.f, 0.f, 0.f, 0.f};
    done[r] = false;
    nc[r] = 0;
  }
  const auto all_done = [&done]() {
    bool all = true;
#pragma unroll
    for (int r = 0; r < FWD_ROWS; ++r) all = all && done[r];
    return all;
  };
  for (int base = 0; base < n; base += FWD_BATCH) {
    const int m = min(FWD_BATCH, n - base);
    stage_batch<FWD_BATCH, FWD_THREADS, FWD_STRIP>(s, inst, rpad, start + base,
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
            done[r] = fwd_pair<WANT_NC>(geo, opc, &s.blue[j], px, py[r], o[r],
                                        nc[r], base + j + 1);
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
    float* c = color + out * 3 * PX + p;
    c[0] = o[r].r;
    c[PX] = o[r].g;
    c[2 * PX] = o[r].b;
    final_t[out * PX + p] = expf(o[r].log_t);
    if (ncontrib != nullptr) ncontrib[out * PX + p] = WANT_NC ? nc[r] : 0;
  }
}

// One recursive-halving step over xor offset `off`: of the N values the
// lane holds, the lower lane of each pair keeps the first K = ceil(N / 2)
// and the upper lane the rest (at positions 0 ..), each adding its
// partner's copy; missing values travel as 0 and land in unused positions.
template <int N>
__device__ __forceinline__ void halve(float (&h)[NGRAD], int off,
                                      bool upper) {
  constexpr int K = (N + 1) / 2;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float lo = h[k];
    const float hi = K + k < N ? h[K + k < N ? K + k : 0] : 0.f;
    const float send = upper ? lo : hi;
    h[k] = (upper ? hi : lo) + __shfl_xor_sync(FULL, send, off);
  }
}

// The warp sums of h[0..8] over the 32 lanes, the butterfly's tree:
// afterwards lane halving_slot(lane)'s h[0] holds sum q = that slot.
__device__ __forceinline__ void warp_sum_halving(float (&h)[NGRAD],
                                                 int lane) {
  static_assert(NGRAD == 9, "the exchange below is unrolled for nine sums");
  halve<9>(h, 16, lane & 16);
  halve<5>(h, 8, lane & 8);
  halve<3>(h, 4, lane & 4);
  halve<2>(h, 2, lane & 2);
  halve<1>(h, 1, lane & 1);
}

// Which sum lane `lane` holds after warp_sum_halving, or -1 (lanes 0, 2, 4,
// 8, 10, 16, 18, 20, 24 hold sums 0..8).
__device__ __forceinline__ int halving_slot(int lane) {
  int base = 0, n = NGRAD, held = NGRAD;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int k = (n + 1) / 2;
    if (lane & off) {
      base += k;
      held = held > k ? held - k : 0;
    } else {
      held = held < k ? held : k;
    }
    n = k;
  }
  return held > 0 ? base : -1;
}

// Where the backward walk puts an instance's nine rows: called once per
// instance of the segment that the walk reached, by one thread, with the
// instance's slab lane `at`.
//
// LaneSink (kernels #2 and #4): the rows at their own lane of dinst (16,
// rpad). A lane belongs to one segment, so the block writes its lanes
// alone: no atomics, and the result is deterministic.
struct LaneSink {
  float* dinst;
  long long rpad;
  __device__ __forceinline__ void operator()(long long at,
                                             const float (&rows)[NGRAD]) const {
#pragma unroll
    for (int q = 0; q < NGRAD; ++q) dinst[q * rpad + at] = rows[q];
  }
};

// The backward walk of one tile, PX threads (one per pixel, a warp two
// rows): given color_full (T, 3, 256), the forward color with bg * final_T
// blended in, and dL = dL/dcolor_full (T, 3, 256) at tile `out`, hands the
// nine gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) of every
// instance of [start, start + n) to `sink` (composite.cuh states the math).
// One forward walk per pixel from the saved color_full (no reverse pass). A
// warp visits only the instances whose strip mask has its bit, and sums each
// visited instance's nine partials over its lanes by recursive halving;
// after each batch one thread per instance adds the eight warp sums in warp
// order (a warp that did not visit the instance, or had no composited pixel,
// adds 0). Once every pixel has stopped the walk ends: the instances after
// that batch reach no sink.
template <class Sink>
__device__ __forceinline__ void bwd_walk(const float* __restrict__ inst,
                                         long long rpad, long long start,
                                         int n, int tx0, int ty0,
                                         long long out,
                                         const float* __restrict__ color_full,
                                         const float* __restrict__ dcolor,
                                         const Sink sink) {
  __shared__ Stage<BWD_BATCH> s;
  // warp sums; the stride BWD_BATCH + 1 puts the nine writer lanes on nine
  // banks
  __shared__ float red[NWARP][NGRAD][BWD_BATCH + 1];
  __shared__ unsigned wrote[NWARP][GROUPS];  // which red entries were set
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float px = static_cast<float>(tx0 + tid % TILE);
  const float py = static_cast<float>(ty0 + tid / TILE);
  const int slot = halving_slot(lane);

  const long long pix = out * 3 * PX + tid;
  const float dlr = dcolor[pix];
  const float dlg = dcolor[pix + PX];
  const float dlb = dcolor[pix + 2 * PX];
  const float dl_cf = dlr * color_full[pix] + dlg * color_full[pix + PX] +
                      dlb * color_full[pix + 2 * PX];

  float s_log = 0.f;   // log of the transmittance before the next instance
  float wu_acc = 0.f;  // sum of w u over the composited instances so far
  bool done = false;
  for (int base = 0; base < n; base += BWD_BATCH) {
    const int m = min(BWD_BATCH, n - base);
    stage_batch<BWD_BATCH, PX, BWD_STRIP>(s, inst, rpad, start + base, m, tx0,
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
      sink(start + base + tid, rows);
    }
    // also the barrier before the next batch overwrites stage and red
    if (__syncthreads_count(!done) == 0) break;
  }
}

}  // namespace omnigs_seg

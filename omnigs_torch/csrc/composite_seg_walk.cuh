// The per-tile compositing walks of the segmented kernels for Hopper
// (sm_90a): composite_seg_fwd.cu (forward) and composite_seg_bwd.cu
// (backward). The per-pair arithmetic, its order and its rounding are those
// of composite.cuh (which the tile-major kernels still run) and of the plain
// PyTorch versions (composite_seg._walk_fwd_plain / _walk_bwd_plain), so
// every output bit is theirs; what differs is which work is done.
//
// 1. Strip masks at staging. While a batch of instances is staged into
//    shared memory, the thread that loads instance j also decides, once, in
//    which horizontal strips of the tile (a warp's pixel rows) the instance
//    can hold a live pair (alpha >= 1/255 with power <= 0). A warp walks
//    only the instances whose bit it has: it takes 32 instances' bits with
//    one ballot and visits the set ones in order, so a dead instance costs it
//    nothing. The test is conservative (strip_mask below): a skipped pair is
//    dead under the kernels' own float arithmetic, so skipping it changes no
//    bit.
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

// One forward pair, as composite.cuh's walk computes it. Returns true when
// the pixel stops here (its first live instance that fails the T test).
__device__ __forceinline__ bool fwd_pair(const float4 geo, const float4 opc,
                                         const float* blue, float px,
                                         float py, FwdPixel& o) {
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
  return false;
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

}  // namespace omnigs_seg

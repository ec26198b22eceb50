// The expansion of the packed tile binning, for Hopper (sm_90a): for every
// emission slot j of bin_instances_packed, the int64 sort key
// (tile << RANK_BITS) | depth rank of the (Gaussian, tile) instance the slot
// holds, or the dead key, in one pass over the slots.
//
// Replaces no TPU kernel: the JAX package (omnigs_tpu/ops/binning.py,
// bin_instances_packed) expands in XLA inside chunked while-loops over the
// live prefix, and the plain version (omnigs_torch/ops/binning.py,
// _expand_keys_plain) runs ~270 eager passes over all max_instances slots
// (the owner search, the row gathers, the superblock decode with its
// popcount steps, the per-tile alpha re-test): ~14.7 GB of device traffic
// at 2^22 slots and P = 524,288 for a result of 8 B a slot.
//
// Slot j, as the plain version computes it (P ranks in depth order; offsets
// and tiles the ranks' exclusive cumsum and emission budget, int32):
//   total = offsets[P-1] + tiles[P-1]; g = clamp(#{offsets <= j} - 1, 0,
//   P - 1), the owning rank, and local = j - offsets[g]; the row perm[g]'s
//   rect (x0, y0, x1, y1) gives the tile: under the cull (CULL) block b =
//   the (local / (sx sy))-th set bit of the mask (lo, hi) (_kth_set_bit's
//   five popcount steps), within = local % (sx sy), tx = x0 + (b % wb) sx +
//   within % sx, ty = y0 + (b / wb) sy + within / sx, kept iff tx < x1, ty <
//   y1 and the tile's box passes alpha_box.cuh's test at (px0, px0 + 15);
//   without it tx = x0 + local % w, ty = y0 + local / w, w = max(x1 - x0, 1).
//   tid = ty grid_x + tx - tile_lo must fall in [0, num_tiles). The key is
//   (tid << RANK_BITS) | g, with tid = num_tiles for a dead slot (j >= total,
//   outside the window, culled). Where the JAX functions bound their loops
//   to the live 2^16-slot chunks (max_instances a multiple of LIVE_CHUNK,
//   n_full > 1 chunks), every slot at or past bound = min(ceil(total /
//   LIVE_CHUNK), n_full) LIVE_CHUNK takes num_tiles << RANK_BITS.
// Integers wrap as int32 where the plain version's do (total, the chunk
// bound); the rest of the arithmetic is on non-negative values below 2^24,
// where C's division is PyTorch's floor division. The tile budget is the
// pre-cull's tiles_eff (csrc/precull.cu) or tiles_touched, never negative,
// so offsets do not decrease and a slot at or past total has owner P - 1.
//
// Design. Bound by bytes and latency: 8 B written a slot (33.6 MB at 2^22
// slots, ~10 us at 3.35 TB/s), the owners' rows read once (<= ~60 B a row)
// and the owner search. A block takes SLOTS consecutive slots, ITEMS a
// thread at stride THREADS, so a warp's stores cover 256 contiguous bytes.
// Slots past the live end need no search: a block wholly there writes the
// dead keys and returns. Otherwise two warps find the owners of the block's
// first and last live slot by a 32-way search of offsets (a warp probes 32
// points a round: four rounds of dependent loads at P = 2^19); the block
// stages that owner window's offsets in shared memory (STAGE of them) and
// each thread searches it, starting from its previous slot's owner. A
// window wider than the stage (long runs of ranks with no tiles between the
// live ones) falls back to a per-thread search of offsets over the same
// window in global memory. Neighbouring slots mostly share an owner, so a
// warp's row loads collapse to a few lines. No atomics: a replay reproduces
// bit for bit.

#include <cuda_runtime.h>

#include "alpha_box.cuh"
#include "cuda_error.cuh"

namespace {

constexpr int TILE = 16;            // tile edge in pixels (ops/preprocess.py TILE)
constexpr int RANK_BITS = 19;       // depth-rank bits of the key (ops/binning.py RANK_BITS)
constexpr int MASK_TILES = 64;      // pre-cull mask width (ops/binning.py MASK_TILES)
constexpr int LIVE_CHUNK = 65536;   // slots a live-bound chunk (ops/binning.py _LIVE_CHUNK)
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int SLOTS = THREADS * ITEMS;  // slots a block
constexpr int STAGE = 4096;             // owner offsets a block stages
constexpr unsigned FULL = 0xffffffffu;

static_assert(MASK_TILES == 64, "the mask is two 32-bit words");
static_assert(LIVE_CHUNK == 1 << 16, "the chunk count is a shift by 16");

// the inputs, each read through its element strides (index = row * stride)
struct Args {
  const int* off;    // (P,) exclusive cumsum of the budget, depth order
  const int* tiles;  // (P,) emission budget, depth order
  const int* perm;   // (P,) Gaussian row of each depth rank
  const int* rect;   // (rows, 4) x0, y0, x1, y1
  const int* lo;     // (rows,) pre-cull mask words and block geometry (CULL)
  const int* hi;
  const int* sx;
  const int* sy;
  const int* wb;
  const float* means;  // (rows, 2), conic (rows, 3), opacity (rows,) (CULL)
  const float* conic;
  const float* opac;
  long long s_off, s_tiles, s_perm, s_rect0, s_rect1, s_lo, s_hi, s_sx, s_sy, s_wb;
  long long s_means0, s_means1, s_conic0, s_conic1, s_opac;
  int P, n_slots, grid_x, num_tiles, tile_lo;
  int n_full;  // full live-bound chunks, 0 where no bound applies
};

// _kth_set_bit step for step: the k-th (0-based) set bit of (lo, hi) by five
// popcount halvings, so it gives the plain version's answer for every k
__device__ __forceinline__ int kth_set_bit(unsigned lo, unsigned hi, int k) {
  const int nlo = __popc(lo);
  const bool use_hi = k >= nlo;
  unsigned word = use_hi ? hi : lo;
  int kk = use_hi ? k - nlo : k;
  int b = use_hi ? 32 : 0;
#pragma unroll
  for (int shift = 16; shift >= 1; shift >>= 1) {
    const int cnt = __popc(word & ((1u << shift) - 1u));
    if (kk >= cnt) {
      word >>= shift;
      kk -= cnt;
      b += shift;
    }
  }
  return b;
}

// lo + #{off[i] <= j : lo <= i < hi} (off non-decreasing), by the whole warp:
// 32 probes a round, each the last entry of one of 32 equal parts of the
// span; the parts known <= j are skipped, the first that is not is searched
// next. Every lane returns the same count.
__device__ int warp_count_le(const Args& a, int lo, int hi, int j, int lane) {
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const long long probe = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool le = probe < hi && a.off[probe * a.s_off] <= j;
    const int parts = __popc(__ballot_sync(FULL, le));
    const int next = lo + parts * step;
    hi = min(hi, next + step - 1);
    lo = next;
  }
  return lo;
}

// lo + #{off[i] <= j : lo <= i < hi} by one thread, off in shared memory
__device__ __forceinline__ int count_le_staged(const int* s_off, int lo, int hi, int j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the same over off in global memory
__device__ __forceinline__ int count_le_global(const Args& a, int lo, int hi, int j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.off[mid * a.s_off] <= j) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the key of a slot below total and the bound: rank g, local its index in g's emission
template <bool CULL>
__device__ __forceinline__ long long live_key(const Args& a, int g, int local) {
  const long long row = a.perm[g * a.s_perm];
  const int* rr = a.rect + row * a.s_rect0;
  const int x0 = rr[0], y0 = rr[a.s_rect1], x1 = rr[2 * a.s_rect1], y1 = rr[3 * a.s_rect1];
  int tx, ty;
  bool keep = true;
  if (CULL) {
    const int sx = a.sx[row * a.s_sx], sy = a.sy[row * a.s_sy], wb = a.wb[row * a.s_wb];
    const int q = sx * sy;
    const int blk = local / q;
    const int within = local - blk * q;
    const int b = kth_set_bit(static_cast<unsigned>(a.lo[row * a.s_lo]),
                              static_cast<unsigned>(a.hi[row * a.s_hi]), blk);
    tx = x0 + (b % wb) * sx + within % sx;
    ty = y0 + (b / wb) * sy + within / sx;
    keep = tx < x1 && ty < y1;
  } else {
    const int width = max(x1 - x0, 1);
    tx = x0 + local % width;
    ty = y0 + local / width;
  }
  const int tid = ty * a.grid_x + tx - a.tile_lo;
  keep = keep && tid >= 0 && tid < a.num_tiles;
  if (CULL && keep) {
    const float mx = a.means[row * a.s_means0], my = a.means[row * a.s_means0 + a.s_means1];
    const float* cr = a.conic + row * a.s_conic0;
    const float px0 = static_cast<float>(tx * TILE), py0 = static_cast<float>(ty * TILE);
    const float edge = static_cast<float>(TILE - 1);
    const float qmin = alpha_box::min_quad_over_box(cr[0], cr[a.s_conic1], cr[2 * a.s_conic1],
                                                    px0 - mx, (px0 + edge) - mx, py0 - my,
                                                    (py0 + edge) - my);
    keep = alpha_box::alpha_reaches_min(a.opac[row * a.s_opac], qmin);
  }
  return (static_cast<long long>(keep ? tid : a.num_tiles) << RANK_BITS) | g;
}

template <bool CULL>
__global__ void __launch_bounds__(THREADS) expand_keys_kernel(const Args a,
                                                              long long* __restrict__ key) {
  __shared__ int s_off[STAGE];
  __shared__ int s_window[2];
  const int t = threadIdx.x;
  const int base = blockIdx.x * SLOTS;
  const int last_rank = a.P - 1;
  const long long dead = static_cast<long long>(a.num_tiles) << RANK_BITS;
  const long long dead_tail = dead | last_rank;  // the owner of a slot past total

  // total and the live-chunk bound as the plain version's int32 arithmetic
  // gives them (unsigned adds wrap where int32 would)
  const int total = static_cast<int>(static_cast<unsigned>(a.off[last_rank * a.s_off]) +
                                     static_cast<unsigned>(a.tiles[last_rank * a.s_tiles]));
  int bound = a.n_slots;
  if (a.n_full > 0) {
    // floor((total + LIVE_CHUNK - 1) / LIVE_CHUNK): an arithmetic shift
    const unsigned up = static_cast<unsigned>(total) + static_cast<unsigned>(LIVE_CHUNK - 1);
    bound = min(static_cast<int>(up) >> 16, a.n_full) * LIVE_CHUNK;
  }
  const int live_end = min(min(total, bound), a.n_slots);

  if (base >= live_end) {  // the dead tail: no search
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = base + i * THREADS + t;
      if (j < a.n_slots) key[j] = j < bound ? dead_tail : dead;
    }
    return;
  }

  // the owner window of the block's live slots [base, last]
  const int last = min(base + SLOTS, live_end) - 1;
  const int warp = t >> 5, lane = t & 31;
  if (warp < 2) {
    const int c = warp_count_le(a, 0, a.P, warp == 0 ? base : last, lane);
    if (lane == 0) s_window[warp] = min(max(c - 1, 0), last_rank);
  }
  __syncthreads();
  const int first = s_window[0];
  const int n = s_window[1] - first + 1;
  const bool staged = n <= STAGE;
  if (staged) {
    for (int i = t; i < n; i += THREADS) s_off[i] = a.off[(first + i) * a.s_off];
  }
  __syncthreads();

  int c = 0;  // #{window offsets <= the previous slot}: slots rise, so owners do
#pragma unroll 1
  for (int i = 0; i < ITEMS; ++i) {
    const int j = base + i * THREADS + t;
    if (j >= a.n_slots) break;
    long long k;
    if (j >= live_end) {
      k = j < bound ? dead_tail : dead;
    } else {
      c = staged ? count_le_staged(s_off, c, n, j)
                 : count_le_global(a, first + c, first + n, j) - first;
      const int g = min(max(first + c - 1, 0), last_rank);
      const int start = staged && g >= first ? s_off[g - first] : a.off[g * a.s_off];
      k = live_key<CULL>(a, g, j - start);
    }
    key[j] = k;
  }
}

}  // namespace

// ptrs: offsets, tiles, perm, rect, lo, hi, sx, sy, wb, means2d, conic,
// opacity (the cull's five and the three float rows unread without it);
// strides: their element strides in that order, rect, means2d and conic two
// each (15); key: the (n_slots,) int64 output. n_full: the live-bound chunk
// count, 0 for none; cull: 1 for the superblock decode and the alpha test.
extern "C" int omnigs_expand_keys(const void* const* ptrs, const long long* strides, int P,
                                  int n_slots, int grid_x, int num_tiles, int tile_lo, int n_full,
                                  int cull, void* key, int device, void* stream) {
  if (n_slots <= 0 || P <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.off = static_cast<const int*>(ptrs[0]);
  a.tiles = static_cast<const int*>(ptrs[1]);
  a.perm = static_cast<const int*>(ptrs[2]);
  a.rect = static_cast<const int*>(ptrs[3]);
  a.lo = static_cast<const int*>(ptrs[4]);
  a.hi = static_cast<const int*>(ptrs[5]);
  a.sx = static_cast<const int*>(ptrs[6]);
  a.sy = static_cast<const int*>(ptrs[7]);
  a.wb = static_cast<const int*>(ptrs[8]);
  a.means = static_cast<const float*>(ptrs[9]);
  a.conic = static_cast<const float*>(ptrs[10]);
  a.opac = static_cast<const float*>(ptrs[11]);
  long long* s[] = {&a.s_off, &a.s_tiles, &a.s_perm, &a.s_rect0, &a.s_rect1,
                    &a.s_lo,  &a.s_hi,    &a.s_sx,   &a.s_sy,    &a.s_wb,
                    &a.s_means0, &a.s_means1, &a.s_conic0, &a.s_conic1, &a.s_opac};
  for (int i = 0; i < 15; ++i) *s[i] = strides[i];
  a.P = P;
  a.n_slots = n_slots;
  a.grid_x = grid_x;
  a.num_tiles = num_tiles;
  a.tile_lo = tile_lo;
  a.n_full = n_full;
  const unsigned blocks = static_cast<unsigned>((n_slots + SLOTS - 1) / SLOTS);
  auto* out = static_cast<long long*>(key);
  auto* st = static_cast<cudaStream_t>(stream);
  if (cull) {
    expand_keys_kernel<true><<<blocks, THREADS, 0, st>>>(a, out);
  } else {
    expand_keys_kernel<false><<<blocks, THREADS, 0, st>>>(a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

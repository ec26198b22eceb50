// Tile-major front-to-back alpha compositing, backward, for Hopper
// (sm_90a): two kernels on one walk, each with its own sink for the rows.
//
// omnigs_composite_tile_bwd replaces the TPU kernel
// omnigs_tpu/ops/pallas_raster.py::_bwd_kernel (with _bwd_tile and
// _bwd_chunk_math; launched by composite_pallas_bwd). Same function: nine
// gradient rows dL/d(x, y, A, B, C, opacity, r, g, b) at each lane of each
// tile's compact-layout segment of dinst (16, rpad), zeros everywhere else
// (the wrapper allocates them) — the TPU result after its merge of the
// per-tile heads. It places its tile (origin x0/y0, segment from starts)
// and runs the segmented backward kernel's walk (composite_seg_walk.cuh,
// bwd_walk) with its lane sink.
//
// omnigs_composite_tile_bwd_fused replaces _bwd_kernel_fused (launched by
// composite_pallas_bwd_fused): the same rows, summed per ids[lane] (the
// depth rank under a depth presort) into row id of a (p, 16) table, which
// the wrapper zeroes (the TPU kernel's own table is (P, 16), of which its
// wrapper keeps the first nine columns; so does this one's). It runs the same
// walk with a table sink (TableSink below).
//
// Design. The TPU kernel writes each tile's first 128-lane chunk, which a
// neighbouring tile may share in the unaligned layout, to a private "heads"
// array and merges it by a scatter-add afterwards; it forms the pixel sums
// as moments on the MXU. Here one block per tile owns exactly its segment's
// lanes, so the unfused kernel writes them directly: no heads, no merge, no
// atomics, and the output is deterministic. The walk skips the
// warp-instance pairs whose strip mask lacks the warp's bit and sums each
// visited instance's nine partials by recursive halving (12 shuffles, not
// 45). The TPU fused kernel keeps the (P, 16) table in on-chip memory across
// a sequential grid; blocks here run in parallel, so each instance's nine
// tile-summed rows go to device memory with atomics: no per-instance
// gradient slab and no reduction pass. A table row is 64 bytes, 16-byte
// aligned, so the nine rows take two float4 atomics, (x, y, A, B) and (C,
// op, r, g), and one float atomic for b: three L2 reductions within one
// 64-byte segment, where a (p, 9) table's 36-byte rows took nine. An
// instance whose rows are all zero (no pixel composited it) adds nothing,
// which changes no value of the sums. The order of the float additions into
// a Gaussian's row changes from run to run, so its sums are not bitwise
// repeatable. The caller takes the fused route only where the JAX package
// does (fused_reduce=True, no emission payload, P <= 163,840).
//
// Bound. Per visited pixel-instance pair the forward's ~17 fp32 operations;
// per composited pair ~39 more (transmittance, dL/dalpha with one division,
// nine partials and their warp sums); per instance 72 for the warp sums and
// the rows (+ 9 atomic adds fused). Device memory is read once (9 floats per
// instance, 6 per pixel) and written once (9 floats per instance plus the
// zero fill of the output, or the table): bound by operations, like the
// forward.

#include "composite_seg_walk.cuh"

namespace {

using namespace omnigs_seg;

constexpr int TABLE_COLS = 16;  // fused table row: x y A B | C op r g | b

// Adds the nine rows into one 16-byte-aligned table row.
__device__ __forceinline__ void add_row(float* row,
                                        const float (&v)[NGRAD]) {
  float4* row4 = reinterpret_cast<float4*>(row);
  atomicAdd(row4, make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(row4 + 1, make_float4(v[4], v[5], v[6], v[7]));
  atomicAdd(row + 8, v[8]);
}

// Kernel #5's sink: the rows of slab lane `at` into row ids[at] of the (p,
// TABLE_COLS) table, for 0 <= id < p (lanes past n_ids have none).
struct TableSink {
  const int* ids;
  long long n_ids;
  int p;
  float* table;
  __device__ __forceinline__ void operator()(long long at,
                                             const float (&rows)[NGRAD]) const {
    bool zero = true;
#pragma unroll
    for (int q = 0; q < NGRAD; ++q) zero = zero && rows[q] == 0.f;
    if (zero) return;  // adding +-0 changes no value of the table
    const int id = at < n_ids ? ids[at] : -1;
    if (id < 0 || id >= p) return;
    add_row(table + static_cast<long long>(id) * TABLE_COLS, rows);
  }
};

__global__ void __launch_bounds__(PX) composite_tile_bwd_kernel(
    const float* __restrict__ inst, long long rpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ x0, const int* __restrict__ y0,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    float* __restrict__ dinst) {
  const int tile = blockIdx.x;
  bwd_walk(inst, rpad, starts[tile], counts[tile], x0[tile], y0[tile], tile,
           color_full, dcolor, LaneSink{dinst, rpad});
}

__global__ void __launch_bounds__(PX) composite_tile_bwd_fused_kernel(
    const float* __restrict__ inst, long long rpad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ x0, const int* __restrict__ y0,
    const float* __restrict__ color_full, const float* __restrict__ dcolor,
    const int* __restrict__ ids, long long n_ids, int p,
    float* __restrict__ table) {
  const int tile = blockIdx.x;
  bwd_walk(inst, rpad, starts[tile], counts[tile], x0[tile], y0[tile], tile,
           color_full, dcolor, TableSink{ids, n_ids, p, table});
}

}  // namespace

extern "C" int omnigs_composite_tile_bwd(
    const void* inst, long long rpad, const void* starts, const void* counts,
    const void* x0, const void* y0, const void* color_full,
    const void* dcolor, int num_tiles, void* dinst, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tile_bwd_kernel<<<num_tiles, PX, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<const float*>(color_full),
      static_cast<const float*>(dcolor), static_cast<float*>(dinst));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int omnigs_composite_tile_bwd_fused(
    const void* inst, long long rpad, const void* ids, long long n_ids,
    const void* starts, const void* counts, const void* x0, const void* y0,
    const void* color_full, const void* dcolor, int num_tiles, int p,
    void* table, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tile_bwd_fused_kernel<<<num_tiles, PX, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), rpad, static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<const float*>(color_full),
      static_cast<const float*>(dcolor), static_cast<const int*>(ids), n_ids,
      p, static_cast<float*>(table));
  return static_cast<int>(cudaGetLastError());
}

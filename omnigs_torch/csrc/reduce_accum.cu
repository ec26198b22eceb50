// Instance -> Gaussian accumulation of gradient rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/reduce_bench.py::_reduce_kernel (launched
// by pallas_reduce), the streaming-accumulate strategy of the reduction
// bench. Same function:
//
//   acc (16, P) f32 = 0;  acc[:, ids[j]] += rows[:, j]  for j < live
//
// with ids (live,) int32 in [0, P) and rows (16, R) f32, R >= live (row r
// of instance j at rows[r * R + j]). Ids outside [0, P) are skipped.
//
// Design. The TPU kernel keeps the (16, P) table in VMEM and walks the
// instances in order on one core, double-buffering 128-lane windows by DMA.
// Hopper has no core that sees every instance in order, and the table (8 MB
// at P = 2^17) does not fit a block's shared memory, so the sums are taken
// with atomics in L2 (the result is unused, so atomicAdd compiles to a
// reduction, RED). Two kernels:
//
// 1. Accumulate. A warp takes 32 consecutive instances at a time in a
//    grid-stride loop, loads their 16 values (neighbouring lanes read
//    neighbouring columns of each row: coalesced) and adds them into a
//    Gaussian-major (P, 16) scratch table, which the wrapper zeroes, with
//    four float4 atomics: four L2 operations within one 64-byte segment. In
//    the (16, P) table one Gaussian's 16 values lie P * 4 bytes apart, so
//    the same adds took 16 scalar atomics on 16 different cache lines. The
//    adds to one row serialize in its L2 slice, so where a warp's ids repeat
//    (skewed ids: one Gaussian in many of the warp's instances) the lanes of
//    one id first sum their values by shuffles (__match_any_sync) and one
//    of them adds the sum.
// 2. Transpose. A block takes TG Gaussians: it reads their TG * 16
//    consecutive floats of the scratch table (float4 loads, coalesced) into
//    a shared-memory tile and writes 16 runs of TG consecutive floats of the
//    (16, P) output (coalesced), guarding the ragged edge at P.
//
// The sums are taken in no fixed order, so two runs may differ in the last
// bits: the port's production reduction stays the deterministic
// `_reduce_rows`, and this kernel is held against a float64 sum.
//
// Bound. Device memory: each of the 16 rows read once (64 B per instance),
// the ids (4 B per instance) and the table written once (64 B per
// Gaussian); 16 additions per instance. The scratch table adds a zero fill,
// a read and a write of 64 B per Gaussian.

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int NROWS = 16;
constexpr int THREADS = 256;
constexpr int TG = 128;  // Gaussians per transpose block
constexpr unsigned FULL = 0xffffffffu;

// Adds instance values v into one 64-byte scratch row.
__device__ __forceinline__ void add_row(float* row, const float (&v)[NROWS]) {
  float4* row4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int k = 0; k < NROWS / 4; ++k) {
    atomicAdd(row4 + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                    v[4 * k + 3]));
  }
}

// Lanes whose ids are equal (peers, one of them the lowest: the leader):
// the leader adds its peers' values to its own, in lane order.
__device__ __forceinline__ void combine_peers(float (&v)[NROWS], unsigned peers,
                                              int lane) {
  const bool leader = lane == __ffs(peers) - 1;
  const unsigned most = __reduce_max_sync(FULL, __popc(peers));
  unsigned rest = peers & (peers - 1);  // the peers after the leader
  for (unsigned t = 1; t < most; ++t) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int q = 0; q < NROWS; ++q) {
      const float x = __shfl_sync(FULL, v[q], src);
      if (leader && rest) v[q] += x;
    }
    rest &= rest - 1;
  }
}

__global__ void __launch_bounds__(THREADS) reduce_accum_kernel(
    const int* __restrict__ ids, const float* __restrict__ rows, long long r,
    long long live, int p, float* __restrict__ scratch) {
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // a warp takes 32 consecutive instances per step, all lanes together, so
  // that it can match their ids
  for (long long j0 = static_cast<long long>(blockIdx.x) * THREADS +
                      (threadIdx.x - lane);
       j0 < live; j0 += stride) {
    const long long j = j0 + lane;
    int g = j < live ? ids[j] : -1;
    if (g >= p) g = -1;
    float v[NROWS];
#pragma unroll
    for (int q = 0; q < NROWS; ++q) v[q] = g >= 0 ? rows[q * r + j] : 0.f;
    // where ids repeat within the warp, one lane adds the group's sum: the
    // adds to a hot Gaussian's row serialize in one L2 slice
    const unsigned peers = __match_any_sync(FULL, g);
    if (__any_sync(FULL, g >= 0 && __popc(peers) > 1)) {
      combine_peers(v, peers, lane);
    }
    if (g >= 0 && lane == __ffs(peers) - 1) {
      add_row(scratch + static_cast<long long>(g) * NROWS, v);
    }
  }
}

// scratch (P, 16) -> acc (16, P), TG Gaussians per block.
__global__ void __launch_bounds__(THREADS) reduce_transpose_kernel(
    const float* __restrict__ scratch, int p, float* __restrict__ acc) {
  // tile[g][c]; the stride NROWS + 1 puts the TG reads of one column on
  // distinct banks
  __shared__ float tile[TG][NROWS + 1];
  const long long g0 = static_cast<long long>(blockIdx.x) * TG;
  const int n = static_cast<int>(min(static_cast<long long>(TG), p - g0));
  const float4* src = reinterpret_cast<const float4*>(scratch + g0 * NROWS);
  for (int k = threadIdx.x; k < n * (NROWS / 4); k += THREADS) {
    const float4 v = src[k];
    float* dst = &tile[k / (NROWS / 4)][(k % (NROWS / 4)) * 4];
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NROWS * TG; k += THREADS) {
    const int c = k / TG;
    const int g = k % TG;
    if (g < n) acc[static_cast<long long>(c) * p + g0 + g] = tile[g][c];
  }
}

}  // namespace

// scratch (P, 16) must hold zeros on entry (the wrapper allocates it with
// torch.zeros); every value of acc (16, P) is written.
extern "C" int omnigs_reduce_accum(const void* ids, const void* rows, long long r,
                                   long long live, int p, void* scratch, void* acc,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (live > 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    // enough blocks to fill every SM several times over, no more than the
    // instances need
    long long blocks = (live + THREADS - 1) / THREADS;
    const long long most = static_cast<long long>(sms) * 16;
    if (blocks > most) blocks = most;
    reduce_accum_kernel<<<static_cast<int>(blocks), THREADS, 0, s>>>(
        static_cast<const int*>(ids), static_cast<const float*>(rows), r, live, p,
        static_cast<float*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tblocks = (static_cast<long long>(p) + TG - 1) / TG;
  reduce_transpose_kernel<<<static_cast<int>(tblocks), THREADS, 0, s>>>(
      static_cast<const float*>(scratch), p, static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}

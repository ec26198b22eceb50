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
// at P = 2^17) does not fit a block's shared memory, so each thread takes
// instances in a grid-stride loop and adds its 16 values straight into the
// table in device memory with float atomics (reductions in L2: the result
// is unused, so atomicAdd compiles to RED). Neighbouring threads read
// neighbouring columns of each row: the row loads are coalesced. The sums
// are taken in no fixed order, so two runs may differ in the last bits:
// the port's production reduction stays the deterministic `_reduce_rows`,
// and this kernel is held against a float64 sum.
//
// Bound. Device memory: each of the 16 rows read once (64 B per instance),
// the ids (4 B per instance) and the table written once (64 B per
// Gaussian); ~16 atomics per instance, each one operation.

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int NROWS = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) reduce_accum_kernel(
    const int* __restrict__ ids, const float* __restrict__ rows, long long r,
    long long live, int p, float* __restrict__ acc) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       j < live; j += stride) {
    const int g = ids[j];
    if (g < 0 || g >= p) continue;
    float v[NROWS];
#pragma unroll
    for (int q = 0; q < NROWS; ++q) v[q] = rows[q * r + j];
#pragma unroll
    for (int q = 0; q < NROWS; ++q) atomicAdd(acc + static_cast<long long>(q) * p + g, v[q]);
  }
}

}  // namespace

// acc must hold zeros on entry (the wrapper allocates it with torch.zeros).
extern "C" int omnigs_reduce_accum(const void* ids, const void* rows, long long r,
                                   long long live, int p, void* acc, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (live <= 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks to fill every SM several times over, no more than the
  // instances need
  long long blocks = (live + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * 16;
  if (blocks > most) blocks = most;
  reduce_accum_kernel<<<static_cast<int>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(rows), r, live, p,
      static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// Block-local permuted row emit, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/bucket_emit_bench.py::_emit_kernel
// (launched by emit), the best case of a bucketed counting sort: every
// instance writes its 16-float row straight to a data-dependent slot inside
// its own block of K rows. Same function:
//
//   out[b K + slots[b K + j]] = data[b K + j]   for every block b, j < K
//
// with slots (R,) int32 a permutation of 0..K-1 inside each block, data and
// out (R, 16) f32. Slots outside [0, K) are skipped (their rows of out are
// then left as the caller allocated them).
//
// Design. The TPU kernel walks each block's rows one by one in VMEM,
// because Mosaic has no vector path for a data-dependent slot. Here four
// neighbouring threads move one row, each one 16-byte piece: a warp loads
// 512 contiguous bytes (eight rows) and stores eight whole 64-byte rows, so
// every 32-byte sector it writes is written whole by one instruction. A
// block's destinations all lie in its own 128 KB window of out. The
// function is a copy: the output equals the index assignment of the plain
// version bit for bit.
//
// Bound. Device memory: data read once (64 B per row), slots read once
// (4 B per row), out written once (64 B per row); no arithmetic to speak
// of.

#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) bucket_emit_kernel(
    const int* __restrict__ slots, const float4* __restrict__ data, long long r,
    int k, float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long j = i / 4;  // the row; i % 4 its 16-byte piece
  if (j >= r) return;
  const int s = slots[j];
  if (s < 0 || s >= k) return;
  out[(j / k * k + s) * 4 + i % 4] = data[i];
}

}  // namespace

extern "C" int omnigs_bucket_emit(const void* slots, const void* data, long long r,
                                  int k, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r <= 0) return 0;
  const long long blocks = (4 * r + THREADS - 1) / THREADS;
  bucket_emit_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slots), static_cast<const float4*>(data), r, k,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Stage marks: one one-thread kernel per stage of the port's stage table
// (omnigs_torch/utils/profiling.py `STAGES`, in the same order), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package times its stages outside its
// programs. A mark is launched on the current stream between the work of
// two stages, so it runs where the stream reaches that boundary, also
// inside a captured CUDA graph, whose replay is one host call. Its name
// (`stage_mark_<stage>`) finds the boundary in a profiler's device trace;
// its body keeps the same boundaries on the card's own clock:
//
//   now = %globaltimer
//   if a stage is open: ns[open] += now - clock; entries[open] += 1
//   clock = now; open = this stage (none after `end`)
//
// in an int64 table of the layout [clock, open + 1, ns[S], entries[S]]
// that the caller allocates once per device and never moves (a captured
// graph bakes in its address). One thread, one stream: the marks of a
// stream run in order, so the read-modify-write needs no atomics.
//
// Bound: launch latency; ~40 bytes of device memory a mark.

#include <cuda_runtime.h>

#include "cuda_error.cuh"

// the stage table, in the order of profiling.STAGES
#define OMNIGS_STAGES(X)                                                     \
  X(window) X(preprocess) X(bin) X(relay) X(composite_fwd) X(loss)           \
  X(composite_bwd) X(preprocess_bwd) X(allreduce) X(adam) X(densify)         \
  X(reset) X(end)

namespace {

#define OMNIGS_STAGE_ENUM(name) STAGE_##name,
enum Stage { OMNIGS_STAGES(OMNIGS_STAGE_ENUM) NUM_STAGES };
#undef OMNIGS_STAGE_ENUM

__device__ __forceinline__ void stage_mark(long long* table, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long open = table[1];
  if (open > 0) {
    table[2 + open - 1] += static_cast<long long>(now) - table[0];
    table[2 + NUM_STAGES + open - 1] += 1;
  }
  table[0] = static_cast<long long>(now);
  table[1] = stage == STAGE_end ? 0 : stage + 1;
}

}  // namespace

// unmangled names: the trace shows `stage_mark_<stage>` as it is
#define OMNIGS_STAGE_KERNEL(name)                                            \
  extern "C" __global__ void stage_mark_##name(long long* table) {          \
    stage_mark(table, STAGE_##name);                                         \
  }
OMNIGS_STAGES(OMNIGS_STAGE_KERNEL)
#undef OMNIGS_STAGE_KERNEL

#define OMNIGS_STAGE_POINTER(name) stage_mark_##name,
static void (*const STAGE_KERNELS[NUM_STAGES])(long long*) = {
    OMNIGS_STAGES(OMNIGS_STAGE_POINTER)};
#undef OMNIGS_STAGE_POINTER

extern "C" int omnigs_stage_mark(int stage, void* table, int device, void* stream) {
  if (stage < 0 || stage >= NUM_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&table};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(STAGE_KERNELS[stage]), dim3(1),
                         dim3(1), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

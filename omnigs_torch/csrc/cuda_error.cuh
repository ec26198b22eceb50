// The launchers' error text, one per built library: every csrc/*.cu includes
// this header once, and omnigs_torch/cuda_build.py reads the text of a
// launcher's nonzero return code through it.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* omnigs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The one C entry point every kernel library exports beside its launcher:
// the text of a CUDA error code (kernels/cuda.py raises with it).  Each
// source is its own shared library, so each includes this once.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared by every kernel library: the C error-string export the ctypes
// binding (kernels/_build.py) reads when an entry point returns non-zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Shared by every kernel library: the C error-string export the ctypes
// binding (kernels/_build.py) reads when an entry point returns non-zero,
// and the warp reductions and exponential of the attention kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // finite mask value, as the reference's

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exp(x) rounded once to f32 from the f64 exponential: the value the
// plain versions compute as ``torch.exp(x.double()).float()``.
__device__ __forceinline__ float exp_f64(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}

}  // namespace

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

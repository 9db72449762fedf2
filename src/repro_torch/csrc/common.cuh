// Shared by every kernel library: the C error-string export the ctypes
// binding (kernels/_build.py) reads when an entry point returns non-zero,
// the exponential of the attention kernels, and the cp.async helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // finite mask value, as the reference's

// exp(x) rounded once to f32 from the f64 exponential: the value the
// plain versions compute as ``torch.exp(x.double()).float()``.
__device__ __forceinline__ float exp_f64(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; with valid
// false the destination is zero-filled and nothing is read
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

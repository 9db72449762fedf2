// On-the-fly activation quantization (the FMPQ runtime step).
//
// Replaces repro/kernels/act_quant.py: act_quant_int4 (_act_quant4_kernel)
// and act_quant_int8 (_act_quant8_kernel).
//
// For each (row, 128-channel block): scale = max(absmax, 1e-8) / qmax,
// q = clip(rint(x / scale)) — round half to even, IEEE division, so the
// codes match the reference byte for byte. int4 codes are stored +8 and
// packed in the location-switch layout: byte j = ch j | ch (j+64) << 4.
//
// Bound on the H100: bytes (read 4 B/elem of f32, write 0.5 or 1 B/elem; a
// handful of flops per element). Design: one warp per (row, block), each
// lane one float4 — a fully coalesced 512-byte read; the absmax is a
// 5-step shuffle reduction; for int4 the high-half channels arrive from
// lane + 16 by one shuffle, so lanes 0..15 each store one 32-bit word.
#include "common.cuh"

namespace {

constexpr int BLOCK_K = 128;
constexpr int WARPS = 8;   // warps per thread block, one (row, block) each

template <int BITS>
__global__ void __launch_bounds__(WARPS * 32) act_quant_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ out,
    float* __restrict__ scale, int m, int nb) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (item >= static_cast<long>(m) * nb) return;
  const long row = item / nb;
  const int b = static_cast<int>(item % nb);
  const long k = static_cast<long>(nb) * BLOCK_K;

  const float4 v = reinterpret_cast<const float4*>(
      x + row * k + static_cast<long>(b) * BLOCK_K)[lane];
  float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                     fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));

  constexpr float QMAX = BITS == 4 ? 7.0f : 127.0f;
  constexpr float QMIN = BITS == 4 ? -8.0f : -128.0f;
  const float s = fmaxf(amax, 1e-8f) / QMAX;
  const float xs[4] = {v.x, v.y, v.z, v.w};
  int q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = static_cast<int>(fminf(fmaxf(rintf(xs[i] / s), QMIN), QMAX));

  if (BITS == 8) {
    reinterpret_cast<char4*>(out + row * k + static_cast<long>(b) * BLOCK_K)[lane] =
        make_char4(static_cast<signed char>(q[0]), static_cast<signed char>(q[1]),
                   static_cast<signed char>(q[2]), static_cast<signed char>(q[3]));
  } else {
    uint32_t u = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) u |= static_cast<uint32_t>(q[i] + 8) << (8 * i);
    // lane l < 16 holds channels 4l..4l+3, lane l+16 channels 64+4l..
    const uint32_t hi = __shfl_down_sync(0xffffffffu, u, 16);
    if (lane < 16) {
      // every byte of u and hi is <= 15, so a 4-bit shift of the word
      // moves each byte's nibble into the same byte's high half
      reinterpret_cast<uint32_t*>(
          out + row * (k / 2) + static_cast<long>(b) * (BLOCK_K / 2))[lane] =
          u | (hi << 4);
    }
  }
  if (lane == 0) scale[row * nb + b] = s;
}

template <int BITS>
int launch(const float* x, uint8_t* out, float* scale, int m, int k,
           cudaStream_t stream) {
  const int nb = k / BLOCK_K;
  const long items = static_cast<long>(m) * nb;
  if (items > 0) {
    const unsigned grid = static_cast<unsigned>((items + WARPS - 1) / WARPS);
    act_quant_kernel<BITS><<<grid, WARPS * 32, 0, stream>>>(x, out, scale, m, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: f32 [m, k] contiguous, k % 128 == 0 → packed uint8 [m, k/2], f32 [m, k/128]
extern "C" int act_quant_int4(const float* x, uint8_t* packed, float* scale,
                              int m, int k, cudaStream_t stream) {
  return launch<4>(x, packed, scale, m, k, stream);
}

// x: f32 [m, k] contiguous → int8 [m, k], f32 [m, k/128]
extern "C" int act_quant_int8(const float* x, int8_t* q, float* scale, int m,
                              int k, cudaStream_t stream) {
  return launch<8>(x, reinterpret_cast<uint8_t*>(q), scale, m, k, stream);
}

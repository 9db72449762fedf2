// On-the-fly activation quantization (the FMPQ runtime step): both channel
// ranges of one W4Ax activation in one launch — channels [0, k4) to
// packed int4, [k4, k) to int8, each with one f32 scale per 128-block.
//
// Replaces repro/kernels/act_quant.py: act_quant_int4 (:52,
// _act_quant4_kernel) and act_quant_int8 (:82, _act_quant8_kernel). Each
// is this kernel with the other range empty (k4 = k, k4 = 0).
//
// For each (row, 128-channel block): scale = max(absmax, 1e-8) / qmax,
// q = clip(rint(x / scale)) — IEEE division (__fdiv_rn), round half to
// even (rintf), so the codes match the reference byte for byte. The input
// is bf16 or f32 and is upcast in registers; bf16 → f32 is exact, so the
// codes are those of the reference's x.astype(f32). int4 codes are stored
// +8 and packed in the location-switch layout: byte j = ch j | ch (j+64)
// << 4.
//
// Bound on the H100: bytes (read 2 or 4 B/elem, write 0.5 or 1 B/elem and
// a scale per block; a handful of operations per element) and, at the
// decode path's M (a few rows), the launch itself. Design: one launch per
// activation covers both ranges and reads x where it lies (any row stride,
// no f32 copy). One half-warp per (row, block): each lane holds 8
// channels from one 16-byte read-only load (two for f32), so a block is
// one coalesced read; the absmax is a 4-step xor shuffle inside the
// half-warp. For int4 the partners j+64 of lane l's channels sit in lane
// l+8, one 64-bit __shfl_down_sync away, so lanes 0..7 each store 8
// packed bytes (the block's 64 bytes in one coalesced store); int8 lanes
// store 8 bytes each. A warp takes two consecutive blocks of one row.
// Grid: 128-thread blocks, at most 16 resident per SM (the SM's 2,048
// threads, so __launch_bounds__ keeps a thread at 32 registers) × 132 SMs:
// one wave fills the card at M = 256, K = 14,336 (14,336 warp items, at
// most 2 a warp through the grid-stride loop), and at the decode path's M
// every (row, block) pair has its own half-warp from the start. No shared
// memory, TMA or wgmma: a single streaming pass has nothing to stage or
// reuse.
#include "common.cuh"

namespace {

constexpr int BLOCK_K = 128;
constexpr int WARPS = 4;                // warps per thread block
constexpr int BLOCKS_PER_SM = 16;       // 2,048 threads / 128
constexpr long MAX_GRID = 132L * BLOCKS_PER_SM;   // one wave on the H100

// 8 consecutive channels → f32 (bf16 is the top half of an f32: exact)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const uint16_t* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // little-endian: even channel low
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32, BLOCKS_PER_SM)
act_quant_w4ax_kernel(const T* __restrict__ x, long row_stride, int m,
                      int nb, int nb4, uint8_t* __restrict__ a4,
                      float* __restrict__ s4, int8_t* __restrict__ a8,
                      float* __restrict__ s8) {
  const int lane = threadIdx.x & 31;
  const int hl = lane & 15;                 // lane within the half-warp
  const int pairs = (nb + 1) / 2;
  const int nb8 = nb - nb4;
  const long items = static_cast<long>(m) * pairs;
  // item is the same for the whole warp, so every lane reaches the shuffles
  for (long item = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       item < items; item += static_cast<long>(gridDim.x) * WARPS) {
    const long row = item / pairs;
    const int b = static_cast<int>(item % pairs) * 2 + (lane >> 4);
    const bool live = b < nb;               // an odd nb leaves one half idle
    float v[8];
    if (live) {
      load8(x + row * row_stride + static_cast<long>(b) * BLOCK_K + 8 * hl, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)         // xor < 16 stays in the half
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));

    const bool is4 = b < nb4;
    const float qmax = is4 ? 7.0f : 127.0f;
    const float qmin = is4 ? -8.0f : -128.0f;
    const int bias = is4 ? 8 : 0;
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), qmax);
    uint64_t u = 0;                         // one code byte per channel
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = static_cast<int>(
          fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), qmin), qmax));
      u |= static_cast<uint64_t>((q + bias) & 0xff) << (8 * i);
    }
    // lane l < 8 of a half gets channels 64+8l.. from lane l+8; every
    // byte of u and hi is <= 15 there, so a 4-bit shift of the word moves
    // each byte's nibble into the same byte's high half
    const uint64_t hi = __shfl_down_sync(0xffffffffu, u, 8);
    if (live && is4) {
      if (hl < 8)
        *reinterpret_cast<uint64_t*>(a4 + row * (nb4 * 64L) + b * 64L +
                                     8 * hl) = u | (hi << 4);
      if (hl == 0) s4[row * nb4 + b] = s;
    } else if (live) {
      const int b8 = b - nb4;
      *reinterpret_cast<uint64_t*>(a8 + row * (nb8 * 128L) + b8 * 128L +
                                   8 * hl) = u;
      if (hl == 0) s8[row * nb8 + b8] = s;
    }
  }
}

template <typename T>
int launch(const void* x, long row_stride, int m, int k, int k4,
           uint8_t* a4, float* s4, int8_t* a8, float* s8,
           cudaStream_t stream) {
  const int nb = k / BLOCK_K;
  const long items = static_cast<long>(m) * ((nb + 1) / 2);
  if (items > 0) {
    const long want = (items + WARPS - 1) / WARPS;
    const unsigned grid = static_cast<unsigned>(want < MAX_GRID ? want
                                                                : MAX_GRID);
    act_quant_w4ax_kernel<T><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), row_stride, m, nb, k4 / BLOCK_K, a4, s4,
        a8, s8);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [m, k] row-major, unit channel stride, row stride ``row_stride``
// elements; f32 (dtype 0) or bf16 (dtype 1); base and row stride 16-byte
// aligned; k and k4 multiples of 128, 0 <= k4 <= k →
// packed uint8 a4 [m, k4/2], f32 s4 [m, k4/128] (channels [0, k4)),
// int8 a8 [m, k-k4], f32 s8 [m, (k-k4)/128] (channels [k4, k)).
extern "C" int act_quant_w4ax(const void* x, int dtype, int row_stride,
                              int m, int k, int k4, uint8_t* a4, float* s4,
                              int8_t* a8, float* s8, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(x, row_stride, m, k, k4, a4, s4, a8, s8, stream);
  if (dtype == 1)
    return launch<uint16_t>(x, row_stride, m, k, k4, a4, s4, a8, s8, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

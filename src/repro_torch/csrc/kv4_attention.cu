// Flash-decode over a contiguous int4 KV cache (the gather baseline).
//
// Replaces repro/kernels/kv4_attention.py: kv4_decode_attention
// (_kv4_decode_kernel). The whole op runs in one launch: the
// dequantization (n − z)·s of K and V, the scores, the softmax and p·V.
//
// Inputs: q [B, Hq, D] f32; k/v [B, Hkv, T, D/2] uint8 (byte j = channel j
// | channel j + D/2 << 4); scales/zeros f32 [Hkv, D] shared by the batch
// (batch stride 0) or [B, Hkv, D]; length [B] int32. Key t of row b is
// read only if t < min(length[b], T): T is the gather's max_len, not a
// page multiple. → out [B, Hq, D] f32.
//
// Bound on the H100: bytes, 2·64 B of int4 K and V per valid key and kv
// head (~4 MB for one Llama-3-8B layer at B = 8 and ~512 tokens, ~1.3 µs
// at 3.35 TB/s), so at decode batch sizes the launch and the occupancy of
// B·Hkv = 64 blocks on 132 SMs set the time, not the bytes. Design: one
// block of 256 threads per (b, kv head) row, which splits the row's keys
// (a block-wide loop instead of a split-KV grid with a second combine
// pass: one launch per layer), with the plain version's three-pass
// softmax in exact arithmetic (f64 sums, each rounded once), so kernel and
// plain version agree bit for bit: see decode_attention.cuh.
#include "decode_attention.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(DWARPS * 32) kv4_decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ k_packed,
    const uint8_t* __restrict__ v_packed, const float* __restrict__ ks,
    const float* __restrict__ kz, const float* __restrict__ vs,
    const float* __restrict__ vz, int sstride, const int* __restrict__ length,
    float* __restrict__ out, int hkv, int t_len) {
  const int bh = blockIdx.x, b = bh / hkv, h = bh % hkv;
  const long soff = static_cast<long>(b) * sstride + h * DD;
  const long base = static_cast<long>(bh) * t_len * (DD / 2);
  auto row_off = [](int t) { return static_cast<long>(t) * (DD / 2); };
  decode_row<G>(q, k_packed + base, v_packed + base, ks + soff, kz + soff,
                vs + soff, vz + soff, row_off, min(length[b], t_len), b, h,
                hkv * G, out);
}

}  // namespace

// d must be 128 and g ∈ {1, 2, 4, 8}; every pointer is contiguous.
extern "C" int kv4_decode_attention(
    const float* q, const uint8_t* k_packed, const uint8_t* v_packed,
    const float* ks, const float* kz, const float* vs, const float* vz,
    int sstride, const int* length, float* out, int b, int hkv, int g,
    int t_len, int d, cudaStream_t stream) {
  if (d != DD) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && hkv > 0) {
#define LAUNCH(G)                                                        \
  kv4_decode_kernel<G><<<b * hkv, DWARPS * 32, 0, stream>>>(             \
      q, k_packed, v_packed, ks, kz, vs, vz, sstride, length, out, hkv,  \
      t_len)
    DISPATCH_G(g, LAUNCH)
#undef LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// Flash-decode over a contiguous int4 KV cache (the gather baseline).
//
// Replaces repro/kernels/kv4_attention.py: kv4_decode_attention
// (_kv4_decode_kernel). The whole op runs in one launch: the
// dequantization (n − z)·s of K and V, the scores, the softmax and p·V.
//
// Inputs: q [B, Hq, D] f32 or bf16; k/v [B, Hkv, T, D/2] uint8 (byte j =
// channel j | channel j + D/2 << 4); scales/zeros f32 [Hkv, D] shared by the
// batch (batch stride 0) or [B, Hkv, D]; length [B] int32. Key t of row b is
// read only if t < min(length[b], T): T is the gather's max_len, not a
// multiple of 8 or of the key tile. → out [B, Hq, D] f32.
//
// Bound on the H100: bytes, 2·64 B of int4 K and V per valid key and kv
// head (~4 MB for one Llama-3-8B layer at B = 8 and ~512 tokens, ~1.3 µs
// at 3.35 TB/s), so at decode batch sizes the launch and the latency of a
// block's phases set the time, not the bytes. Design: the dense kernel of
// dense_attention.cuh, which K6 runs on the page pools, with contiguous
// addressing (PAGED false): a 64-key tile of one (b, kv head) is one run
// of 4 KB, staged by cp.async one tile ahead; each key scored once on the
// f64 tensor cores; the keys of a row split over a thread-block cluster
// that dense_plan (kernels/kv4_attention.py) sizes on the host from
// B·Hkv and T. Built for head_dim 32, 64, 80 and 128, as the paged
// kernels are. It computes K6's plain version, which is K10's, in exact
// arithmetic (f64 sums rounded once), so kernel and plain version agree
// bit for bit.
#include "dense_attention.cuh"

// q [B, Hq, D] (q_bf16: bf16, else f32); k/v uint8 [B, hkv, t_len, D/2];
// scales/zeros f32 [hkv, D] (sb 0) or [B, hkv, D] (sb hkv·D); length [B]
// int32 → out [B, Hq, D] f32. d is 32, 64, 80 (Zamba2's attention: its
// 40-byte packed rows are staged by 8-byte copies) or 128, g ≥ 1 (any GQA
// group); every pointer is contiguous. The launch plan (dense_plan at C = 1
// with one "page" of t_len keys, for this d) as dense_plan_ok says; scratch
// null or f32 [B·hkv·tiles·split·rows·sstride].
extern "C" int kv4_decode_attention(
    const void* q, int q_bf16, const uint8_t* k_packed,
    const uint8_t* v_packed, const float* ks, const float* kz,
    const float* vs, const float* vz, int sb, const int* length, float* out,
    float* scratch, int b, int hkv, int g, int t_len, int d, int rows,
    int split, int sstride, int smem, cudaStream_t stream) {
  if (g < 1 || !dense_plan_ok(rows, split, sstride, smem, scratch, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && hkv > 0) {
    const DenseArgs a{q, nullptr, nullptr, ks, kz, vs, vz, k_packed,
                      v_packed, nullptr, length, nullptr, out, scratch, 1, g,
                      hkv, 1, t_len, sstride, q_bf16, sb};
    const cudaError_t e =
        launch_dense_d<false, false>(a, d, b, rows, split, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

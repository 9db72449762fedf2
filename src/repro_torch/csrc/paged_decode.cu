// Paged KV4 flash-decode straight off the page pools, dense schedule.
//
// paged_kv4_decode (K6) — replaces repro/kernels/paged_attention.py:
// paged_kv4_decode_attention (_paged_kv4_decode_kernel): the dense kernel of
// dense_attention.cuh (shared with K7 and K10) with C = 1 and no chunk
// keys — scores once on the f64 tensor cores, kept in shared memory, the
// keys of one (b, kv head) row split over a thread-block cluster that
// dense_plan sizes on the host from B·Hkv and the longest row.
//
// Pools are [P, ps, Hkv, D/2] uint8; key t of row (b, h) sits on page
// max(tables[b, t / ps], 0) at offset t % ps (unmapped −1 entries clamp to
// page 0 and lie at or past length[b], so they are never read for their
// values).
//
// Bound on the H100: bytes, 2·D/2 B of int4 K and V per valid key and kv
// head (~4 MB for one Llama-3-8B layer at B = 8 and ~512 tokens, ~1.3 µs at
// 3.35 TB/s): at decode batch sizes the launch and the latency of a
// block's phases decide the time. The first design gave each (b, kv head)
// row one 256-thread block (64 blocks on 132 SMs) that walked its keys
// three times with f64 FMAs on the CUDA cores; the dense kernel splits the
// row over up to 8 blocks and scores each key once, exactly as the plain
// version computes on the card (f64 sums, each rounded once). The
// work-queue decode (K8) runs on the work-queue kernel of
// paged_attention.cu.
#include "dense_attention.cuh"

// q [B, Hq, D] (q_bf16: bf16, else f32); pools uint8 [P, ps, hkv, D/2];
// scales/zeros f32 [Hkv, D] (sb 0) or [B, Hkv, D] (sb Hkv·D); tables
// [B, np] int32; length [B] int32 → out [B, Hq, D] f32. d is 32, 64, 80
// or 128 (head_dim_built), g ≥ 1 (any GQA group: rows of 8, 16 or 32,
// several row tiles past 32);
// every pointer is contiguous. The launch plan
// (kernels/kv4_attention.py:dense_plan at C = 1) as dense_plan_ok says;
// scratch null or f32 [B·hkv·tiles·split·rows·sstride].
extern "C" int paged_kv4_decode(
    const void* q, int q_bf16, const uint8_t* k_pool, const uint8_t* v_pool,
    const float* ks, const float* kz, const float* vs, const float* vz,
    int sb, const int* tables, const int* length, float* out,
    float* scratch, int b, int hkv, int g, int np, int ps, int d, int rows,
    int split, int sstride, int smem, cudaStream_t stream) {
  if (g < 1 || !dense_plan_ok(rows, split, sstride, smem, scratch, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && hkv > 0) {
    const DenseArgs a{q, nullptr, nullptr, ks, kz, vs, vz, k_pool, v_pool,
                      tables, length, nullptr, out, scratch, 1, g, hkv, np,
                      ps, sstride, q_bf16, sb};
    const cudaError_t e =
        launch_dense_d<false, true>(a, d, b, rows, split, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

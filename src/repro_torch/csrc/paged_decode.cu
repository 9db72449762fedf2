// Paged KV4 flash-decode straight off the page pools, under the two grid
// schedules of the reference:
//
//   paged_kv4_decode      — replaces repro/kernels/paged_attention.py:
//                           paged_kv4_decode_attention (dense schedule,
//                           _paged_kv4_decode_kernel): the dense kernel of
//                           dense_attention.cuh (shared with K7) with C = 1
//                           and no chunk keys — scores once on the f64
//                           tensor cores, kept in shared memory, the keys
//                           of one (b, kv head) row split over a
//                           thread-block cluster that dense_plan sizes on
//                           the host from B·Hkv and the longest row.
//   paged_kv4_decode_wq   — replaces paged_kv4_decode_attention_wq
//                           (work-queue schedule, _paged_kv4_decode_wq_kernel):
//                           one warp per descriptor item (one page of one
//                           row) writes a partial (acc, l, m) in nibble
//                           space; the split-KV combine and the V affine
//                           s_v·comb − s_v·z_v run in PyTorch after it.
//
// Pools are [P, ps, Hkv, D/2] uint8; key t of row (b, h) sits on page
// max(tables[b, t / ps], 0) at offset t % ps (unmapped −1 entries clamp to
// page 0 and lie at or past length[b], so they are never read for their
// values). Descriptors are (row = b·Hkv + h, page, count, kind) int32; pad
// items (count ≤ 0, sentinel row ≥ B·Hkv, clamped when read) write
// (0, 0, NEG_INF) without touching a page, and the combine drops them.
//
// Bound on the H100: bytes, 2·64 B of int4 K and V per valid key and kv
// head (~4 MB for one Llama-3-8B layer at B = 8 and ~512 tokens, ~1.3 µs at
// 3.35 TB/s): at decode batch sizes the launch and the latency of a
// block's phases decide the time. The first dense design gave each (b, kv
// head) row one 256-thread block (64 blocks on 132 SMs) that walked its
// keys three times with f64 FMAs on the CUDA cores; the dense kernel
// splits the row over up to 8 blocks and scores each key once. Work queue:
// 4 items per 128-thread block, one warp each (pages of up to 64 keys), on
// pre-folded queries with the reference's nibble-space partials, so a long
// row's pages run on many SMs at once. Both compute exactly as their plain
// versions do on the card (f64 sums, each rounded once).
#include "dense_attention.cuh"
#include "decode_attention.cuh"

namespace {

constexpr int IPB = 4;      // work items (warps) per block
constexpr int PSMAX = 64;   // the largest page the work-queue kernel takes

template <int G>
__global__ void __launch_bounds__(IPB * 32) paged_decode_wq_kernel(
    const int* __restrict__ desc, int w, const float* __restrict__ qt,
    const float* __restrict__ cterm, const uint8_t* __restrict__ k_pool,
    const uint8_t* __restrict__ v_pool, float* __restrict__ acc_out,
    float* __restrict__ l_out, float* __restrict__ m_out, int nrows, int ps,
    int hkv) {
  __shared__ float sq[IPB][G * DD];
  __shared__ float se[IPB][G][PSMAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * IPB + warp;
  if (item >= w) return;                 // warp-uniform; no block barrier below
  const int row = min(desc[4 * item], nrows - 1);
  const int page = desc[4 * item + 1];
  const int count = desc[4 * item + 2];
  const int head = row % hkv;
  const long obase = static_cast<long>(item) * G;

  if (count <= 0) {
    for (int i = lane; i < G * DD; i += 32) acc_out[obase * DD + i] = 0.f;
    if (lane < G) {
      l_out[obase + lane] = 0.f;
      m_out[obase + lane] = NEG_INF;
    }
    return;
  }
  for (int i = lane; i < G * DD; i += 32)
    sq[warp][i] = qt[static_cast<long>(row) * G * DD + i];
  __syncwarp();
  const int n = min(count, ps);
  auto row_ptr = [=](const uint8_t* pool, int t) {
    return pool + ((static_cast<long>(page) * ps + t) * hkv + head) * (DD / 2);
  };

  // scores s = q̃·n − c of the page's keys, and their max
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = NEG_INF;
  for (int t = lane; t < n; t += 32) {
    float s[G];
    dot_row<G, false>(sq[warp], row_ptr(k_pool, t), nullptr, nullptr, s);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] -= cterm[static_cast<long>(row) * G + g];
      se[warp][g][t] = s[g];
      mx[g] = fmaxf(mx[g], s[g]);
    }
  }
  double ls[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = warp_max(mx[g]);
    ls[g] = 0.0;
  }
  __syncwarp();
  // p = e^(s − m) in place, and l = Σ p
  for (int t = lane; t < n; t += 32) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = exp_f64(se[warp][g][t] - mx[g]);
      se[warp][g][t] = e;
      ls[g] += e;
    }
  }
  __syncwarp();
  // Σ p·n_v: lane = (head, channel) pairs lane + 32k, all in flight at
  // once across the page's keys
  constexpr int KP = G * DD / 32;
  double a[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) a[k] = 0.0;
  for (int t = 0; t < n; ++t) {
    const uint8_t* vr = row_ptr(v_pool, t);
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int pair = lane + 32 * k;
      a[k] = fma(static_cast<double>(se[warp][pair / DD][t]),
                 static_cast<double>(code(vr, pair % DD)), a[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int pair = lane + 32 * k;
    acc_out[(obase + pair / DD) * DD + pair % DD] = static_cast<float>(a[k]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l = static_cast<float>(warp_sum_d(ls[g]));
    if (lane == 0) {
      l_out[obase + g] = l;
      m_out[obase + g] = mx[g];
    }
  }
}

}  // namespace

// q [B, Hq, D] (q_bf16: bf16, else f32); pools uint8 [P, ps, hkv, D/2];
// scales/zeros f32 [Hkv, D] (sb 0) or [B, Hkv, D] (sb Hkv·D); tables
// [B, np] int32; length [B] int32 → out [B, Hq, D] f32. d must be 128,
// g ≤ 8; every pointer is contiguous. The launch plan
// (kernels/paged_attention.py:dense_plan at C = 1; rows 8) as
// dense_plan_ok says; scratch null or f32 [B·hkv·split·8·sstride].
extern "C" int paged_kv4_decode(
    const void* q, int q_bf16, const uint8_t* k_pool, const uint8_t* v_pool,
    const float* ks, const float* kz, const float* vs, const float* vz,
    int sb, const int* tables, const int* length, float* out,
    float* scratch, int b, int hkv, int g, int np, int ps, int d, int rows,
    int split, int sstride, int smem, cudaStream_t stream) {
  if (d != D || g < 1 || g > 8 || rows != 8 ||
      !dense_plan_ok(rows, split, sstride, smem, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && hkv > 0) {
    const DenseArgs a{q, nullptr, nullptr, ks, kz, vs, vz, k_pool, v_pool,
                      tables, length, nullptr, out, scratch, 1, g, hkv, np,
                      ps, sstride, q_bf16, sb};
    const cudaError_t e = launch_dense<1, false>(a, b, split, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// desc int32 [w, 4]; qt f32 [nrows, g, D] (q·s_k/√D); cterm f32 [nrows, g]
// (Σ q̃·z_k); pools uint8 [P, ps, hkv, D/2] → acc f32 [w, g, D] (Σ p·n_v),
// l/m f32 [w, g]. d must be 128, g ∈ {1, 2, 4, 8}, ps ≤ 64; all
// contiguous.
extern "C" int paged_kv4_decode_wq(
    const int* desc, int w, const float* qt, const float* cterm,
    const uint8_t* k_pool, const uint8_t* v_pool, float* acc, float* l,
    float* m, int nrows, int g, int ps, int hkv, int d, cudaStream_t stream) {
  if (d != DD || ps > PSMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (w > 0) {
#define LAUNCH(G)                                                          \
  paged_decode_wq_kernel<G><<<(w + IPB - 1) / IPB, IPB * 32, 0, stream>>>( \
      desc, w, qt, cterm, k_pool, v_pool, acc, l, m, nrows, ps, hkv)
    DISPATCH_G(g, LAUNCH)
#undef LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

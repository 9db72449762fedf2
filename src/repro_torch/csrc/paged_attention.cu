// Paged KV4 chunked-prefill attention under the reference's two grid
// schedules.
//
// paged_kv4_prefill_wq — replaces repro/kernels/paged_attention.py:
// paged_kv4_prefill_attention_wq (_paged_kv4_prefill_wq_kernel): one flash
// partial (acc, l, m) per work-queue descriptor item. The affine pre-fold
// of the queries and the log-sum-exp combine of the partials stay in
// PyTorch around it.
//
// Descriptor item (row, page, count, kind), row = seq·Hkv + kv_head:
//   kind 0 — one int4 history page: s = q̃·n_k − c over positions < count,
//            partial value p·n_v·s_v − (Σp)·s_v·z_v (V affine folded in);
//   kind 1 — the row's in-flight fp chunk: s = (q/√D)·k over keys
//            kj ≤ qi and kj < count (causal), value p·v.
// Masked scores are NEG_INF = −1e30 (finite, as in the reference), and the
// row id is clamped to nrows − 1 when reading. An item with count ≤ 0 —
// only the power-of-two padding, whose sentinel row the combine drops —
// writes (acc, l, m) = (0, 0, NEG_INF) without touching any page.
//
// Bound on the H100: operations (f32 FMAs on the CUDA cores, ~4·D per
// query row per key, against 4.2·D bytes of page per key shared by all of
// the row's C·G query rows). Design: a (item, 16-query-row) tile per
// 128-thread block; keys stream through shared memory in chunks of 32
// (unpacked nibbles for pages, f32 for the chunk), one key per lane for
// the scores (padded row stride: conflict-free) and four head channels
// per lane for p·V, with an online softmax across chunks. A query row
// skips the chunks wholly past its causal edge. f32 CUDA-core math, no
// tensor cores yet.
//
// paged_kv4_prefill_dense — replaces paged_kv4_prefill_attention (dense
// schedule, _paged_kv4_prefill_kernel): see the note at the kernel below.
#include "common.cuh"

namespace {

constexpr int D = 128;        // head_dim this kernel is built for
constexpr int KC = 32;        // keys per shared-memory chunk (one per lane)
constexpr int ROWS = 16;      // query rows per thread block
constexpr int WARPS = 4;
constexpr int RPW = ROWS / WARPS;

__global__ void __launch_bounds__(WARPS * 32) prefill_wq_kernel(
    const int* __restrict__ desc,
    const float* __restrict__ qt, const float* __restrict__ cterm,
    const float* __restrict__ qs,
    const float* __restrict__ kn, const float* __restrict__ vn,
    const float* __restrict__ vs, const float* __restrict__ vz,
    const uint8_t* __restrict__ k_pool, const uint8_t* __restrict__ v_pool,
    float* __restrict__ acc_out, float* __restrict__ l_out,
    float* __restrict__ m_out,
    int nrows, int cg, int c, int g, int ps, int hkv) {
  __shared__ float sK[KC][D + 1];
  __shared__ __align__(16) float sV[KC][D];
  __shared__ __align__(16) float sQ[ROWS][D];

  const int item = blockIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = min(desc[4 * item], nrows - 1);
  const int page = desc[4 * item + 1];
  const int count = desc[4 * item + 2];
  const int kind = desc[4 * item + 3];
  const int head = row % hkv;
  const long obase = static_cast<long>(item) * cg;

  if (count <= 0) {
    for (int i = tid; i < ROWS * D; i += WARPS * 32) {
      const int r = r0 + i / D;
      if (r < cg) acc_out[(obase + r) * D + i % D] = 0.f;
    }
    if (tid < ROWS && r0 + tid < cg) {
      l_out[obase + r0 + tid] = 0.f;
      m_out[obase + r0 + tid] = NEG_INF;
    }
    return;
  }

  const float* qsrc = (kind == 0 ? qt : qs) + static_cast<long>(row) * cg * D;
  for (int i = tid; i < ROWS * D; i += WARPS * 32) {
    const int r = r0 + i / D;
    sQ[i / D][i % D] = r < cg ? qsrc[static_cast<long>(r) * D + i % D] : 0.f;
  }
  const int last_row = min(r0 + ROWS, cg) - 1;
  const int nkeys = kind == 0 ? min(count, ps)
                              : min(min(count, c), last_row / g + 1);

  float m_i[RPW], l_i[RPW], c_i[RPW], a_i[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp * RPW + i;
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
    c_i[i] = (kind == 0 && r < cg) ? cterm[static_cast<long>(row) * cg + r] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_i[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < nkeys; k0 += KC) {
    __syncthreads();   // sQ written / previous chunk consumed
    if (kind == 0) {
      for (int i = tid; i < KC * (D / 2); i += WARPS * 32) {
        const int j = i / (D / 2), d = i % (D / 2), p = k0 + j;
        uint8_t kb = 0, vb = 0;
        if (p < ps) {
          const long off =
              ((static_cast<long>(page) * ps + p) * hkv + head) * (D / 2) + d;
          kb = k_pool[off];
          vb = v_pool[off];
        }
        sK[j][d] = static_cast<float>(kb & 15);
        sK[j][d + D / 2] = static_cast<float>(kb >> 4);
        sV[j][d] = static_cast<float>(vb & 15);
        sV[j][d + D / 2] = static_cast<float>(vb >> 4);
      }
    } else {
      for (int i = tid; i < KC * D; i += WARPS * 32) {
        const int j = i / D, d = i % D, kj = k0 + j;
        float kv = 0.f, vv = 0.f;
        if (kj < c) {
          const long off = (static_cast<long>(row) * c + kj) * D + d;
          kv = kn[off];
          vv = vn[off];
        }
        sK[j][d] = kv;
        sV[j][d] = vv;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rl = warp * RPW + i, r = r0 + rl;
      const int qi = r / g;
      if (r >= cg || (kind != 0 && k0 > qi)) continue;   // warp-uniform
      const int kj = k0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(sQ[rl][d], sK[lane][d], s);
      const bool valid = kind == 0 ? (kj < count && kj < ps)
                                   : (kj <= qi && kj < count && kj < c);
      s = valid ? s - c_i[i] : NEG_INF;
      const float m_new = fmaxf(m_i[i], warp_max(s));
      const float alpha = expf(m_i[i] - m_new);
      const float p = expf(s - m_new);
      l_i[i] = l_i[i] * alpha + warp_sum(p);
#pragma unroll
      for (int e = 0; e < 4; ++e) a_i[i][e] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < KC; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float4 v4 = *reinterpret_cast<const float4*>(&sV[jj][4 * lane]);
        a_i[i][0] = fmaf(pj, v4.x, a_i[i][0]);
        a_i[i][1] = fmaf(pj, v4.y, a_i[i][1]);
        a_i[i][2] = fmaf(pj, v4.z, a_i[i][2]);
        a_i[i][3] = fmaf(pj, v4.w, a_i[i][3]);
      }
      m_i[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp * RPW + i;
    if (r >= cg) continue;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kind == 0) {
        const int d = head * D + 4 * lane + e;
        o[e] = a_i[i][e] * vs[d] - l_i[i] * (vs[d] * vz[d]);
      } else {
        o[e] = a_i[i][e];
      }
    }
    *reinterpret_cast<float4*>(&acc_out[(obase + r) * D + 4 * lane]) =
        make_float4(o[0], o[1], o[2], o[3]);
    if (lane == 0) {
      l_out[obase + r] = l_i[i];
      m_out[obase + r] = m_i[i];
    }
  }
}

// Dense chunked prefill (K7): one block per (b, kv head) row and tile of
// ROWS query rows r = qi·G + gi. The block walks the row's keys — the
// history [0, ctx) through the block table, dequantized to (n − z)·s as it
// is staged, then the chunk's keys j ≤ qi, j < q_len — three times: for
// the max score, for L = Σ e^(s−M), and for Σ (e^(s−M)/L)·v. Every dot
// product and sum accumulates in f64 and is rounded once to f32, and the
// exponential is the f64 one rounded, as the plain version computes on the
// card, so the two agree bit for bit (orders of summation no longer
// matter) and a token served through the kernel is the token of the plain
// version. Bound on the H100: operations, ~4·D per (valid query, valid
// key); the three f64 passes cost ~6× that at the f64 rate, the price of
// the exact agreement (a later PR can trade it for tensor cores).
__global__ void __launch_bounds__(WARPS * 32) prefill_dense_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, const float* __restrict__ ks,
    const float* __restrict__ kz, const float* __restrict__ vs,
    const float* __restrict__ vz, const uint8_t* __restrict__ k_pool,
    const uint8_t* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, const int* __restrict__ q_lens,
    float* __restrict__ out, int c, int g, int hkv, int np, int ps) {
  __shared__ float sK[KC][D + 1];
  __shared__ __align__(16) float sV[KC][D];
  __shared__ __align__(16) float sQ[ROWS][D];

  const int bh = blockIdx.x, b = bh / hkv, h = bh % hkv;
  const int r0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = c * g, hq = hkv * g;
  const int ctx = min(ctx_lens[b], np * ps);
  const int qlen = min(q_lens[b], c);
  // query row r of this (b, h) lives at out/q[b, r / g, h·g + r % g, :]
  auto qrow = [=](int r) {
    return ((static_cast<long>(b) * c + r / g) * hq + h * g + r % g) * D;
  };

  if (r0 >= qlen * g) {       // padding rows only: finite zeros, no reads
    for (int i = tid; i < ROWS * D; i += WARPS * 32) {
      const int r = r0 + i / D;
      if (r < cg) out[qrow(r) + i % D] = 0.f;
    }
    return;
  }
  for (int i = tid; i < ROWS * D; i += WARPS * 32) {
    const int r = r0 + i / D;
    sQ[i / D][i % D] = r < cg ? q[qrow(r) + i % D] : 0.f;
  }
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const float* ksh = ks + h * D;
  const float* kzh = kz + h * D;
  const float* vsh = vs + h * D;
  const float* vzh = vz + h * D;
  const int* tbl = tables + static_cast<long>(b) * np;
  const int last_row = min(r0 + ROWS, cg) - 1;
  const int nchunk = min(qlen, last_row / g + 1);   // chunk keys any row sees

  float m_i[RPW], l_i[RPW];
  double e_i[RPW], a_i[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
    e_i[i] = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_i[i][e] = 0.0;
  }

  for (int pass = 0; pass < 3; ++pass) {
    for (int part = 0; part < 2; ++part) {     // history, then the chunk
      const bool hist = part == 0;
      const int nkeys = hist ? ctx : nchunk;
      for (int k0 = 0; k0 < nkeys; k0 += KC) {
        __syncthreads();   // sQ written / previous chunk consumed
        if (hist) {
          for (int i = tid; i < KC * (D / 2); i += WARPS * 32) {
            const int j = i / (D / 2), d = i % (D / 2), t = k0 + j;
            float k_lo = 0.f, k_hi = 0.f, v_lo = 0.f, v_hi = 0.f;
            if (t < ctx) {
              const int page = max(tbl[t / ps], 0);
              const long off = ((static_cast<long>(page) * ps + t % ps) * hkv
                                + h) * (D / 2) + d;
              const uint8_t kb = k_pool[off], vb = v_pool[off];
              k_lo = (static_cast<float>(kb & 15) - kzh[d]) * ksh[d];
              k_hi = (static_cast<float>(kb >> 4) - kzh[d + D / 2]) * ksh[d + D / 2];
              v_lo = (static_cast<float>(vb & 15) - vzh[d]) * vsh[d];
              v_hi = (static_cast<float>(vb >> 4) - vzh[d + D / 2]) * vsh[d + D / 2];
            }
            sK[j][d] = k_lo;
            sK[j][d + D / 2] = k_hi;
            sV[j][d] = v_lo;
            sV[j][d + D / 2] = v_hi;
          }
        } else {
          for (int i = tid; i < KC * D; i += WARPS * 32) {
            const int j = i / D, d = i % D, kj = k0 + j;
            float kv = 0.f, vv = 0.f;
            if (kj < qlen) {
              const long off = ((static_cast<long>(b) * c + kj) * hkv + h) * D + d;
              kv = kn[off];
              vv = vn[off];
            }
            sK[j][d] = kv;
            sV[j][d] = vv;
          }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int rl = warp * RPW + i, r = r0 + rl;
          const int qi = r / g;
          if (r >= cg || (!hist && k0 > qi)) continue;   // warp-uniform
          const int kj = k0 + lane;
          const bool valid = hist ? kj < ctx : (kj <= qi && kj < qlen);
          double s0 = 0.0, s1 = 0.0;
#pragma unroll 8
          for (int d = 0; d < D; d += 2) {
            s0 = fma(static_cast<double>(sQ[rl][d]),
                     static_cast<double>(sK[lane][d]), s0);
            s1 = fma(static_cast<double>(sQ[rl][d + 1]),
                     static_cast<double>(sK[lane][d + 1]), s1);
          }
          const float s = static_cast<float>(s0 + s1) / sqrt_d;
          if (pass == 0) {
            m_i[i] = fmaxf(m_i[i], warp_max(valid ? s : NEG_INF));
          } else if (pass == 1) {
            e_i[i] += valid ? static_cast<double>(exp_f64(s - m_i[i])) : 0.0;
          } else {
            const float p = valid ? exp_f64(s - m_i[i]) / l_i[i] : 0.f;
#pragma unroll 8
            for (int jj = 0; jj < KC; ++jj) {
              const double pj = __shfl_sync(0xffffffffu, p, jj);
              const float4 v4 = *reinterpret_cast<const float4*>(&sV[jj][4 * lane]);
              a_i[i][0] = fma(pj, static_cast<double>(v4.x), a_i[i][0]);
              a_i[i][1] = fma(pj, static_cast<double>(v4.y), a_i[i][1]);
              a_i[i][2] = fma(pj, static_cast<double>(v4.z), a_i[i][2]);
              a_i[i][3] = fma(pj, static_cast<double>(v4.w), a_i[i][3]);
            }
          }
        }
      }
    }
    if (pass == 1) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) l_i[i] = static_cast<float>(warp_sum_d(e_i[i]));
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp * RPW + i;
    if (r >= cg) continue;
    *reinterpret_cast<float4*>(&out[qrow(r) + 4 * lane]) = make_float4(
        static_cast<float>(a_i[i][0]), static_cast<float>(a_i[i][1]),
        static_cast<float>(a_i[i][2]), static_cast<float>(a_i[i][3]));
  }
}

}  // namespace

// desc int32 [w, 4]; qt/qs f32 [nrows, cg, D]; cterm f32 [nrows, cg];
// kn/vn f32 [nrows, c, D]; vs/vz f32 [hkv, D]; pools uint8 [P, ps, hkv, D/2]
// → acc f32 [w, cg, D], l/m f32 [w, cg]. All contiguous; d must be 128.
extern "C" int paged_kv4_prefill_wq(
    const int* desc, int w, const float* qt, const float* cterm,
    const float* qs, const float* kn, const float* vn, const float* vs,
    const float* vz, const uint8_t* k_pool, const uint8_t* v_pool,
    float* acc, float* l, float* m, int nrows, int cg, int c, int g, int ps,
    int hkv, int d, cudaStream_t stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  if (w > 0 && cg > 0) {
    const dim3 grid(w, (cg + ROWS - 1) / ROWS);
    prefill_wq_kernel<<<grid, WARPS * 32, 0, stream>>>(
        desc, qt, cterm, qs, kn, vn, vs, vz, k_pool, v_pool, acc, l, m,
        nrows, cg, c, g, ps, hkv);
  }
  return static_cast<int>(cudaGetLastError());
}

// q f32 [B, C, Hq, D]; k/v_new f32 [B, C, hkv, D]; ks/kz/vs/vz f32 [hkv, D];
// pools uint8 [P, ps, hkv, D/2]; tables int32 [B, np]; ctx/q_len int32 [B]
// → out f32 [B, C, Hq, D] (rows past q_len: finite garbage). All
// contiguous; d must be 128.
extern "C" int paged_kv4_prefill_dense(
    const float* q, const float* kn, const float* vn, const float* ks,
    const float* kz, const float* vs, const float* vz, const uint8_t* k_pool,
    const uint8_t* v_pool, const int* tables, const int* ctx_lens,
    const int* q_lens, float* out, int b, int c, int g, int hkv, int np,
    int ps, int d, cudaStream_t stream) {
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && c > 0 && hkv > 0) {
    const dim3 grid(b * hkv, (c * g + ROWS - 1) / ROWS);
    prefill_dense_kernel<<<grid, WARPS * 32, 0, stream>>>(
        q, kn, vn, ks, kz, vs, vz, k_pool, v_pool, tables, ctx_lens, q_lens,
        out, c, g, hkv, np, ps);
  }
  return static_cast<int>(cudaGetLastError());
}

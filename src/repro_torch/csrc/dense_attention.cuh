// KV4 attention on the f64 tensor cores, one launch per call: the
// dense-schedule kernel shared by K7 (chunked prefill, paged_attention.cu),
// K6 (paged decode, paged_decode.cu) and K10 (decode over a contiguous
// cache, kv4_attention.cu), and the pieces the work-queue kernel of K9 and
// K8 (paged_attention.cu) builds on — the f64 MMA, the query load, the
// tile constants.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

// The dense kernel replaces, in repro/kernels/paged_attention.py,
// paged_kv4_prefill_attention (K7, _paged_kv4_prefill_kernel; CHUNK true)
// and paged_kv4_decode_attention (K6, _paged_kv4_decode_kernel; CHUNK
// false: C = 1, no chunk keys, history [0, length), scales per batch row
// or shared), and in repro/kernels/kv4_attention.py kv4_decode_attention
// (K10, _kv4_decode_kernel: K6's function with PAGED false, key t of
// (b, h) read from the contiguous [B, Hkv, T, D/2] cache at row
// (b·Hkv + h)·T + t, with np = 1 and ps = T). Query row r = qi·G + gi of
// (b, kv head h) attends over the int4 history [0, ctx),
// read through the block table and dequantized to (n − z)·s, and the
// chunk's keys j ≤ qi, j < q_len, in exact arithmetic: every dot product
// and sum in f64 rounded once to f32, the exponential the f64 one rounded
// (e = f32(exp(s − M)), L = f32(Σ e), p = e / L in f32, out = f32(Σ p·v)),
// as the plain version computes on the card, so the two agree bit for bit
// (an f64 sum rounded once does not depend on its order) and a token served
// through the kernel is the token of the plain version. K6's plain version
// (and K10's) masks with −inf where K7's uses NEG_INF = −1e30: both give
// e = 0.
//
// Bound on the H100: operations, ~4·D per (valid query, valid key), at the
// f64 rate the exact contract asks for, for a prefill chunk; bytes (the
// int4 K and V of each valid key, read once) at decode, where the launch
// and the latency of one block's phases set the time. The first designs
// walked every key three times (max, Σe, p·V), re-staging and re-scoring
// it each time with f64 FMAs on the CUDA cores, with one block per (b, h)
// — at decode shape (C = 1, G = 4) 64 blocks for 132 SMs. This one:
// * scores each (row, key) once. A 64-key tile's packed bytes come by
//   16-byte cp.async one tile ahead (the block's page ids read once),
//   are dequantized to f64 in shared memory, and QKᵀ runs on the f64
//   tensor cores (mma m16n8k8: f32 products are exact in f64, so only the
//   summation order changes, and it is free), keys as the MMA's rows and
//   8 query rows as its columns. The scores stay in shared memory — or,
//   when rows × keys do not fit (dense_plan in kernels/kv4_attention.py
//   decides), in a scratch buffer the wrapper allocates — for the max,
//   the exponentials and Σe, then Oᵀ = Vᵀ·Pᵀ on the tensor cores over V
//   tiles staged once.
// * sizes the row tile to C·G (8, 16 or 32 rows; warps split the rows
//   and the keys of each tile) and splits the key range of one (b, h, row
//   tile) across the blocks of a thread-block cluster (1..8, as many as
//   run in one wave; dense_plan sizes it on the host from B·Hkv and the
//   longest row): the partial maxima, the f64 partial Σe and the f64
//   partial outputs meet through distributed shared memory between
//   cluster barriers, so M is global before any exponential and L before
//   any p, in one launch;
// * skips the MMAs of key steps wholly past a warp's causal edge, and
//   gives the 32-row tile 8 warps, so an SM has warps to switch to while
//   one waits on an MMA or a load.
constexpr int D = 128;             // the widest head_dim built
constexpr int KT = 64;             // keys per staged tile
// the head_dims every attention kernel (K6-K10) is instantiated for; the
// packed KV rows are D/2 = 16, 32, 40 and 64 bytes
__host__ __device__ constexpr bool head_dim_built(int d) {
  return d == 32 || d == 64 || d == 80 || d == 128;
}
// the f64 row stride of a staged K/V tile: the fragment loads are
// conflict-free (D + 4 ≡ 4 mod 16 doubles at every built D)
__host__ __device__ constexpr int dn_skv(int d) { return d + 4; }
constexpr int SKV = dn_skv(D);
constexpr int DN_MAXR = 32;        // most rows per block
constexpr int DN_MAXWR = 64;       // most (key-warp, row) partials
// warps across the keys of a tile: 4 for the 8- and 16-row tiles, 2 for
// the 32-row tile (8 warps a block, so the SM has warps to switch to)
__host__ __device__ constexpr int dn_wk(int wr) { return wr == 4 ? 2 : 4; }
__host__ __device__ constexpr int dn_threads(int wr) {
  return 32 * wr * dn_wk(wr);
}
constexpr int DN_MAXP = 512;       // history pages of a block kept at hand
__host__ __device__ constexpr int dn_kv(int d) { return KT * dn_skv(d) * 8; }
// two tiles of packed bytes
__host__ __device__ constexpr int dn_raw(int d) { return 2 * KT * (d / 2); }
__host__ __device__ constexpr int dn_fixed(int d) {
  return dn_kv(d) + dn_raw(d) + DN_MAXP * 4 + 4 * d * 4 + DN_MAXR * 8 +
         (DN_MAXWR + 2 * DN_MAXR) * 4;
}
constexpr int DN_KV = dn_kv(D);
constexpr int DN_RAW = dn_raw(D);
constexpr int DN_FIXED = dn_fixed(D);       // 80,640 bytes at D 128
static_assert(DN_FIXED == 80640 && dn_fixed(80) == 52224 &&
              dn_fixed(64) == 42752 && dn_fixed(32) == 23808,
              "smem layout (kernels/kv4_attention.py:dense_fixed_smem)");
constexpr int DN_SMEM_MAX = 232448;         // the H100's per-block opt-in

// D(16×8) += A(16×8)·B(8×8) in f64 on the tensor cores; lane (g, t) holds
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// Four channels of a query, from f32 or bf16 (widened exactly).
__device__ __forceinline__ float4 load_q4(const void* q, long i, bool bf16) {
  if (bf16) {
    const uint2 w =
        *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(q) + i);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(q) + i);
}

// q [B, C, Hq, D] (q_bf16: bf16, else f32); scales/zeros [Hkv, D] at batch
// stride sb floats (0: shared); ctx_lens [B] (K6, K10: the lengths); q_lens
// and kn/vn read only with CHUNK, tables only with PAGED (K10: null, np 1,
// ps T, the pools the contiguous [B, Hkv, T, D/2] cache).
struct DenseArgs {
  const void* q; const float* kn; const float* vn;
  const float* ks; const float* kz; const float* vs; const float* vz;
  const uint8_t* k_pool; const uint8_t* v_pool;
  const int* tables; const int* ctx_lens; const int* q_lens;
  float* out; float* scratch;
  int c, g, hkv, np, ps, sstride, q_bf16, sb;
};

// WR warps across the rows (8 each), dn_wk(WR) across the keys of a tile;
// gridDim = (split, row tiles, B·Hkv), the cluster spans the split.
// Products are taken transposed, keys (or head channels) as the MMA's 16
// rows and the warp's 8 query rows as its 8 columns: Sᵀ = K·Qᵀ, Oᵀ = Vᵀ·Pᵀ.
// PAGED: history keys through the block table; else the contiguous cache.
// HD: the head_dim of this instantiation (head_dim_built: 32, 64, 80,
// 128), which the block-scope D, SKV, DN_KV and DN_RAW below follow.
template <int WR, bool CHUNK, bool PAGED, int HD = D>
__global__ void __launch_bounds__(dn_threads(WR)) dense_attention_kernel(
    DenseArgs a) {
  constexpr int D = HD, SKV = dn_skv(HD), DN_KV = dn_kv(HD),
                DN_RAW = dn_raw(HD);
  static_assert(D % 16 == 0 && dn_wk(WR) * 8 * WR * D <= KT * SKV,
                "head_dim tiles; the warps' partial outputs fit sKV");
  constexpr int R = 8 * WR, WK = dn_wk(WR), DN_THREADS = dn_threads(WR);
  extern __shared__ __align__(16) unsigned char smem[];
  double* sKV = reinterpret_cast<double*>(smem);            // [KT][SKV]
  double* sSumP = reinterpret_cast<double*>(smem + DN_KV);  // [R]
  unsigned char* sRaw = smem + DN_KV + DN_MAXR * 8;         // [2][KT][D/2]
  int* sPage = reinterpret_cast<int*>(sRaw + DN_RAW);       // [DN_MAXP]
  float* sScale = reinterpret_cast<float*>(sPage + DN_MAXP); // ks kz vs vz
  float* sMaxP = sScale + 4 * D;                            // [WK][R]
  float* sM = sMaxP + DN_MAXWR;
  float* sL = sM + DN_MAXR;
  float* sQ = reinterpret_cast<float*>(smem);   // [R][D] before the keys
  double* sOut = sKV;          // [WK][R][D] after the last V tile

  namespace cg = cooperative_groups;
  const int nsplit = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wk = warp / WR;
  const int bh = blockIdx.z, b = bh / a.hkv, h = bh % a.hkv;
  const int r0 = blockIdx.y * R;
  const int grp = a.g, cg_rows = a.c * grp, hq = a.hkv * grp;
  const int ctx = min(a.ctx_lens[b], a.np * a.ps);
  const int qlen = CHUNK ? min(a.q_lens[b], a.c) : 1;
  // query row r of this (b, h) lives at out/q[b, r / G, h·G + r % G, :]
  auto qrow = [&](int r) {
    return ((static_cast<long>(b) * a.c + r / grp) * hq + h * grp + r % grp)
           * D;
  };
  auto cluster_sync = [&]() {
    if (nsplit > 1) cg::this_cluster().sync(); else __syncthreads();
  };
  auto remote = [&](auto* p, int rk) {
    return nsplit > 1 ? cg::this_cluster().map_shared_rank(p, rk) : p;
  };

  if (r0 >= qlen * grp) {     // padding rows only: zeros, no reads
    for (int i = rank * DN_THREADS + tid; i < R * D;
         i += nsplit * DN_THREADS) {
      const int r = r0 + i / D;
      if (r < cg_rows) a.out[qrow(r) + i % D] = 0.f;
    }
    return;                   // the whole cluster returns here
  }

  // this block's share of the keys: history [0, ctx), then chunk keys
  // [0, nchunk) as keys ctx.. ; a multiple of 8 keys per block
  const int last_qi = (min(r0 + R, cg_rows) - 1) / grp;
  const int nchunk = CHUNK ? min(qlen, last_qi + 1) : 0;
  const int nk = ctx + nchunk;
  const int per = ((nk + nsplit - 1) / nsplit + 7) & ~7;
  const int lo = rank * per;
  const int nloc = max(0, min(per, nk - lo));
  const int ntile = (nloc + KT - 1) / KT;
  float* scores = a.scratch == nullptr
      ? sL + DN_MAXR
      : a.scratch + ((static_cast<long>(bh) * gridDim.y + blockIdx.y) *
                     nsplit + rank) * R * a.sstride;
  const int rbase = 8 * wr;                 // the warp's first row
  const int warp_qi = (min(r0 + rbase + 7, cg_rows - 1)) / grp;
  const int* tbl = PAGED ? a.tables + static_cast<long>(b) * a.np : nullptr;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  for (int i = tid; i < 4 * D; i += DN_THREADS) {
    const float* src = i < D ? a.ks : i < 2 * D ? a.kz : i < 3 * D ? a.vs
                                                                   : a.vz;
    sScale[i] = src[static_cast<long>(b) * a.sb + h * D + i % D];
  }
  for (int i = tid; i < R * D / 4; i += DN_THREADS) {
    const int r = r0 + i / (D / 4);
    *reinterpret_cast<float4*>(sQ + 4 * i) =
        r < cg_rows ? load_q4(a.q, qrow(r) + 4 * (i % (D / 4)), a.q_bf16)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the physical pages of this block's history keys, at hand
  const int p_first = PAGED ? lo / a.ps : 0;
  if constexpr (PAGED) {
    const int p_count =
        lo < ctx ? (min(lo + nloc, ctx) - 1) / a.ps - p_first + 1 : 0;
    for (int i = tid; i < min(p_count, DN_MAXP); i += DN_THREADS)
      sPage[i] = max(tbl[p_first + i], 0);
  }
  // the packed row of history key tg: on its page, or at (b·Hkv + h)·T + tg
  // of the contiguous cache (ps = T)
  auto key_row = [&](int tg) -> long {
    if constexpr (PAGED) {
      const int i = tg / a.ps - p_first;
      const int page = i < DN_MAXP ? sPage[i] : max(tbl[tg / a.ps], 0);
      return (static_cast<long>(page) * a.ps + tg % a.ps) * a.hkv + h;
    } else {
      return static_cast<long>(bh) * a.ps + tg;
    }
  };
  // a key step [k, ..) of local keys that no row of this warp sees
  auto dead = [&](int k) {
    const int tg = lo + k;
    return k >= nloc || (tg >= ctx && tg - ctx > warp_qi);
  };

  // the tile stream: K tiles 0..ntile−1, then V tiles; tile s's packed
  // history bytes go to raw buffer s & 1 by cp.async one tile ahead
  // (16-byte copies where a packed row is whole 16-byte pieces, as at
  // D = 32, 64 and 128; 8-byte ones at D = 80, whose 40-byte rows are
  // 8-aligned only)
  constexpr int CB = (D / 2) % 16 == 0 ? 16 : 8;
  constexpr int CPR = D / 2 / CB, NCOPY = KT * CPR;
  auto prefetch = [&](int s) {
    const int k0 = (s % ntile) * KT;
    const uint8_t* pool = s < ntile ? a.k_pool : a.v_pool;
    unsigned char* raw = sRaw + (s & 1) * KT * (D / 2);
#pragma unroll
    for (int u = 0; u < (NCOPY + DN_THREADS - 1) / DN_THREADS; ++u) {
      const int i = tid + u * DN_THREADS;
      // unsigned, so a power-of-two CPR divides by a shift and a mask
      const int j = static_cast<unsigned>(i) / CPR,
                c = static_cast<unsigned>(i) % CPR, kl = k0 + j, tg = lo + kl;
      if ((NCOPY % DN_THREADS == 0 || i < NCOPY) && kl < nloc && tg < ctx) {
        const long off = key_row(tg) * (D / 2) + CB * c;
        cp_async<CB>(raw + j * (D / 2) + CB * c, pool + off, true);
      }
    }
    cp_commit();
  };
  // stage tile s (its packed bytes landed) into sKV as f64
  auto stage = [&](int s) {
    const bool val = s >= ntile;
    const int k0 = (s % ntile) * KT;
    cp_wait<0>();
    __syncthreads();   // tile s landed; the previous tile is consumed
    if (s + 1 < 2 * ntile) prefetch(s + 1);
    const unsigned char* raw = sRaw + (s & 1) * KT * (D / 2);
    const float* sc = sScale + (val ? 2 * D : 0);   // scale, then zero
    for (int j = warp; j < KT; j += DN_THREADS / 32) {
      const int kl = k0 + j, tg = lo + kl;
      double* dst = sKV + j * SKV;
      if (kl >= nloc) {
#pragma unroll
        for (int e = 0; e < (D + 31) / 32; ++e)
          if (D % 32 == 0 || lane + 32 * e < D) dst[lane + 32 * e] = 0.0;
      } else if (tg < ctx) {
#pragma unroll
        for (int e = 0; e < (D / 2 + 31) / 32; ++e) {
          const int d = lane + 32 * e;
          if ((D / 2) % 32 && d >= D / 2) break;
          const unsigned byte = raw[j * (D / 2) + d];
          // (n − z)·s in f32, as the plain version dequantizes; the code
          // n is exact as (2^23 + n) − 2^23, without a conversion
          const float n_lo =
              __int_as_float(0x4B000000 | (byte & 15)) - 8388608.f;
          const float n_hi =
              __int_as_float(0x4B000000 | (byte >> 4)) - 8388608.f;
          dst[d] = __fmul_rn(__fsub_rn(n_lo, sc[D + d]), sc[d]);
          dst[d + D / 2] = __fmul_rn(__fsub_rn(n_hi, sc[D + d + D / 2]),
                                     sc[d + D / 2]);
        }
      } else {
        const float* src = (val ? a.vn : a.kn) +
            ((static_cast<long>(b) * a.c + (tg - ctx)) * a.hkv + h) * D;
#pragma unroll
        for (int e = 0; e < (D + 31) / 32; ++e)
          if (D % 32 == 0 || lane + 32 * e < D)
            dst[lane + 32 * e] = src[lane + 32 * e];
      }
    }
    __syncthreads();
  };

  // ---- scores, once: s = f32(Σ_f64 q·k) / √D, masked to NEG_INF.
  // Lane (gi, t) ends with keys gi, gi+8 of each 16-key subtile × rows
  // 2t, 2t+1 of the warp's 8.
  constexpr int NSUB = 4 / WK;       // 16-key subtiles of a tile per warp
  static_assert(WK * R <= DN_MAXWR, "tiling");
  constexpr int NCH = 4 / NSUB;      // accumulator chains per subtile
  __syncthreads();                   // sQ, sPage and sScale are written
  if (ntile > 0) prefetch(0);
  float mrow[2] = {NEG_INF, NEG_INF};
  {
    double qb[D / 8][2];     // B fragments: q[row gi][8kk + t (+4)]
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qb[kk][0] = sQ[(rbase + gi) * D + 8 * kk + t];
      qb[kk][1] = sQ[(rbase + gi) * D + 8 * kk + t + 4];
    }
    int qi2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qi2[i] = (r0 + rbase + 2 * t + i) / grp;
    for (int k0 = 0; k0 < ntile * KT; k0 += KT) {
      stage(k0 / KT);
      const int kw = k0 + 16 * NSUB * wk;    // this warp's first key
      float s4[NSUB][4];
      if (dead(kw)) {                        // warp-uniform
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s4[j][e] = NEG_INF;
      } else {
        // four independent MMA chains (by subtile, else by k step); their
        // f64 partials add
        double acc[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;
        const double* kp = sKV + (kw - k0 + gi) * SKV + t;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
          for (int j = 0; j < NSUB; ++j) {
            const double* k8 = kp + 16 * j * SKV + 8 * kk;
            dmma(acc[j * NCH + kk % NCH], k8[0], k8[8 * SKV], k8[4],
                 k8[8 * SKV + 4], qb[kk][0], qb[kk][1]);
          }
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            double v = acc[j * NCH][e];
#pragma unroll
            for (int c = 1; c < NCH; ++c) v += acc[j * NCH + c][e];
            const int kl = kw + 16 * j + gi + 8 * (e >> 1), tg = lo + kl;
            const int q_i = qi2[e & 1];
            const bool valid = kl < nloc && (tg < ctx || (tg - ctx <= q_i &&
                                                          tg - ctx < qlen));
            s4[j][e] = valid ? __fdiv_rn(static_cast<float>(v), sqrt_d)
                             : NEG_INF;
          }
      }
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e & 1;
          scores[static_cast<long>(rbase + 2 * t + i) * a.sstride + kw +
                 16 * j + gi + 8 * (e >> 1)] = s4[j][e];
          mrow[i] = fmaxf(mrow[i], s4[j][e]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {       // over the 8 lanes of a column
    mrow[i] = fmaxf(mrow[i], __shfl_xor_sync(0xffffffffu, mrow[i], 4));
    mrow[i] = fmaxf(mrow[i], __shfl_xor_sync(0xffffffffu, mrow[i], 8));
    mrow[i] = fmaxf(mrow[i], __shfl_xor_sync(0xffffffffu, mrow[i], 16));
    if (gi == 0) sMaxP[wk * R + rbase + 2 * t + i] = mrow[i];
  }
  cluster_sync();
  if (tid < R) {              // the row's max over every block and warp
    float m = NEG_INF;
#pragma unroll
    for (int rk = 0; rk < 8; ++rk) {
      if (rk >= nsplit) break;
      const float* src = remote(sMaxP, rk);
      for (int w = 0; w < WK; ++w) m = fmaxf(m, src[w * R + tid]);
    }
    sM[tid] = m;
  }
  __syncthreads();

  // ---- e = f32(exp_f64(s − M)) in place, partial Σ_f64 e: the block's
  // threads in groups of TPR per row, each over keys TPR apart
  {
    constexpr int TPR = DN_THREADS / R;
    const int rr = tid / TPR, j0 = tid % TPR;
    const float m = sM[rr];
    float* sr = scores + static_cast<long>(rr) * a.sstride;
    double sum4[4] = {0.0, 0.0, 0.0, 0.0};   // four chains: the exps overlap
    for (int k4 = j0; k4 < ntile * KT; k4 += 4 * TPR) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kl = k4 + u * TPR;     // KT is a multiple of 4·TPR
        const float s = sr[kl];
        // a masked score's exponential is exactly 0: skip the f64 exp
        const float e = s <= NEG_INF ? 0.f : exp_f64(s - m);
        sr[kl] = e;
        sum4[u] += static_cast<double>(e);
      }
    }
    double sum = (sum4[0] + sum4[1]) + (sum4[2] + sum4[3]);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (j0 == 0) sSumP[rr] = sum;
  }
  cluster_sync();
  if (tid < R) {              // L = f32(Σ e) over every block
    double l = 0.0;
#pragma unroll
    for (int rk = 0; rk < 8; ++rk) {
      if (rk >= nsplit) break;
      l += remote(sSumP, rk)[tid];
    }
    sL[tid] = static_cast<float>(l);
  }
  // (stage() begins with a barrier, which orders sL before its readers)

  // ---- Oᵀ = Σ_f64 Vᵀ·(e / L)ᵀ over V tiles staged once; lane (gi, t)
  // ends with head channels 16n + gi (+8) × rows 2t, 2t+1
  double oacc[D / 16][4];
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0;
  const float* prow = scores + static_cast<long>(rbase + gi) * a.sstride;
  for (int k0 = 0; k0 < ntile * KT; k0 += KT) {
    stage(ntile + k0 / KT);
    const float l = sL[rbase + gi];
#pragma unroll
    for (int ks = wk * (8 / WK); ks < (wk + 1) * (8 / WK); ++ks) {
      const int kb = k0 + 8 * ks;
      if (dead(kb)) continue;               // warp-uniform
      const double p0 = static_cast<double>(__fdiv_rn(prow[kb + t], l));
      const double p1 = static_cast<double>(__fdiv_rn(prow[kb + t + 4], l));
      const double* vp = sKV + (8 * ks + t) * SKV + gi;
#pragma unroll
      for (int n = 0; n < D / 16; ++n)
        dmma(oacc[n], vp[16 * n], vp[16 * n + 8], vp[4 * SKV + 16 * n],
             vp[4 * SKV + 16 * n + 8], p0, p1);
    }
  }
  __syncthreads();            // every warp is done with the last V tile
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sOut[(wk * R + rbase + 2 * t + (e & 1)) * D + 16 * n + gi +
           8 * (e >> 1)] = oacc[n][e];
  if (WK > 1) {               // the warps' partials, summed in the block
    __syncthreads();
    for (int i = tid; i < R * D; i += DN_THREADS) {
      double v = sOut[i];
#pragma unroll
      for (int w = 1; w < WK; ++w) v += sOut[w * R * D + i];
      sOut[i] = v;
    }
  }
  cluster_sync();
  // each block of the cluster rounds its share of the tile's outputs
  for (int i = rank * DN_THREADS + tid; i < R * D; i += nsplit * DN_THREADS) {
    const int r = r0 + i / D;
    if (r >= cg_rows) continue;
    double v = 0.0;
#pragma unroll
    for (int rk = 0; rk < 8; ++rk) {
      if (rk >= nsplit) break;
      v += remote(sOut, rk)[i];
    }
    a.out[qrow(r) + i % D] = r < qlen * grp ? static_cast<float>(v) : 0.f;
  }
  if (nsplit > 1) cg::this_cluster().sync();   // peers may still read us
}

template <int WR, bool CHUNK, bool PAGED = true, int HD = D>
cudaError_t launch_dense(const DenseArgs& a, int b, int split, int smem,
                         cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_attention_kernel<WR, CHUNK, PAGED, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DN_SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const int rows = 8 * WR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (a.c * a.g + rows - 1) / rows, b * a.hkv);
  cfg.blockDim = dim3(dn_threads(WR));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg,
                            dense_attention_kernel<WR, CHUNK, PAGED, HD>, a);
}

// The row tile (8, 16 or 32 rows) of head_dim HD's instantiation.
template <bool CHUNK, bool PAGED, int HD>
cudaError_t launch_dense_rows(const DenseArgs& a, int b, int rows, int split,
                              int smem, cudaStream_t stream) {
  return rows == 8 ? launch_dense<1, CHUNK, PAGED, HD>(a, b, split, smem,
                                                      stream)
         : rows == 16
             ? launch_dense<2, CHUNK, PAGED, HD>(a, b, split, smem, stream)
             : launch_dense<4, CHUNK, PAGED, HD>(a, b, split, smem, stream);
}

// The instantiation for head_dim d (head_dim_built(d) checked first).
template <bool CHUNK, bool PAGED>
cudaError_t launch_dense_d(const DenseArgs& a, int d, int b, int rows,
                           int split, int smem, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_dense_rows<CHUNK, PAGED, 32>(a, b, rows, split,
                                                        smem, stream);
    case 64: return launch_dense_rows<CHUNK, PAGED, 64>(a, b, rows, split,
                                                        smem, stream);
    case 80: return launch_dense_rows<CHUNK, PAGED, 80>(a, b, rows, split,
                                                        smem, stream);
    default: return launch_dense_rows<CHUNK, PAGED, 128>(a, b, rows, split,
                                                         smem, stream);
  }
}

// The plan dense_plan (kernels/kv4_attention.py) worked out: rows per
// block (8, 16 or 32), split (cluster size, 1..8), sstride (the score
// rows' stride in floats), smem (dynamic shared bytes) for head_dim d, a
// built one; scores in scratch (non-null) or in shared memory.
bool dense_plan_ok(int rows, int split, int sstride, int smem,
                   bool scratch, int d) {
  return head_dim_built(d) && (rows == 8 || rows == 16 || rows == 32) &&
         split >= 1 && split <= 8 && sstride % 32 == 8 &&
         smem <= DN_SMEM_MAX &&
         smem == dn_fixed(d) + (scratch ? 0 : rows * sstride * 4);
}


}  // namespace

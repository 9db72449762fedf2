// Paged KV4 chunked-prefill attention under the reference's two grid
// schedules, and the work-queue decode on the work-queue kernel.
//
// paged_kv4_prefill_wq (K9) — replaces repro/kernels/paged_attention.py:
// paged_kv4_prefill_attention_wq (_paged_kv4_prefill_wq_kernel and the
// combine_work_partials after it): the whole op in one launch — the affine
// pre-fold of the queries, one flash partial (acc, l, m) per work-queue
// descriptor item, and the split-KV combine of each row's partials,
// written to the [B, C, Hq, D] output.
//
// Descriptor item (row, page, count, kind), row = seq·Hkv + kv_head:
//   kind 0 — one int4 history page, in nibble space: s = q̃·n_k − c over
//            positions < count, with q̃ = (q·s_k)·(1/√D) and c = Σ q̃·z_k,
//            partial value Σ p·n_v·s_v − (Σp)·s_v·z_v (V affine folded in);
//   kind 1 — the row's in-flight fp chunk: s = (q·(1/√D))·k over keys
//            kj ≤ qi and kj < count (causal), value Σ p·v;
//   kind 2 — a speculating decode row's chunk: as kind 1 over kj = qi
//            alone (each query its own in-flight key);
//   kind WQ_CAUSAL + o (> 2) — that row's page, as kind 0 over positions
//            < min(count, qi + o), o = ctx − the page's first position:
//            query qi of a verify chunk reads the chunk's earlier keys
//            from the pages they were written to, as the decode step at
//            ctx + qi reads them, so the two compute the same partials
//            (a key a query does not see adds an exact 0 to every sum);
// with p = e^(s − m), m the partial's max, masked scores NEG_INF = −1e30.
// The combine: M = max m_i, w_i = e^(m_i − M), out = Σ w_i·acc_i /
// max(Σ w_i·l_i, 1e-30). Exact arithmetic, as the plain version computes
// on the card: every dot product and sum (c, the scores, Σp, Σp·v, the
// combine's sums) in f64 rounded once to f32, the exponentials the f64 ones
// rounded, every other step the plain version's f32 operations in its
// order (__fmul_rn, __fsub_rn: no contraction into FMAs). The partials are
// rounded to f32 where the plain version rounds them.
//
// Bound on the H100: operations for a prefill chunk (~4·D per valid
// (query, key) pair, at the f64 rate the exact contract asks for); at
// decode (C = 1) the int4 bytes of each page, read once, where the launch
// and the latency of a block's phases set the time. Design: the host
// (kernels/paged_attention.py:work_plan, once per engine step) turns the
// descriptors into jobs — one block per (item, row tile), tiles of 8, 16
// or 32 query rows sized to the batch's largest q_len·G, only the tiles a
// row's q_len reaches; plus zero jobs for the output rows no item covers.
// A job folds its own query tile, stages its page (cp.async) or chunk keys
// as f64 in shared memory, scores them on the f64 tensor cores as the
// dense kernel does (dense_attention.cuh: Sᵀ = K·Qᵀ, Oᵀ = Vᵀ·Pᵀ, warps
// split the rows and the keys), and writes its f32 partial to a scratch
// buffer that stays in L2. It then bumps its (row, tile)'s arrival
// counter; the block that arrives last reads the group's partials in
// descriptor order, combines them in f64 and resets the counter. The
// combine reads the partials in a fixed order, so which block arrives last
// does not change a bit. Spreading over items is the point of the work
// queue: a long row's pages run on many SMs at once.
//
// paged_kv4_decode_wq (K8) — replaces paged_kv4_decode_attention_wq
// (_paged_kv4_decode_wq_kernel, with the pre-fold before it and the
// combine and V affine after it): the same kernel with DECODE set, at
// C = 1 over page items only (work_plan at C = 1: one job per item and
// row tile of 8, 16 or 32 rows, G query rows valid, any G; zero jobs for
// the rows no item covers). Unlike K9's
// page items, the partial stays in nibble space, (Σ p·n_v, Σ p, m), as the
// reference's; the last block of a row combines its partials and then
// applies the V affine s_v·comb − s_v·z_v (two f32 products, one f32
// subtraction), and a zero job writes the affine of an empty combine,
// s_v·0 − s_v·z_v. The scales may differ per batch row (batch stride sb).
// Any page size: a page of more than 64 keys is several key tiles, and
// its scores go to scratch past shared memory, as K9's do. Bound on the
// H100: bytes, the int4 K and V of every valid key read once (~0.8 µs for
// the Llama-3-8B decode batch of chip_smoke.py), so the launch and the
// latency of one job's phases set the time.
//
// paged_kv4_prefill_dense (K7) — replaces paged_kv4_prefill_attention
// (dense schedule): see dense_attention.cuh.
#include "dense_attention.cuh"

namespace {

constexpr int WQ_WCH = 64;   // items whose combine weights one pass stages
constexpr int WQ_SELF = 2;           // kernels/paged_attention.py KIND_SELF
constexpr int WQ_CAUSAL = 1 << 16;   // KIND_CAUSAL (any kind past WQ_SELF)
// shared bytes besides the scores at head_dim d: the staged tile, two raw
// tiles, the head's scales, the row reductions and the arrival flag
__host__ __device__ constexpr int wq_fixed(int d) {
  return dn_kv(d) + dn_raw(d) + 4 * d * 4 + DN_MAXWR * 4 + 4 * DN_MAXR * 4 +
         16;
}
static_assert(wq_fixed(128) == 78608 && wq_fixed(80) == 50192 &&
              wq_fixed(64) == 40720 && wq_fixed(32) == 21776,
              "smem layout (kernels/paged_attention.py:wq_fixed_smem)");

// desc [W, 4], jobs [J, 4] (work_plan); q [B, C, Hq, D] f32 or bf16;
// kn/vn f32 [B, C, Hkv, D] (K9 only); ks/kz/vs/vz f32 [Hkv, D] at batch
// stride sb floats (0: shared); part f32 [compute jobs][R][D + 2] (acc,
// l, m); arrive int32 [≥ compute jobs], zero at launch and left zero;
// scratch f32 [compute jobs][R][sstride] when the scores do not fit in
// shared memory, else null.
struct WqArgs {
  const int* desc; const int* jobs;
  const void* q; const float* kn; const float* vn;
  const float* ks; const float* kz; const float* vs; const float* vz;
  const uint8_t* k_pool; const uint8_t* v_pool;
  float* out; float* part; int* arrive; float* scratch;
  int c, g, hkv, ps, sstride, q_bf16, sb;
};

// Job (item, tile, first, count): the partial of descriptor item `item`
// for query rows [tile·R, tile·R + R) of its row, then — if last of the
// `count` jobs first.. of that (row, tile) — their combine. Job (−1, t0,
// row, t1): zeros (DECODE: −s_v·z_v) for tiles [t0, t1) of row `row`.
// gridDim.x = J; the compute jobs come first, job j's partial in scratch
// slot j. DECODE (K8): every item is a page, its partial in nibble space,
// the V affine after the combine. HD: the head_dim of this instantiation
// (head_dim_built), which the block-scope D, SKV, DN_KV and DN_RAW follow.
template <int WR, bool DECODE, int HD>
__global__ void __launch_bounds__(dn_threads(WR)) prefill_wq_kernel(
    WqArgs a) {
  constexpr int D = HD, SKV = dn_skv(HD), DN_KV = dn_kv(HD),
                DN_RAW = dn_raw(HD);
  constexpr int R = 8 * WR, WK = dn_wk(WR), NT = dn_threads(WR);
  static_assert(D % 16 == 0 && WK * R * D <= KT * SKV &&
                    WQ_WCH * DN_MAXR * 4 <= DN_KV && R * D % NT == 0,
                "head_dim tiles; the warps' partial outputs and the "
                "combine weights fit sKV; the combine's outputs per thread");
  constexpr long PSZ = R * (D + 2);         // floats of one partial
  extern __shared__ __align__(16) unsigned char smem[];
  double* sKV = reinterpret_cast<double*>(smem);            // [KT][SKV]
  unsigned char* sRaw = smem + DN_KV;                       // [2][KT][D/2]
  float* sScale = reinterpret_cast<float*>(sRaw + DN_RAW);  // ks kz vs vz
  float* sMaxP = sScale + 4 * D;                            // [WK][R]
  float* sM = sMaxP + DN_MAXWR;
  float* sL = sM + DN_MAXR;
  float* sC = sL + DN_MAXR;
  float* sDen = sC + DN_MAXR;
  int* sFlag = reinterpret_cast<int*>(sDen + DN_MAXR);
  float* sQ = reinterpret_cast<float*>(smem);   // [R][D] before the keys
  double* sOut = sKV;          // [WK][R][D] after the last V tile
  float* sW = reinterpret_cast<float*>(smem);   // [WQ_WCH][R] in the combine

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wk = warp / WR;
  const int4 job = reinterpret_cast<const int4*>(a.jobs)[blockIdx.x];
  const int grp = a.g, cg_rows = a.c * grp, hq = a.hkv * grp;
  // query row r of (b, h) lives at out/q[b, r / G, h·G + r % G, :]
  auto qrow = [&](int b, int h, int r) {
    return ((static_cast<long>(b) * a.c + r / grp) * hq + h * grp + r % grp)
           * D;
  };

  // the V affine of the plain version, s_v·o − s_v·z_v in f32
  auto v_affine = [](float o, float vsc, float vzc) {
    return __fsub_rn(__fmul_rn(vsc, o), __fmul_rn(vsc, vzc));
  };
  if (job.x < 0) {            // zero job: an empty combine's output
    const int b = job.z / a.hkv, h = job.z % a.hkv;
    const long so = static_cast<long>(b) * a.sb + h * D;
    const int end = min(job.w * R, cg_rows) * (D / 4);
    for (int i = job.y * R * (D / 4) + tid; i < end; i += NT) {
      const int c4 = 4 * (i % (D / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (DECODE) {
        const float4 s = *reinterpret_cast<const float4*>(a.vs + so + c4);
        const float4 z = *reinterpret_cast<const float4*>(a.vz + so + c4);
        v = make_float4(v_affine(0.f, s.x, z.x), v_affine(0.f, s.y, z.y),
                        v_affine(0.f, s.z, z.z), v_affine(0.f, s.w, z.w));
      }
      *reinterpret_cast<float4*>(a.out + qrow(b, h, i / (D / 4)) + c4) = v;
    }
    return;
  }
  const int4 it = reinterpret_cast<const int4*>(a.desc)[job.x];
  const int page = it.y, count = it.z;
  const bool causal = !DECODE && it.w > WQ_SELF;
  const bool hist = DECODE || it.w == 0 || causal;
  const bool self_only = !DECODE && it.w == WQ_SELF;
  // a causal page's keys below qi + off (else every key below count)
  const int off = causal ? it.w - WQ_CAUSAL : a.ps;
  const int b = it.x / a.hkv, h = it.x % a.hkv;
  const long so = static_cast<long>(b) * a.sb + h * D;   // the row's scales
  const int r0 = job.y * R, first = job.z, cnt = job.w;
  const float sm = __frcp_rn(__fsqrt_rn(static_cast<float>(D)));   // 1/√D
  const int last_qi = (min(r0 + R, cg_rows) - 1) / grp;
  const int nk = hist ? min(count, a.ps) : min(min(count, a.c), last_qi + 1);
  const int ntile = (nk + KT - 1) / KT;
  float* scores = a.scratch == nullptr
      ? reinterpret_cast<float*>(sFlag + 4)
      : a.scratch + static_cast<long>(blockIdx.x) * R * a.sstride;
  const int rbase = 8 * wr;                 // the warp's first row
  const int warp_qi = (min(r0 + rbase + 7, cg_rows - 1)) / grp;

  for (int i = tid; i < 4 * D; i += NT) {
    const float* src = i < D ? a.ks : i < 2 * D ? a.kz : i < 3 * D ? a.vs
                                                                   : a.vz;
    sScale[i] = src[so + i % D];
  }
  // the pre-fold of the tile's queries: (q·s_k)·(1/√D) for a history
  // page, q·(1/√D) for the chunk — the plain version's two roundings
  for (int i = tid; i < R * D / 4; i += NT) {
    const int r = r0 + i / (D / 4), c4 = 4 * (i % (D / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < cg_rows) {
      v = load_q4(a.q, qrow(b, h, r) + c4, a.q_bf16);
      if (hist) {
        const float4 s = *reinterpret_cast<const float4*>(a.ks + so + c4);
        v = make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y),
                        __fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w));
      }
      v = make_float4(__fmul_rn(v.x, sm), __fmul_rn(v.y, sm),
                      __fmul_rn(v.z, sm), __fmul_rn(v.w, sm));
    }
    *reinterpret_cast<float4*>(sQ + 4 * i) = v;
  }
  // the keys any row of this warp sees lie below wlim: a key step
  // [k, ..) at or past it is dead
  const int wlim = DECODE ? nk : min(nk, hist ? warp_qi + off : warp_qi + 1);
  auto dead = [&](int k) { return k >= wlim; };

  // the tile stream: K tiles 0..ntile−1, then V tiles; a page's packed
  // bytes go to raw buffer s & 1 by cp.async one tile ahead (16-byte
  // copies where a packed row is whole 16-byte pieces, 8-byte ones for the
  // 40-byte rows of D = 80), chunk keys are read straight from global
  // memory when staged
  constexpr int CB = (D / 2) % 16 == 0 ? 16 : 8;
  constexpr int CPR = D / 2 / CB, NCOPY = KT * CPR;
  auto prefetch = [&](int s) {
    if (hist) {
      const int k0 = (s % ntile) * KT;
      const uint8_t* pool = s < ntile ? a.k_pool : a.v_pool;
      unsigned char* raw = sRaw + (s & 1) * KT * (D / 2);
#pragma unroll
      for (int u = 0; u < (NCOPY + NT - 1) / NT; ++u) {
        const int i = tid + u * NT;
        // unsigned, so a power-of-two CPR divides by a shift and a mask
        const int j = static_cast<unsigned>(i) / CPR,
                  c = static_cast<unsigned>(i) % CPR, kl = k0 + j;
        if ((NCOPY % NT == 0 || i < NCOPY) && kl < nk) {
          const long off = ((static_cast<long>(page) * a.ps + kl) * a.hkv + h)
                           * (D / 2) + CB * c;
          cp_async<CB>(raw + j * (D / 2) + CB * c, pool + off, true);
        }
      }
    }
    cp_commit();
  };
  // stage tile s into sKV as f64: nibble codes, or the chunk's f32 keys
  auto stage = [&](int s) {
    const bool val = s >= ntile;
    const int k0 = (s % ntile) * KT;
    cp_wait<0>();
    __syncthreads();   // tile s landed; the previous tile is consumed
    if (s + 1 < 2 * ntile) prefetch(s + 1);
    const unsigned char* raw = sRaw + (s & 1) * KT * (D / 2);
    for (int j = warp; j < KT; j += NT / 32) {
      const int kl = k0 + j;
      double* dst = sKV + j * SKV;
      if (kl >= nk) {
#pragma unroll
        for (int e = 0; e < (D + 31) / 32; ++e)
          if (D % 32 == 0 || lane + 32 * e < D) dst[lane + 32 * e] = 0.0;
      } else if (hist) {
#pragma unroll
        for (int e = 0; e < (D / 2 + 31) / 32; ++e) {
          const int d = lane + 32 * e;
          if ((D / 2) % 32 && d >= D / 2) break;
          const unsigned byte = raw[j * (D / 2) + d];
          dst[d] = static_cast<double>(byte & 15u);
          dst[d + D / 2] = static_cast<double>(byte >> 4);
        }
      } else {
        const float* src = (val ? a.vn : a.kn) +
            ((static_cast<long>(b) * a.c + kl) * a.hkv + h) * D;
#pragma unroll
        for (int e = 0; e < (D + 31) / 32; ++e)
          if (D % 32 == 0 || lane + 32 * e < D)
            dst[lane + 32 * e] = src[lane + 32 * e];
      }
    }
    __syncthreads();
  };

  __syncthreads();                   // sQ and sScale are written
  if (ntile > 0) prefetch(0);
  if (hist) {                        // c = f32(Σ_f64 q̃·z_k), per row
    constexpr int TPR = NT / R;
    const int rr = tid / TPR, j0 = tid % TPR;
    double s = 0.0;
    for (int ch = j0; ch < D; ch += TPR)
      s = fma(static_cast<double>(sQ[rr * D + ch]),
              static_cast<double>(sScale[D + ch]), s);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (j0 == 0) sC[rr] = static_cast<float>(s);
  }

  // ---- scores, once: s = f32(Σ_f64 q̃·n) − c or f32(Σ_f64 (q/√D)·k),
  // masked to NEG_INF. Lane (gi, t) ends with keys gi, gi+8 of each
  // 16-key subtile × rows 2t, 2t+1 of the warp's 8.
  constexpr int NSUB = 4 / WK;       // 16-key subtiles of a tile per warp
  static_assert(WK * R <= DN_MAXWR, "tiling");
  constexpr int NCH = 4 / NSUB;      // accumulator chains per subtile
  float mrow[2] = {NEG_INF, NEG_INF};
  {
    double qb[D / 8][2];     // B fragments: q[row gi][8kk + t (+4)]
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qb[kk][0] = sQ[(rbase + gi) * D + 8 * kk + t];
      qb[kk][1] = sQ[(rbase + gi) * D + 8 * kk + t + 4];
    }
    // the keys [lo, hi) each of the lane's two rows sees: a page's below
    // count (and, a verify row's, below qi + off), a chunk's up to qi
    // (kind 2: qi alone)
    int lo2[2], hi2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = (r0 + rbase + 2 * t + i) / grp;
      lo2[i] = self_only ? qi : 0;
      hi2[i] = DECODE ? nk : min(nk, hist ? qi + off : qi + 1);
    }
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
            const int kl = kw + 16 * j + gi + 8 * (e >> 1);
            const bool valid = kl >= lo2[e & 1] && kl < hi2[e & 1];
            const float sv = static_cast<float>(v);
            s4[j][e] = !valid ? NEG_INF
                       : hist ? __fsub_rn(sv, sC[rbase + 2 * t + (e & 1)])
                              : sv;
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
  __syncthreads();
  if (tid < R) {              // the row's max m over the key warps
    float m = NEG_INF;
    for (int w = 0; w < WK; ++w) m = fmaxf(m, sMaxP[w * R + tid]);
    sM[tid] = m;
  }
  __syncthreads();

  // ---- e = f32(exp_f64(s − m)) in place, l = f32(Σ_f64 e): the block's
  // threads in groups of TPR per row, each over keys TPR apart
  {
    constexpr int TPR = NT / R;
    const int rr = tid / TPR, j0 = tid % TPR;
    const float m = sM[rr];
    float* sr = scores + static_cast<long>(rr) * a.sstride;
    double sum4[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k4 = j0; k4 < ntile * KT; k4 += 4 * TPR) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kl = k4 + u * TPR;     // KT is a multiple of 4·TPR
        const float s = sr[kl];
        const float e = s <= NEG_INF ? 0.f : exp_f64(s - m);
        sr[kl] = e;
        sum4[u] += static_cast<double>(e);
      }
    }
    double sum = (sum4[0] + sum4[1]) + (sum4[2] + sum4[3]);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (j0 == 0) sL[rr] = static_cast<float>(sum);
  }
  // (stage() begins with a barrier, which orders the e before their use)

  // ---- Oᵀ = Σ_f64 Vᵀ·eᵀ over V tiles staged once; lane (gi, t) ends with
  // head channels 16n + gi (+8) × rows 2t, 2t+1
  double oacc[D / 16][4];
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0;
  const float* prow = scores + static_cast<long>(rbase + gi) * a.sstride;
  for (int k0 = 0; k0 < ntile * KT; k0 += KT) {
    stage(ntile + k0 / KT);
#pragma unroll
    for (int ks = wk * (8 / WK); ks < (wk + 1) * (8 / WK); ++ks) {
      const int kb = k0 + 8 * ks;
      if (dead(kb)) continue;               // warp-uniform
      const double p0 = static_cast<double>(prow[kb + t]);
      const double p1 = static_cast<double>(prow[kb + t + 4]);
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
  __syncthreads();

  // ---- the partial, rounded as the plain version rounds it: acc =
  // f32(Σ e·v), for a K9 page then acc·s_v − l·(s_v·z_v) in f32
  float* pj = a.part + static_cast<long>(blockIdx.x) * PSZ;
  for (int i = tid; i < R * D; i += NT) {
    double v = sOut[i];
#pragma unroll
    for (int w = 1; w < WK; ++w) v += sOut[w * R * D + i];
    float o = static_cast<float>(v);
    if (hist && !DECODE) {
      const float vsc = sScale[2 * D + i % D], vzc = sScale[3 * D + i % D];
      o = __fsub_rn(__fmul_rn(o, vsc),
                    __fmul_rn(sL[i / D], __fmul_rn(vsc, vzc)));
    }
    pj[i] = o;
  }
  if (tid < R) {
    pj[R * D + tid] = sL[tid];
    pj[R * D + R + tid] = sM[tid];
  }

  // ---- arrival: the last of the group's blocks combines
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sFlag[0] = cnt == 1 || atomicAdd(a.arrive + first, 1) == cnt - 1;
  __syncthreads();
  if (!sFlag[0]) return;
  __threadfence();
  const float* pg = a.part + static_cast<long>(first) * PSZ;
  if (tid < R) {              // M = max(NEG_INF, max_i m_i)
    float mx = NEG_INF;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i)
      mx = fmaxf(mx, __ldcg(pg + i * PSZ + R * D + R + tid));
    sM[tid] = mx;
  }
  constexpr int EPT = R * D / NT;
  double num[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) num[k] = 0.0;
  double den = 0.0;
  for (int i0 = 0; i0 < cnt; i0 += WQ_WCH) {
    const int n = min(WQ_WCH, cnt - i0);
    __syncthreads();          // sM written / the previous weights consumed
    for (int j = tid; j < n * R; j += NT) {   // w = f32(exp_f64(m_i − M))
      const int r = j % R;
      sW[j] = exp_f64(__fsub_rn(
          __ldcg(pg + (i0 + j / R) * PSZ + R * D + R + r), sM[r]));
    }
    __syncthreads();
    if (tid < R)
      for (int i = 0; i < n; ++i)
        den = fma(static_cast<double>(sW[i * R + tid]),
                  static_cast<double>(
                      __ldcg(pg + (i0 + i) * PSZ + R * D + tid)), den);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const float* pa = pg + (i0 + i) * PSZ;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = tid + k * NT;
        num[k] = fma(static_cast<double>(sW[i * R + e / D]),
                     static_cast<double>(__ldcg(pa + e)), num[k]);
      }
    }
  }
  if (tid < R) sDen[tid] = fmaxf(static_cast<float>(den), 1e-30f);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = tid + k * NT, r = r0 + e / D;
    if (r < cg_rows) {
      float o = __fdiv_rn(static_cast<float>(num[k]), sDen[e / D]);
      if constexpr (DECODE)
        o = v_affine(o, sScale[2 * D + e % D], sScale[3 * D + e % D]);
      a.out[qrow(b, h, r) + e % D] = o;
    }
  }
  if (tid == 0 && cnt > 1) a.arrive[first] = 0;
}

template <int WR, bool DECODE, int HD>
cudaError_t launch_wq(const WqArgs& a, int njobs, int smem,
                      cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_wq_kernel<WR, DECODE, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DN_SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  prefill_wq_kernel<WR, DECODE, HD>
      <<<njobs, dn_threads(WR), smem, stream>>>(a);
  return cudaSuccess;
}

// The row tile (8, 16 or 32 rows) of head_dim HD's instantiation.
template <bool DECODE, int HD>
cudaError_t launch_wq_rows(const WqArgs& a, int rows, int njobs, int smem,
                           cudaStream_t stream) {
  return rows == 8 ? launch_wq<1, DECODE, HD>(a, njobs, smem, stream)
         : rows == 16 ? launch_wq<2, DECODE, HD>(a, njobs, smem, stream)
                      : launch_wq<4, DECODE, HD>(a, njobs, smem, stream);
}

// The instantiation for head_dim d (head_dim_built(d) checked first).
template <bool DECODE>
cudaError_t launch_wq_d(const WqArgs& a, int d, int rows, int njobs,
                        int smem, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_wq_rows<DECODE, 32>(a, rows, njobs, smem, stream);
    case 64: return launch_wq_rows<DECODE, 64>(a, rows, njobs, smem, stream);
    case 80: return launch_wq_rows<DECODE, 80>(a, rows, njobs, smem, stream);
    default: return launch_wq_rows<DECODE, 128>(a, rows, njobs, smem, stream);
  }
}

// The work_plan (kernels/paged_attention.py) of the jobs: rows per job (8,
// 16 or 32), sstride the score rows' stride in floats (≥ every job's keys
// rounded to 64, + 8), smem the dynamic shared bytes at head_dim d, a
// built one; scores in scratch (non-null) or in shared memory.
bool wq_plan_ok(int rows, int sstride, int smem, bool scratch, int d) {
  return head_dim_built(d) && (rows == 8 || rows == 16 || rows == 32) &&
         sstride % 32 == 8 && smem <= DN_SMEM_MAX &&
         smem == wq_fixed(d) + (scratch ? 0 : rows * sstride * 4);
}

}  // namespace

// desc int32 [W, 4]; jobs int32 [njobs, 4] (work_plan); q [B, C, Hq, D]
// (q_bf16: bf16, else f32); k/v_new f32 [B, C, hkv, D]; ks/kz/vs/vz f32
// [hkv, D]; pools uint8 [P, ps, hkv, D/2] → out f32 [B, C, Hq, D]. part,
// arrive and scratch as WqArgs says; the plan (rows, sstride, smem) as
// wq_plan_ok says. All contiguous; d is 32, 64, 80 or 128.
extern "C" int paged_kv4_prefill_wq(
    const int* desc, const int* jobs, int njobs, const void* q, int q_bf16,
    const float* kn, const float* vn, const float* ks, const float* kz,
    const float* vs, const float* vz, const uint8_t* k_pool,
    const uint8_t* v_pool, float* out, float* part, int* arrive,
    float* scratch, int c, int g, int hkv, int ps, int d, int rows,
    int sstride, int smem, cudaStream_t stream) {
  if (!wq_plan_ok(rows, sstride, smem, scratch, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (njobs > 0) {
    const WqArgs a{desc, jobs, q, kn, vn, ks, kz, vs, vz, k_pool, v_pool,
                   out, part, arrive, scratch, c, g, hkv, ps, sstride,
                   q_bf16, 0};
    const cudaError_t e =
        launch_wq_d<false>(a, d, rows, njobs, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// desc int32 [W, 4] (page items); jobs int32 [njobs, 4] (work_plan at
// C = 1); q [B, Hq, D] (q_bf16: bf16, else f32); ks/kz/vs/vz f32 [hkv, D]
// (sb 0) or [B, hkv, D] (sb hkv·D); pools uint8 [P, ps, hkv, D/2] → out f32
// [B, Hq, D]. part, arrive and scratch as WqArgs says; g ≥ 1 (any GQA
// group: the plan's rows are 8, 16 or 32, several tiles past 32), the plan
// as wq_plan_ok says. All contiguous; d is 32, 64, 80 or 128.
extern "C" int paged_kv4_decode_wq(
    const int* desc, const int* jobs, int njobs, const void* q, int q_bf16,
    const float* ks, const float* kz, const float* vs, const float* vz,
    int sb, const uint8_t* k_pool, const uint8_t* v_pool, float* out,
    float* part, int* arrive, float* scratch, int g, int hkv, int ps, int d,
    int rows, int sstride, int smem, cudaStream_t stream) {
  if (g < 1 || !wq_plan_ok(rows, sstride, smem, scratch, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (njobs > 0) {
    const WqArgs a{desc, jobs, q, nullptr, nullptr, ks, kz, vs, vz, k_pool,
                   v_pool, out, part, arrive, scratch, 1, g, hkv, ps,
                   sstride, q_bf16, sb};
    const cudaError_t e =
        launch_wq_d<true>(a, d, rows, njobs, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [B, C, Hq, D] (q_bf16: bf16, else f32); k/v_new f32 [B, C, hkv, D];
// ks/kz/vs/vz f32 [hkv, D]; pools uint8 [P, ps, hkv, D/2]; tables int32
// [B, np]; ctx/q_len int32 [B] → out f32 [B, C, Hq, D] (rows at or past
// q_len·G: 0). All contiguous; d is 32, 64, 80 or 128. The launch plan
// (kernels/kv4_attention.py:dense_plan) as dense_plan_ok says; scratch is
// null when the scores live in shared memory, else f32
// [B·hkv·tiles·split·rows·sstride].
extern "C" int paged_kv4_prefill_dense(
    const void* q, int q_bf16, const float* kn, const float* vn,
    const float* ks, const float* kz, const float* vs, const float* vz,
    const uint8_t* k_pool, const uint8_t* v_pool, const int* tables,
    const int* ctx_lens, const int* q_lens, float* out, float* scratch, int b,
    int c, int g, int hkv, int np, int ps, int d, int rows, int split,
    int sstride, int smem, cudaStream_t stream) {
  if (!dense_plan_ok(rows, split, sstride, smem, scratch, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && c > 0 && hkv > 0) {
    const DenseArgs a{q, kn, vn, ks, kz, vs, vz, k_pool, v_pool, tables,
                      ctx_lens, q_lens, out, scratch, c, g, hkv, np, ps,
                      sstride, q_bf16, 0};
    const cudaError_t e =
        launch_dense_d<true, true>(a, d, b, rows, split, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

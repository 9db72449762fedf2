// W4Ax GEMM: packed int4 weights × int4 (W4A4) or int8 (W4A8) activations.
//
// Replaces repro/kernels/w4ax_matmul.py: w4a4_matmul (_w4a4_kernel),
// w4a8_matmul (_w4a8_kernel) and w4ax_matmul_mixed (_w4ax_mixed_kernel).
// The split schedule (w4ax_matmul_split) launches one uniform kernel over
// the K4 prefix and one over the K8 tail; the mixed schedule launches ONE
// kernel whose K loop runs the nb4 INT4 blocks, then the nb8 INT8 blocks.
//
// Per 128-channel block b the int32 dot of the block is formed exactly,
// then scaled into an f32 accumulator, blocks in order, in the rounding
// order of the reference kernel it replaces:
//     uniform: acc[m, n] += f32(d) · (a_scale[m, b] · w_scale[b, n])
//     mixed:   acc[m, n] += (f32(d) · a_scale[m, b]) · w_scale[b, n]
// Hopper has no int4 tensor-core MMA, so nibbles become int8 operands of
// mma.sync m16n8k32 s8·s8→s32. With the default zero-extension unpack
// (mask and shift, values 0..15) the block dot is restored by the
// reference's correction algebra:
//     W4A4: d = dot(a', w') − 8·Σa' − 8·Σw' + 8192
//     W4A8: d = dot(a,  w') − 8·Σa
// ZEROEXT=false is the sign-extension ablation (values −8..7, no
// correction) of the uniform kernels; only zeroext is on the serving path,
// and the mixed kernel has no other (as the reference's).
//
// Bound on the H100: bytes at decode widths (M ≤ 16: the int4 weight panel,
// ~0.5 byte per weight, is read once and used by ≤ 16 rows), operations
// only for M in the thousands; at M = 256 the 2·M·N·K int8 operations and
// the weight bytes take about the same time.
//
// What held the first design back (one 64×64 tile, one synchronous
// 128-deep step at a time, weights transposed byte by byte into shared
// memory, row/column sums recomputed from shared memory, three of four
// warps idle at M ≤ 16), and what this one does instead:
// * A ring of raw bytes. Each stage holds K blocks of A and the packed W
//   panel exactly as they lie in device memory, brought in by 16-byte
//   cp.async (4-byte when N is not a multiple of 16), with the weight
//   scales; the next stages are in flight while one is multiplied, and one
//   __syncthreads guards each step. The activation scales of every block
//   are read once, before the K loop.
// * Unpacking in registers. Packed W byte j of a block holds k = j (low
//   nibble) and k = j + 64 (high): one 32-bit load of four packed rows
//   gives, after a 4×4 byte transpose (__byte_perm) and a mask or a
//   shift, the B fragments of k-steps kk and kk + 64 for four columns.
//   Packed A needs no transpose (a fragment is four consecutive k of one
//   row). The zero-extension sums are dp4a's of those same registers.
//   The weights keep their one layout in device memory.
// * Two kernels, chosen by M at launch (a dispatch on shape). Prefill
//   (M > 16): a 64×128 output tile per block of 8 warps (32×128 when
//   that would leave most of the card idle), one K block per stage.
//   Decode (M ≤ 16): a 16×64 tile per block of 8 warps that take whole K
//   blocks in turn (eight a round, the next round in flight); their exact
//   int32 block dots meet in shared memory and the block adds them in
//   order. A weight row comes in 64-byte pieces: a
//   16-byte piece per row costs one L1 wavefront per 16 bytes (the first
//   decode design, 16 columns per block, streamed several times slower).
// * The mixed kernel's choice of A layout is per K block, the same for
//   every thread that works on the block.
// * An MoE layer's experts in one launch (the *_experts entry points; the
//   reference vmaps these pallas_calls over the expert stack,
//   repro/layers/mlp.py _expert_linear): blockIdx.z picks the expert, whose
//   A rows, scales and output lie at z times one expert's size and whose W
//   and w_scale lie at z times the stack's expert strides. The tile is
//   chosen by the capacity C (an expert's rows); a block computes what
//   it computes for that expert alone, so the launch equals a loop of the
//   single-expert kernel bit for bit. Empty capacity slots are zero rows
//   (code 8 after act-quant) and are multiplied like any other.
// Not yet: wgmma (the prefill tile still issues mma.sync) and TMA.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int BK = 128;          // quantization block == one K step
constexpr int PB = BK / 2;       // packed bytes of a block (per A row, W rows)
constexpr int A4_ROW = PB + 16;  // padded shared rows (bytes): the fragment
constexpr int A8_ROW = BK + 16;  // loads of 8 rows × 4 lanes hit 32 banks

// How a kernel's A operand is laid out: all packed int4, all int8, or the
// mixed kernel's nb4 packed int4 blocks followed by nb8 int8 blocks.
enum AMode { A_INT4 = 0, A_INT8 = 1, A_MIXED = 2 };

// the kernels' arguments. a4: packed uint8 [m, nb4*64]; a8: int8
// [m, nb8*128] (nb4 = 0 for A_INT8, nb8 = 0 for A_INT4). W: packed uint8
// [(nb4+nb8)*64, n] (byte j of a block: k=j low, k=j+64 high), rows
// contiguous across the two parts; w_scale f32 [nb4+nb8, n]. Over experts
// (gridDim.z of them) A, its scales and out are [E, m, ·] contiguous and W,
// w_scale step by w_stride bytes and ws_stride floats an expert.
struct Args {
  const uint8_t* a4; const float* a4_scale;
  const uint8_t* a8; const float* a8_scale;
  const uint8_t* w; const float* w_scale;
  float* out; int m, n, nb4, nb8;
  long w_stride, ws_stride;
};

// the operands of expert blockIdx.z (z = 0: the arguments as they are)
__device__ __forceinline__ Args expert_args(Args p) {
  const long z = blockIdx.z;
  p.a4 += z * p.m * p.nb4 * PB;
  p.a4_scale += z * p.m * p.nb4;
  p.a8 += z * p.m * p.nb8 * BK;
  p.a8_scale += z * p.m * p.nb8;
  p.w += z * p.w_stride;
  p.w_scale += z * p.ws_stride;
  p.out += z * p.m * p.n;
  return p;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// nibbles → int8 lanes: values 0..15 (zero extension) or −8..7
template <bool ZEROEXT>
__device__ __forceinline__ uint32_t lo4(uint32_t x) {
  const uint32_t v = x & 0x0F0F0F0Fu;
  return ZEROEXT ? v : __vsub4(v, 0x08080808u);
}
template <bool ZEROEXT>
__device__ __forceinline__ uint32_t hi4(uint32_t x) {
  const uint32_t v = (x >> 4) & 0x0F0F0F0Fu;
  return ZEROEXT ? v : __vsub4(v, 0x08080808u);
}

__device__ __forceinline__ int bsum(uint32_t x, int s) {   // Σ of 4 int8
  return __dp4a(static_cast<int>(x), 0x01010101, s);
}

// rows r[e] (4 words of 4 bytes, one word per packed row) → c[q]: the 4
// bytes of column q, rows in order
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// whether K block b takes packed A
template <int MODE>
__device__ __forceinline__ bool is_packed(int b, int nb4) {
  return MODE == A_INT4 || (MODE == A_MIXED && b < nb4);
}

// stage A block b, rows [m0, m0+ROWS) ∩ [0, m), raw, into dst (A4_ROW or
// A8_ROW stride by layout). Rows past m are left as they are: they only
// reach outputs that are never stored.
template <int MODE, int ROWS>
__device__ __forceinline__ void load_a(const Args& p, uint8_t* dst, int b,
                                       int m0, int tid, int nth) {
  const int rows = min(ROWS, p.m - m0);
  if (is_packed<MODE>(b, p.nb4)) {
    const uint8_t* src = p.a4 + static_cast<long>(m0) * p.nb4 * PB +
                         static_cast<long>(b) * PB;
    for (int i = tid; i < rows * 4; i += nth) {
      const int r = i >> 2, c = i & 3;
      cp_async<16>(dst + r * A4_ROW + 16 * c,
                   src + static_cast<long>(r) * p.nb4 * PB + 16 * c, true);
    }
  } else {
    const uint8_t* src = p.a8 + static_cast<long>(m0) * p.nb8 * BK +
                         static_cast<long>(b - p.nb4) * BK;
    for (int i = tid; i < rows * 8; i += nth) {
      const int r = i >> 3, c = i & 7;
      cp_async<16>(dst + r * A8_ROW + 16 * c,
                   src + static_cast<long>(r) * p.nb8 * BK + 16 * c, true);
    }
  }
}

// stage the packed W rows of block b, columns [n0, n0+BN) ∩ [0, n), raw,
// into dst (row stride WROW bytes), and (sws not null) the block's column
// scales into sws; columns past n are left as they are (never stored)
template <int BN, int WROW>
__device__ __forceinline__ void load_w(const Args& p, uint8_t* dst,
                                       float* sws, int b, int n0, bool v16,
                                       int tid, int nth) {
  const uint8_t* wb = p.w + static_cast<long>(b) * PB * p.n + n0;
  const int cols = min(BN, p.n - n0);     // a multiple of 4
  if (v16) {
    for (int i = tid; i < PB * (BN / 16); i += nth) {
      const int j = i / (BN / 16), c = i % (BN / 16);
      if (16 * c < cols)
        cp_async<16>(dst + j * WROW + 16 * c,
                     wb + static_cast<long>(j) * p.n + 16 * c, true);
    }
  } else {
    for (int i = tid; i < PB * (BN / 4); i += nth) {
      const int j = i / (BN / 4), c = i % (BN / 4);
      if (4 * c < cols)
        cp_async<4>(dst + j * WROW + 4 * c,
                    wb + static_cast<long>(j) * p.n + 4 * c, true);
    }
  }
  if (sws == nullptr) return;
  // n % 4 == 0: a 16-byte run of scales is wholly in or out of range
  const float* ws = p.w_scale + static_cast<long>(b) * p.n + n0;
  for (int c = tid; c < BN / 4; c += nth)
    if (4 * c < cols) cp_async<16>(sws + 4 * c, ws + 4 * c, true);
}

// every block's activation scales of rows [m0, m0+ROWS), once, into
// sast[b][ROWS] (plain loads; the first barrier of the K loop orders them)
template <int MODE, int ROWS>
__device__ __forceinline__ void load_a_scales(const Args& p, float* sast,
                                              int m0, int tid, int nth) {
  const int nb = p.nb4 + p.nb8;
  for (int i = tid; i < nb * ROWS; i += nth) {
    const int b = i / ROWS, r = i % ROWS, row = min(m0 + r, p.m - 1);
    sast[i] = is_packed<MODE>(b, p.nb4)
                  ? p.a4_scale[static_cast<long>(row) * p.nb4 + b]
                  : p.a8_scale[static_cast<long>(row) * p.nb8 + b - p.nb4];
  }
}

// A fragments of one m16 row tile (rows r, r+8 of the staged block) for
// k-steps kk = 32·half (low) and kk + 64 (high)
template <bool ZEROEXT>
__device__ __forceinline__ void a_frags(const uint8_t* sa, bool packed,
                                        int r, int half, int t,
                                        uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  if (packed) {
    const uint8_t* p0 = sa + r * A4_ROW + 32 * half + 4 * t;
    const uint32_t w[4] = {lds32(p0), lds32(p0 + 8 * A4_ROW), lds32(p0 + 16),
                           lds32(p0 + 8 * A4_ROW + 16)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = lo4<ZEROEXT>(w[e]);
      hi[e] = hi4<ZEROEXT>(w[e]);
    }
  } else {
    const uint8_t* p0 = sa + r * A8_ROW + 32 * half + 4 * t;
    lo[0] = lds32(p0);
    lo[1] = lds32(p0 + 8 * A8_ROW);
    lo[2] = lds32(p0 + 16);
    lo[3] = lds32(p0 + 8 * A8_ROW + 16);
    hi[0] = lds32(p0 + 64);
    hi[1] = lds32(p0 + 8 * A8_ROW + 64);
    hi[2] = lds32(p0 + 80);
    hi[3] = lds32(p0 + 8 * A8_ROW + 80);
  }
}

// B words of 4 columns (byte column cb of the staged panel, stride WROW)
// for k-steps kk = 32·half and kk + 64: c0/c1[q] hold the packed bytes of
// column q at packed rows 32·half + 4t + (0..3) and 32·half + 16 + 4t + ...
template <int WROW>
__device__ __forceinline__ void b_words(const uint8_t* sw, int cb, int half,
                                        int t, uint32_t (&c0)[4],
                                        uint32_t (&c1)[4]) {
  const uint8_t* p0 = sw + (32 * half + 4 * t) * WROW + cb;
  uint32_t r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r0[e] = lds32(p0 + e * WROW);
    r1[e] = lds32(p0 + (16 + e) * WROW);
  }
  transpose4(r0, c0);
  transpose4(r1, c1);
}

// one output's block update in the plain version's rounding order
template <int MODE>
__device__ __forceinline__ float axpy(float acc, int d, float as, float ws) {
  const float fd = static_cast<float>(d);
  // explicit roundings (no FMA contraction): the same f32 ops in the same
  // block order as the plain version, so the two agree bit for bit
  return __fadd_rn(acc, MODE == A_MIXED ? __fmul_rn(__fmul_rn(fd, as), ws)
                                        : __fmul_rn(fd, __fmul_rn(as, ws)));
}

// Σ over the 4 lanes of a quad (the row sums of rows g, g+8; the column
// sums of logical column g)
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the zero-extension correction of one block dot
template <bool ZEROEXT>
__device__ __forceinline__ int correct(int d, int rs, int cs, bool packed) {
  if (!ZEROEXT) return d;
  d -= 8 * rs;
  return packed ? d + 8 * 8 * BK - 8 * cs : d;
}

// ------------------------------------------------ prefill kernel (M > 16)
// (32·MT)×128 output tile per block of 8 warps; warp (wm, wn) owns MT m16
// row tiles from row 16·MT·wm and columns 32·wn..; its subtile q holds, at
// logical column L, the panel column 32·wn + 4L + q (so one transposed word
// feeds its four subtiles). One K block per stage. MT = 2, or 1 (twice
// the blocks) when the grid would be under half a wave.
constexpr int P_THREADS = 256;
constexpr int P_BN = 128, P_STAGES = 4;
constexpr int P_WROW = P_BN + 16;
constexpr int P_W = PB * P_WROW;
template <int MT> struct PTile {
  static constexpr int BM = 32 * MT;
  static constexpr int A = BM * A8_ROW;           // A region (either layout)
  static constexpr int STAGE = A + P_W + P_BN * 4;
  static constexpr int RING = P_STAGES * STAGE;
};

template <int MODE, bool ZEROEXT, int MT>
__global__ void __launch_bounds__(P_THREADS) w4ax_prefill_kernel(Args pz) {
  const Args p = expert_args(pz);
  constexpr int P_BM = PTile<MT>::BM, P_A = PTile<MT>::A;
  constexpr int P_STAGE = PTile<MT>::STAGE, P_RING = PTile<MT>::RING;
  extern __shared__ __align__(16) uint8_t smem[];
  const float* sast = reinterpret_cast<const float*>(smem + P_RING);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * P_BM, n0 = blockIdx.x * P_BN;
  const int rb = 16 * MT * (warp & 1), cb = 32 * (warp >> 1);
  const int nb = p.nb4 + p.nb8;
  const bool v16 = p.n % 16 == 0;
  auto stage = [&](int s) { return smem + s * P_STAGE; };
  auto load = [&](int b) {
    uint8_t* st = stage(b % P_STAGES);
    load_a<MODE, P_BM>(p, st, b, m0, tid, P_THREADS);
    load_w<P_BN, P_WROW>(p, st + P_A, reinterpret_cast<float*>(st + P_A + P_W),
                         b, n0, v16, tid, P_THREADS);
  };

#pragma unroll
  for (int b = 0; b < P_STAGES - 1; ++b) {
    if (b < nb) load(b);
    cp_commit();
  }
  load_a_scales<MODE, P_BM>(p, reinterpret_cast<float*>(smem + P_RING), m0,
                            tid, P_THREADS);

  float facc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[i][q][e] = 0.f;

  for (int b = 0; b < nb; ++b) {
    cp_wait<P_STAGES - 2>();
    __syncthreads();   // block b landed; stage (b−1) % STAGES is free
    if (b + P_STAGES - 1 < nb) load(b + P_STAGES - 1);
    cp_commit();

    const uint8_t* sa = stage(b % P_STAGES);
    const uint8_t* sw = sa + P_A;
    const float* sws = reinterpret_cast<const float*>(sw + P_W);
    const float* sas = sast + b * P_BM;
    const bool packed = is_packed<MODE>(b, p.nb4);   // block-uniform

    int iacc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[i][q][e] = 0;
    int rsum[MT][2], csum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < MT; ++i) rsum[i][0] = rsum[i][1] = 0;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t alo[MT][4], ahi[MT][4], c0[4], c1[4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a_frags<ZEROEXT>(sa, packed, rb + 16 * i + g, half, t, alo[i],
                         ahi[i]);
        if (ZEROEXT) {
          rsum[i][0] = bsum(alo[i][0], bsum(alo[i][2],
                       bsum(ahi[i][0], bsum(ahi[i][2], rsum[i][0]))));
          rsum[i][1] = bsum(alo[i][1], bsum(alo[i][3],
                       bsum(ahi[i][1], bsum(ahi[i][3], rsum[i][1]))));
        }
      }
      b_words<P_WROW>(sw, cb + 4 * g, half, t, c0, c1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bl0 = lo4<ZEROEXT>(c0[q]), bl1 = lo4<ZEROEXT>(c1[q]);
        const uint32_t bh0 = hi4<ZEROEXT>(c0[q]), bh1 = hi4<ZEROEXT>(c1[q]);
        if (ZEROEXT)
          csum[q] = bsum(bl0, bsum(bl1, bsum(bh0, bsum(bh1, csum[q]))));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(iacc[i][q], alo[i], bl0, bl1);
          mma_s8(iacc[i][q], ahi[i], bh0, bh1);
        }
      }
    }

    // corrections, then the block's f32 update, blocks in order
    int rs[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) rs[i][0] = rs[i][1] = 0;
    if (ZEROEXT) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        rs[i][0] = quad_sum(rsum[i][0]);
        rs[i][1] = quad_sum(rsum[i][1]);
      }
    }
    float as[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      as[i][0] = sas[rb + 16 * i + g];
      as[i][1] = sas[rb + 16 * i + g + 8];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int cs0 = 0, cs1 = 0;
      if (ZEROEXT) {   // lane (g, ·) holds the sum of logical column g
        const int c = quad_sum(csum[q]);
        cs0 = __shfl_sync(0xffffffffu, c, 8 * t);
        cs1 = __shfl_sync(0xffffffffu, c, 8 * t + 4);
      }
      const int col0 = cb + 8 * t + q;
      const float ws0 = sws[col0], ws1 = sws[col0 + 4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e & 1;
          facc[i][q][e] = axpy<MODE>(
              facc[i][q][e],
              correct<ZEROEXT>(iacc[i][q][e], rs[i][e >> 1], odd ? cs1 : cs0,
                               packed),
              as[i][e >> 1], odd ? ws1 : ws0);
        }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + rb + 16 * i + g + 8 * (e >> 1);
        const int col = n0 + cb + 8 * t + 4 * (e & 1) + q;
        if (row < p.m && col < p.n)
          p.out[static_cast<long>(row) * p.n + col] = facc[i][q][e];
      }
}

// ------------------------------------------------- decode kernel (M ≤ 16)
// A 16×64 output tile per block of 8 warps. A round is eight K blocks:
// warp w multiplies block 8r + w whole (its eight n8 subtiles: subtile
// 4h + q holds, at logical column L, the tile column 32h + 4L + q) and
// writes the exact int32 block dot to shared memory; the block then adds
// the round's blocks to its f32 accumulators in order. Round r + 1 is in
// flight while round r is multiplied.
constexpr int D_THREADS = 256;
constexpr int D_BM = 16, D_BN = 64, D_NW = D_THREADS / 32;
constexpr int D_WROW = D_BN + 16;
constexpr int D_A = D_BM * A8_ROW;
constexpr int D_W = PB * D_WROW;
constexpr int D_SLOT = D_A + D_W;
constexpr int D_ROUND = D_NW * D_SLOT + D_NW * D_BN * 4;   // + scales
constexpr int D_DROW = D_BN + 4;                 // padded dot rows (ints)
constexpr int D_DOT = D_BM * D_DROW;             // one block's dots
constexpr int D_RING = 2 * D_ROUND + D_NW * D_DOT * 4;
constexpr int D_OUT = D_BM * D_BN / D_THREADS;   // outputs per thread

template <int MODE, bool ZEROEXT>
__global__ void __launch_bounds__(D_THREADS) w4ax_decode_kernel(Args pz) {
  const Args p = expert_args(pz);
  extern __shared__ __align__(16) uint8_t smem[];
  int* dots = reinterpret_cast<int*>(smem + 2 * D_ROUND);
  const float* sast = reinterpret_cast<const float*>(smem + D_RING);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * D_BN;
  const int nb = p.nb4 + p.nb8;
  const int nrounds = (nb + D_NW - 1) / D_NW;
  const bool v16 = p.n % 16 == 0;
  auto slot = [&](int r, int y) {
    return smem + (r & 1) * D_ROUND + y * D_SLOT;
  };
  auto load = [&](int r) {
    for (int y = 0; y < D_NW && r * D_NW + y < nb; ++y) {
      const int b = r * D_NW + y;
      load_a<MODE, D_BM>(p, slot(r, y), b, 0, tid, D_THREADS);
      load_w<D_BN, D_WROW>(p, slot(r, y) + D_A,
                           reinterpret_cast<float*>(slot(r, D_NW)) + y * D_BN,
                           b, n0, v16, tid, D_THREADS);
    }
  };
  float facc[D_OUT];
#pragma unroll
  for (int k = 0; k < D_OUT; ++k) facc[k] = 0.f;

  load(0);
  cp_commit();
  load_a_scales<MODE, D_BM>(p, reinterpret_cast<float*>(smem + D_RING), 0,
                            tid, D_THREADS);
  for (int r = 0; r < nrounds; ++r) {
    cp_wait<0>();
    __syncthreads();   // round r landed; round r − 1's dots are added
    if (r + 1 < nrounds) load(r + 1);
    cp_commit();

    const int b = r * D_NW + warp;
    if (b < nb) {      // warp-uniform
      const uint8_t* sa = slot(r, warp);
      const uint8_t* sw = sa + D_A;
      const bool packed = is_packed<MODE>(b, p.nb4);
      int iacc[8][4], csum[8], rsum[2] = {0, 0};
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        csum[s] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[s][e] = 0;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t alo[4], ahi[4];
        a_frags<ZEROEXT>(sa, packed, g, half, t, alo, ahi);
        if (ZEROEXT) {
          rsum[0] = bsum(alo[0], bsum(alo[2], bsum(ahi[0], bsum(ahi[2],
                                                                 rsum[0]))));
          rsum[1] = bsum(alo[1], bsum(alo[3], bsum(ahi[1], bsum(ahi[3],
                                                                 rsum[1]))));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t c0[4], c1[4];
          b_words<D_WROW>(sw, 32 * h + 4 * g, half, t, c0, c1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = 4 * h + q;
            const uint32_t bl0 = lo4<ZEROEXT>(c0[q]), bl1 = lo4<ZEROEXT>(c1[q]);
            const uint32_t bh0 = hi4<ZEROEXT>(c0[q]), bh1 = hi4<ZEROEXT>(c1[q]);
            if (ZEROEXT)
              csum[s] = bsum(bl0, bsum(bl1, bsum(bh0, bsum(bh1, csum[s]))));
            mma_s8(iacc[s], alo, bl0, bl1);
            mma_s8(iacc[s], ahi, bh0, bh1);
          }
        }
      }
      const int rs0 = ZEROEXT ? quad_sum(rsum[0]) : 0;
      const int rs1 = ZEROEXT ? quad_sum(rsum[1]) : 0;
      int* dw = dots + warp * D_DOT;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        int cs0 = 0, cs1 = 0;
        if (ZEROEXT) {   // lane (g, ·) holds the sum of logical column g
          const int c = quad_sum(csum[s]);
          cs0 = __shfl_sync(0xffffffffu, c, 8 * t);
          cs1 = __shfl_sync(0xffffffffu, c, 8 * t + 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e & 1;
          dw[(g + 8 * (e >> 1)) * D_DROW + 32 * (s >> 2) + 8 * t + 4 * odd +
             (s & 3)] = correct<ZEROEXT>(iacc[s][e], (e >> 1) ? rs1 : rs0,
                                         odd ? cs1 : cs0, packed);
        }
      }
    }
    __syncthreads();   // the round's block dots are written
    // output i = tid + 256k of the 16×64 tile takes the round's blocks
    // in order (loads first, then the updates)
    const int xn = min(D_NW, nb - r * D_NW);
    const float* sws = reinterpret_cast<const float*>(slot(r, D_NW));
#pragma unroll
    for (int k = 0; k < D_OUT; ++k) {
      const int i = tid + k * D_THREADS;
      const int row = i / D_BN, col = i % D_BN;
      if (row >= p.m) break;           // rows past m are never stored
      int dv[D_NW];
      float av[D_NW], wv[D_NW];
#pragma unroll
      for (int x = 0; x < D_NW; ++x) {
        const int xc = min(x, xn - 1);
        dv[x] = dots[xc * D_DOT + row * D_DROW + col];
        av[x] = sast[(r * D_NW + xc) * D_BM + row];
        wv[x] = sws[xc * D_BN + col];
      }
#pragma unroll
      for (int x = 0; x < D_NW; ++x)
        if (x < xn) facc[k] = axpy<MODE>(facc[k], dv[x], av[x], wv[x]);
    }
  }

#pragma unroll
  for (int k = 0; k < D_OUT; ++k) {
    const int i = tid + k * D_THREADS;
    const int row = i / D_BN, col = n0 + i % D_BN;
    if (row < p.m && col < p.n)
      p.out[static_cast<long>(row) * p.n + col] = facc[k];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int MODE, bool ZEROEXT>
int launch_tiles(const Args& a, int experts, cudaStream_t stream) {
  constexpr int SMEM_MAX = 232448;   // the H100's per-block opt-in
  // set once per instantiation; the attribute is per function
  static const cudaError_t ok =
      allow_smem(w4ax_prefill_kernel<MODE, ZEROEXT, 1>, SMEM_MAX) ||
              allow_smem(w4ax_prefill_kernel<MODE, ZEROEXT, 2>, SMEM_MAX)
          ? cudaErrorInvalidValue
          : allow_smem(w4ax_decode_kernel<MODE, ZEROEXT>, SMEM_MAX);
  if (ok != cudaSuccess) return static_cast<int>(ok);
  const int nb = a.nb4 + a.nb8;
  if (a.m <= D_BM) {
    const int smem = D_RING + nb * D_BM * 4;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    w4ax_decode_kernel<MODE, ZEROEXT>
        <<<dim3((a.n + D_BN - 1) / D_BN, 1, experts), D_THREADS, smem,
           stream>>>(a);
  } else if ((a.n + P_BN - 1) / P_BN * ((a.m + 63) / 64) * experts < 66) {
    // the 64-row tile would leave most of the card idle
    using T = PTile<1>;
    const int smem = T::RING + nb * T::BM * 4;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    w4ax_prefill_kernel<MODE, ZEROEXT, 1>
        <<<dim3((a.n + P_BN - 1) / P_BN, (a.m + T::BM - 1) / T::BM, experts),
           P_THREADS, smem, stream>>>(a);
  } else {
    using T = PTile<2>;
    const int smem = T::RING + nb * T::BM * 4;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    w4ax_prefill_kernel<MODE, ZEROEXT, 2>
        <<<dim3((a.n + P_BN - 1) / P_BN, (a.m + T::BM - 1) / T::BM, experts),
           P_THREADS, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const Args& a, int zeroext, cudaStream_t stream,
           int experts = 1) {
  if (a.n % 4 != 0 || (MODE == A_MIXED && !zeroext) || experts < 1 ||
      experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // each expert's W and w_scale start on a 16-byte boundary too (A's
  // experts do: their rows are whole 64- or 128-byte blocks)
  if (experts > 1 && (a.w_stride % 16 || a.ws_stride % 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the 16-byte cp.async reads whole rows from 16-byte boundaries
  for (const void* ptr : {static_cast<const void*>(a.a4),
                          static_cast<const void*>(a.a8),
                          static_cast<const void*>(a.w),
                          static_cast<const void*>(a.w_scale)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (a.m > 0 && a.n > 0 && a.nb4 + a.nb8 > 0) {
    if (zeroext) return launch_tiles<MODE, true>(a, experts, stream);
    if constexpr (MODE != A_MIXED)
      return launch_tiles<MODE, false>(a, experts, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a_packed uint8 [m, nb*64], a_scale f32 [m, nb], w_packed uint8 [nb*64, n],
// w_scale f32 [nb, n] → out f32 [m, n]; all contiguous, n % 4 == 0.
extern "C" int w4a4_matmul(const uint8_t* a_packed, const float* a_scale,
                           const uint8_t* w_packed, const float* w_scale,
                           float* out, int m, int n, int nb, int zeroext,
                           cudaStream_t stream) {
  return launch<A_INT4>({a_packed, a_scale, nullptr, nullptr, w_packed,
                         w_scale, out, m, n, nb, 0, 0, 0}, zeroext, stream);
}

// a_q int8 [m, nb*128], a_scale f32 [m, nb], weights as above → f32 [m, n].
extern "C" int w4a8_matmul(const int8_t* a_q, const float* a_scale,
                           const uint8_t* w_packed, const float* w_scale,
                           float* out, int m, int n, int nb, int zeroext,
                           cudaStream_t stream) {
  return launch<A_INT8>({nullptr, nullptr,
                         reinterpret_cast<const uint8_t*>(a_q), a_scale,
                         w_packed, w_scale, out, m, n, 0, nb, 0, 0}, zeroext,
                        stream);
}

// a4_packed uint8 [m, nb4*64], a4_scale f32 [m, nb4], a8_q int8
// [m, nb8*128], a8_scale f32 [m, nb8], w_packed uint8 [(nb4+nb8)*64, n],
// w_scale f32 [nb4+nb8, n] → out f32 [m, n]; zero-extension only.
extern "C" int w4ax_matmul_mixed(const uint8_t* a4_packed,
                                 const float* a4_scale, const int8_t* a8_q,
                                 const float* a8_scale,
                                 const uint8_t* w_packed,
                                 const float* w_scale, float* out, int m,
                                 int n, int nb4, int nb8,
                                 cudaStream_t stream) {
  return launch<A_MIXED>({a4_packed, a4_scale,
                          reinterpret_cast<const uint8_t*>(a8_q), a8_scale,
                          w_packed, w_scale, out, m, n, nb4, nb8, 0, 0}, 1,
                         stream);
}

// The same three over e experts in one launch: A, its scales and out are
// [e, m, ·] contiguous; expert z's packed W rows start at w + z·w_stride
// (bytes) and its scales at w_scale + z·ws_stride (floats), rows of n
// contiguous (a K-range of an [e, K/2, n] stack is such a view).
extern "C" int w4a4_matmul_experts(const uint8_t* a_packed,
                                   const float* a_scale,
                                   const uint8_t* w_packed,
                                   const float* w_scale, float* out, int e,
                                   int m, int n, int nb, int w_stride,
                                   int ws_stride, int zeroext,
                                   cudaStream_t stream) {
  return launch<A_INT4>({a_packed, a_scale, nullptr, nullptr, w_packed,
                         w_scale, out, m, n, nb, 0, w_stride, ws_stride},
                        zeroext, stream, e);
}

extern "C" int w4a8_matmul_experts(const int8_t* a_q, const float* a_scale,
                                   const uint8_t* w_packed,
                                   const float* w_scale, float* out, int e,
                                   int m, int n, int nb, int w_stride,
                                   int ws_stride, int zeroext,
                                   cudaStream_t stream) {
  return launch<A_INT8>({nullptr, nullptr,
                         reinterpret_cast<const uint8_t*>(a_q), a_scale,
                         w_packed, w_scale, out, m, n, 0, nb, w_stride,
                         ws_stride}, zeroext, stream, e);
}

extern "C" int w4ax_matmul_mixed_experts(
    const uint8_t* a4_packed, const float* a4_scale, const int8_t* a8_q,
    const float* a8_scale, const uint8_t* w_packed, const float* w_scale,
    float* out, int e, int m, int n, int nb4, int nb8, int w_stride,
    int ws_stride, cudaStream_t stream) {
  return launch<A_MIXED>({a4_packed, a4_scale,
                          reinterpret_cast<const uint8_t*>(a8_q), a8_scale,
                          w_packed, w_scale, out, m, n, nb4, nb8, w_stride,
                          ws_stride}, 1, stream, e);
}

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
// Hopper has no int4 tensor-core MMA, so nibbles are unpacked to int8 in
// shared memory and fed to mma.sync m16n8k32 s8·s8→s32. With the default
// zero-extension unpack (mask and shift, values 0..15) the block dot is
// restored by the reference's correction algebra:
//     W4A4: d = dot(a', w') − 8·Σa' − 8·Σw' + 8192
//     W4A8: d = dot(a,  w') − 8·Σa
// ZEROEXT=false is the sign-extension ablation (values −8..7, no
// correction) of the uniform kernels; only zeroext is on the serving path,
// and the mixed kernel has no other (as the reference's).
//
// Bound on the H100: bytes for the serving batch sizes (M ≤ 256 tokens; the
// int4 weight panel is read once per 64-row M tile, ~2 int8 ops per weight
// byte per row), operations only for M in the thousands. Design: a 64×64
// output tile per 128-thread block; each K step stages one 128-deep block
// of A and W (unpacked) in padded shared memory (row stride 144 B makes the
// fragment loads conflict-free), computes the row/column sums with dp4a,
// and each warp issues 4×8 int8 MMAs for its 16 rows. Warps whose rows are
// all past M skip the MMAs. The mixed kernel decides per K step which A
// operand to stage (b < nb4: the packed nibbles, else the int8 tail) and
// which correction to apply; the condition is the same for every thread of
// the block, so nothing diverges, and the weight staging is shared. Simple
// and right first: no cp.async/TMA pipeline and no wgmma yet.
#include "common.cuh"

namespace {

constexpr int BK = 128;          // quantization block == one K step
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int THREADS = 128;     // 4 warps; warp w owns tile rows [16w, 16w+16)
constexpr int SROW = BK + 16;    // padded shared row (bytes)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// How a kernel's A operand is laid out: all packed int4, all int8, or the
// mixed kernel's nb4 packed int4 blocks followed by nb8 int8 blocks.
enum AMode { A_INT4 = 0, A_INT8 = 1, A_MIXED = 2 };

// a4: packed uint8 [m, nb4*64]; a8: int8 [m, nb8*128] (nb4 = 0 for A_INT8,
// nb8 = 0 for A_INT4). W: packed uint8 [(nb4+nb8)*64, n] (byte j of a
// block: k=j low, k=j+64 high), rows contiguous across the two parts.
template <int MODE, bool ZEROEXT>
__global__ void __launch_bounds__(THREADS) w4ax_kernel(
    const uint8_t* __restrict__ a4, const float* __restrict__ a4_scale,
    const uint8_t* __restrict__ a8, const float* __restrict__ a8_scale,
    const uint8_t* __restrict__ w, const float* __restrict__ w_scale,
    float* __restrict__ out, int m, int n, int nb4, int nb8) {
  __shared__ __align__(16) int8_t sA[BM][SROW];
  __shared__ __align__(16) int8_t sB[BN][SROW];   // [n][k]: MMA "col" operand
  __shared__ int sRowSum[BM];
  __shared__ int sColSum[BN];
  __shared__ float sAs[BM];
  __shared__ float sWs[BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int r0 = warp * 16;
  const int nb = nb4 + nb8;
  const long a4_row = static_cast<long>(nb4) * (BK / 2);
  const long a8_row = static_cast<long>(nb8) * BK;
  const bool active = m0 + r0 < m;   // warp-uniform

  float facc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) facc[j][e] = 0.f;

  for (int b = 0; b < nb; ++b) {
    // the same for every thread of the block: no divergence
    const bool packed = MODE == A_INT4 || (MODE == A_MIXED && b < nb4);
    const int b8 = b - nb4;            // the block's index in the int8 part
    // ---- stage the A block: [BM rows][128 channels] as int8
    if (packed) {
      for (int i = tid; i < BM * 16; i += THREADS) {
        const int r = i >> 4, c = i & 15;      // word c = packed bytes 4c..4c+3
        uint32_t v = 0;
        if (m0 + r < m)
          v = *reinterpret_cast<const uint32_t*>(
              a4 + (m0 + r) * a4_row + static_cast<long>(b) * (BK / 2) +
              4 * c);
        uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
        if (!ZEROEXT) {
          lo = __vsub4(lo, 0x08080808u);
          hi = __vsub4(hi, 0x08080808u);
        }
        *reinterpret_cast<uint32_t*>(&sA[r][4 * c]) = lo;
        *reinterpret_cast<uint32_t*>(&sA[r][BK / 2 + 4 * c]) = hi;
      }
    } else {
      for (int i = tid; i < BM * 32; i += THREADS) {
        const int r = i >> 5, c = i & 31;
        uint32_t v = 0;
        if (m0 + r < m)
          v = *reinterpret_cast<const uint32_t*>(
              a8 + (m0 + r) * a8_row + static_cast<long>(b8) * BK + 4 * c);
        *reinterpret_cast<uint32_t*>(&sA[r][4 * c]) = v;
      }
    }
    // ---- stage the W block transposed: sB[col][k]
    for (int i = tid; i < (BK / 2) * (BN / 4); i += THREADS) {
      const int j = i / (BN / 4), c = i % (BN / 4);
      const int col = n0 + 4 * c;
      uint32_t v = 0;
      if (col < n)
        v = *reinterpret_cast<const uint32_t*>(
            w + (static_cast<long>(b) * (BK / 2) + j) * n + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int byte = (v >> (8 * e)) & 0xFF;
        int lo = byte & 0x0F, hi = byte >> 4;
        if (!ZEROEXT) { lo -= 8; hi -= 8; }
        sB[4 * c + e][j] = static_cast<int8_t>(lo);
        sB[4 * c + e][j + BK / 2] = static_cast<int8_t>(hi);
      }
    }
    if (tid < BM) {
      const long row = m0 + tid;
      sAs[tid] = row >= m ? 0.f
                 : packed ? a4_scale[row * nb4 + b]
                         : a8_scale[row * nb8 + b8];
    } else {
      const int c = tid - BM;
      sWs[c] = n0 + c < n ? w_scale[static_cast<long>(b) * n + n0 + c] : 0.f;
    }
    __syncthreads();
    if (ZEROEXT) {
      const int8_t* src = tid < BM ? sA[tid] : sB[tid - BM];
      int s = 0;
#pragma unroll
      for (int k = 0; k < BK; k += 4)
        s = __dp4a(static_cast<int>(lds32(src + k)), 0x01010101, s);
      if (tid < BM) sRowSum[tid] = s; else sColSum[tid - BM] = s;
      __syncthreads();
    }

    if (active) {
      int iacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[j][e] = 0;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        const uint32_t af[4] = {lds32(&sA[r0 + g][kk + 4 * t]),
                                lds32(&sA[r0 + g + 8][kk + 4 * t]),
                                lds32(&sA[r0 + g][kk + 16 + 4 * t]),
                                lds32(&sA[r0 + g + 8][kk + 16 + 4 * t])};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t bf[2] = {lds32(&sB[8 * j + g][kk + 4 * t]),
                                  lds32(&sB[8 * j + g][kk + 16 + 4 * t])};
          mma_s8(iacc[j], af, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + g + (e >= 2 ? 8 : 0);
          const int cl = 8 * j + 2 * t + (e & 1);
          int d = iacc[j][e];
          if (ZEROEXT) {
            d -= 8 * sRowSum[rl];
            if (packed) d += 8 * 8 * BK - 8 * sColSum[cl];
          }
          // explicit roundings (no FMA contraction): the same f32 ops in
          // the same block order as the plain version, so the two agree
          // bit for bit
          const float fd = static_cast<float>(d);
          facc[j][e] = __fadd_rn(
              facc[j][e],
              MODE == A_MIXED ? __fmul_rn(__fmul_rn(fd, sAs[rl]), sWs[cl])
                              : __fmul_rn(fd, __fmul_rn(sAs[rl], sWs[cl])));
        }
      }
    }
    __syncthreads();   // the next block overwrites the staged tiles
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + r0 + g + (e >= 2 ? 8 : 0);
      const int col = n0 + 8 * j + 2 * t + (e & 1);
      if (row < m && col < n) out[static_cast<long>(row) * n + col] = facc[j][e];
    }
  }
}

template <int MODE>
int launch(const uint8_t* a4, const float* a4_scale, const uint8_t* a8,
           const float* a8_scale, const uint8_t* w, const float* w_scale,
           float* out, int m, int n, int nb4, int nb8, int zeroext,
           cudaStream_t stream) {
  if (n % 4 != 0 || (MODE == A_MIXED && !zeroext))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && n > 0 && nb4 + nb8 > 0) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    if (zeroext)
      w4ax_kernel<MODE, true><<<grid, THREADS, 0, stream>>>(
          a4, a4_scale, a8, a8_scale, w, w_scale, out, m, n, nb4, nb8);
    else if constexpr (MODE != A_MIXED)
      w4ax_kernel<MODE, false><<<grid, THREADS, 0, stream>>>(
          a4, a4_scale, a8, a8_scale, w, w_scale, out, m, n, nb4, nb8);
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
  return launch<A_INT4>(a_packed, a_scale, nullptr, nullptr, w_packed,
                        w_scale, out, m, n, nb, 0, zeroext, stream);
}

// a_q int8 [m, nb*128], a_scale f32 [m, nb], weights as above → f32 [m, n].
extern "C" int w4a8_matmul(const int8_t* a_q, const float* a_scale,
                           const uint8_t* w_packed, const float* w_scale,
                           float* out, int m, int n, int nb, int zeroext,
                           cudaStream_t stream) {
  return launch<A_INT8>(nullptr, nullptr,
                        reinterpret_cast<const uint8_t*>(a_q), a_scale,
                        w_packed, w_scale, out, m, n, 0, nb, zeroext, stream);
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
  return launch<A_MIXED>(a4_packed, a4_scale,
                         reinterpret_cast<const uint8_t*>(a8_q), a8_scale,
                         w_packed, w_scale, out, m, n, nb4, nb8, 1, stream);
}

// Flash-decode over int4 KV, shared by two decode kernels: K10 (contiguous
// KV, kv4_attention.cu) and K8 (work-queue page items, paged_decode.cu).
// (K6, the dense paged decode, runs the tensor-core kernel of
// dense_attention.cuh.)
//
// Exact arithmetic. Every dot product and every sum over keys accumulates
// in f64 and is rounded once to f32, and the exponential is the f64 one
// rounded, which is how the plain versions compute on the card: with the
// order of summation out of the picture, kernel and plain version agree
// bit for bit, so serving through the kernel gives the plain version's
// tokens. (A 1e-6 difference in an attention output flips bf16 roundings
// of the projection inputs, which int4 act-quant turns into whole
// quantization steps and, at a near-tied logit, into another token.)
//
// The softmax is the plain version's, in three passes over the keys: the
// max score M, then L = Σ e^(s−M), then Σ (e^(s−M)/L)·v. K10 works on
// dequantized values (n − z)·s, rounded to f32 as the plain version's
// dequantization rounds them; K8 keeps the reference's partial in nibble
// space (s = q̃·n − c with q̃ = q·s_k/√D and c = Σ q̃·z_k pre-folded, V
// affine after the combine).
//
// The three passes recompute the scores instead of storing them (a decode
// row may hold 4,096 keys): decode reads few bytes and is set by the
// launch, and f64 runs at half the f32 rate on the H100.
#pragma once

#include "common.cuh"

namespace {

constexpr int DD = 128;     // head_dim the decode kernels are built for
constexpr int DWARPS = 8;   // warps of a whole-row block (K10)
constexpr int DNT = DWARPS * 32;
constexpr int PCH = DNT;    // keys whose probabilities a row block stages
constexpr int VCH = 32;     // keys whose dequantized V it stages

// The G dot products Σ_c a[g][c]·x_c of one packed row (byte j = channel
// j | channel j + D/2 << 4) in f64, each rounded once to f32. DEQ: x_c =
// (n_c − z_c)·s_c rounded to f32; else x_c = n_c.
template <int G, bool DEQ>
__device__ __forceinline__ void dot_row(const float* a, const uint8_t* row,
                                        const float* z, const float* s,
                                        float (&out)[G]) {
  double acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0;
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {       // 16 bytes = 32 channels at a time
    const uint4 w4 = r4[i];
    const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = 16 * i + 4 * j + bb;
        const uint32_t byte = (ws[j] >> (8 * bb)) & 0xffu;
        float lo = static_cast<float>(byte & 15u);
        float hi = static_cast<float>(byte >> 4);
        if constexpr (DEQ) {
          lo = (lo - z[c]) * s[c];
          hi = (hi - z[c + DD / 2]) * s[c + DD / 2];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = fma(static_cast<double>(a[g * DD + c]),
                       static_cast<double>(lo), acc[g]);
          acc[g] = fma(static_cast<double>(a[g * DD + c + DD / 2]),
                       static_cast<double>(hi), acc[g]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) out[g] = static_cast<float>(acc[g]);
}

// Channel d (0..127) of a packed row as a float code.
__device__ __forceinline__ float code(const uint8_t* row, int d) {
  const uint32_t byte = row[d & (DD / 2 - 1)];
  return static_cast<float>(d < DD / 2 ? (byte & 15u) : (byte >> 4));
}

template <int G>
struct RowSmem {
  float q[G * DD];
  float ks[DD], kz[DD], vs[DD], vz[DD];
  float p[G][PCH];
  float v[VCH][DD];
  float red[DWARPS][G];
  double redd[DWARPS][G];
  float m[G], l[G];
};

// One (sequence, kv head) row per block (K10): the block's threads
// split the keys [0, n) of the row, whose packed bytes sit at row_off(t)
// in both pools; q [B, Hq, DD], scales/zeros of the row's kv head [DD] →
// out[b, h·G .. h·G+G−1, :] = Σ_t p_t·(n_v − z_v)·s_v.
template <int G, class RowOff>
__device__ __forceinline__ void decode_row(
    const float* __restrict__ q, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ kz, const float* __restrict__ vs,
    const float* __restrict__ vz, RowOff row_off, int n, int b, int h,
    int hq, float* __restrict__ out) {
  __shared__ RowSmem<G> sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long qoff = (static_cast<long>(b) * hq + h * G) * DD;
  for (int i = tid; i < G * DD; i += DNT) sm.q[i] = q[qoff + i];
  for (int d = tid; d < DD; d += DNT) {
    sm.ks[d] = ks[d];
    sm.kz[d] = kz[d];
    sm.vs[d] = vs[d];
    sm.vz[d] = vz[d];
  }
  __syncthreads();
  const float sqrt_d = sqrtf(static_cast<float>(DD));
  auto scores = [&](int t, float (&s)[G]) {
    dot_row<G, true>(sm.q, kp + row_off(t), sm.kz, sm.ks, s);
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = s[g] / sqrt_d;
  };

  // pass 1: M, the max score of each head
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = NEG_INF;
  for (int t = tid; t < n; t += DNT) {
    float s[G];
    scores(t, s);
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], s[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = warp_max(mx[g]);
    if (lane == 0) sm.red[warp][g] = mx[g];
  }
  __syncthreads();
  if (tid < G) {
    float v = NEG_INF;
    for (int w = 0; w < DWARPS; ++w) v = fmaxf(v, sm.red[w][tid]);
    sm.m[tid] = v;
  }
  __syncthreads();

  // pass 2: L = Σ e^(s − M)
  double ls[G];
#pragma unroll
  for (int g = 0; g < G; ++g) ls[g] = 0.0;
  for (int t = tid; t < n; t += DNT) {
    float s[G];
    scores(t, s);
#pragma unroll
    for (int g = 0; g < G; ++g) ls[g] += exp_f64(s[g] - sm.m[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ls[g] = warp_sum_d(ls[g]);
    if (lane == 0) sm.redd[warp][g] = ls[g];
  }
  __syncthreads();
  if (tid < G) {
    double v = 0.0;
    for (int w = 0; w < DWARPS; ++w) v += sm.redd[w][tid];
    sm.l[tid] = static_cast<float>(v);
  }
  __syncthreads();

  // pass 3: Σ_t p_t·v_t: p of PCH keys at a time (one key per thread),
  // their V dequantized into shared memory VCH keys at a time; thread =
  // (head, channel) pairs
  constexpr int KP = (G * DD + DNT - 1) / DNT;
  double acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0;
  for (int c0 = 0; c0 < n; c0 += PCH) {
    const int nc = min(PCH, n - c0);
    if (tid < nc) {
      float s[G];
      scores(c0 + tid, s);
#pragma unroll
      for (int g = 0; g < G; ++g) sm.p[g][tid] = exp_f64(s[g] - sm.m[g]) / sm.l[g];
    }
    for (int v0 = 0; v0 < nc; v0 += VCH) {
      const int nv = min(VCH, nc - v0);
      __syncthreads();    // p written / previous V chunk consumed
      for (int i = tid; i < nv * (DD / 2); i += DNT) {
        const int j = i / (DD / 2), c = i % (DD / 2);
        const uint32_t byte = vp[row_off(c0 + v0 + j) + c];
        sm.v[j][c] = (static_cast<float>(byte & 15u) - sm.vz[c]) * sm.vs[c];
        sm.v[j][c + DD / 2] = (static_cast<float>(byte >> 4) - sm.vz[c + DD / 2])
                              * sm.vs[c + DD / 2];
      }
      __syncthreads();
      for (int j = 0; j < nv; ++j) {
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int pair = tid + k * DNT;
          if (pair < G * DD)
            acc[k] = fma(static_cast<double>(sm.p[pair / DD][v0 + j]),
                         static_cast<double>(sm.v[j][pair % DD]), acc[k]);
        }
      }
    }
    __syncthreads();      // p consumed before the next chunk overwrites it
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int pair = tid + k * DNT;
    if (pair < G * DD) out[qoff + pair] = static_cast<float>(acc[k]);
  }
}

}  // namespace

// Instantiate LAUNCH(G) for the G this build supports; any other G
// returns cudaErrorInvalidValue from the enclosing entry point.
#define DISPATCH_G(g, LAUNCH)                                    \
  switch (g) {                                                   \
    case 1: LAUNCH(1); break;                                    \
    case 2: LAUNCH(2); break;                                    \
    case 4: LAUNCH(4); break;                                    \
    case 8: LAUNCH(8); break;                                    \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

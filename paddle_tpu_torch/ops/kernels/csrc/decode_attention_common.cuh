// The device body of the contiguous-cache fp32 decode-attention kernel
// (q_len == 1), decode_attention.cu, which addresses a [B, cap, H, D] cache
// in place. It runs one CTA per (b, h) and takes the address of row t as a
// functor. (The paged kernels, fp32 and int8, split each (b, h) over a
// cluster of CTAs instead: paged_decode_split.cuh.)
//
// Structure: the CTA's kWarps warps take a strided share of the rows, kRows
// rows per iteration, so every warp keeps 2 * kRows row loads in flight; a
// row of one head is D contiguous floats (256 bytes at D = 64) that the
// warp reads with float2 loads. Each warp keeps its own online softmax
// (max, denominator, accumulator) in fp32 registers; the warps merge
// through shared memory at the end. Rows at or past n are never read.

#pragma once

#include <cuda_runtime.h>

namespace decode_attn {

constexpr int kWarps = 8;       // warps per CTA
constexpr int kRows = 4;        // rows one warp has in flight per iteration
constexpr int kMaxPairs = 2;    // float2 per lane: D <= 2 * 32 * kMaxPairs
constexpr int kMaxD = 2 * 32 * kMaxPairs;
constexpr float kNegInf = -1e30f;   // paddle_tpu/ops/pallas/_common.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// softmax(q . k_t * scale) . v_t over the rows t in [0, n) of one (b, h),
// written to o[0, D). Row t's D floats start at k + row_of(t) * D (v
// likewise). With `uniform` every score counts as equal: the plain
// version's answer when it masks every row of a length-0 sequence (n
// scores of -1e30, so the softmax is 1/n each and o is the mean of the n
// v rows). Called by all kWarps * 32 threads of the CTA.
template <class RowOf>
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ o, int n,
                                       bool uniform, int D, float scale,
                                       RowOf row_of) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pairs = D / 2;

  const float2* q2 = reinterpret_cast<const float2*>(q);
  float2 qv[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int p = lane + 32 * j;
    qv[j] = p < pairs ? q2[p] : make_float2(0.f, 0.f);
  }

  float m = kNegInf;            // running max of this warp's scores
  float l = 0.f;                // running softmax denominator
  float2 acc[kMaxPairs];        // running sum of p * v (unnormalised)
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) acc[j] = make_float2(0.f, 0.f);

  for (int t0 = warp * kRows; t0 < n; t0 += kWarps * kRows) {
    float2 kr[kRows][kMaxPairs];
    float2 vr[kRows][kMaxPairs];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = t0 + i;
      const bool live = t < n;
      const long long row = live ? row_of(t) : 0;
      const float2* k2 = reinterpret_cast<const float2*>(k + row * D);
      const float2* v2 = reinterpret_cast<const float2*>(v + row * D);
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        const int p = lane + 32 * j;
        const bool ok = live && p < pairs;
        kr[i][j] = ok ? k2[p] : make_float2(0.f, 0.f);
        vr[i][j] = ok ? v2[p] : make_float2(0.f, 0.f);
      }
    }
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        s[i] += kr[i][j].x * qv[j].x + kr[i][j].y * qv[j].y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i] += __shfl_xor_sync(kFull, s[i], off);
      }
    }
    float m_new = m;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = t0 + i < n ? (uniform ? 0.f : s[i] * scale) : kNegInf;
      m_new = fmaxf(m_new, s[i]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      acc[j].x *= corr;
      acc[j].y *= corr;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      // a row at or past n contributes exactly nothing (its v was never
      // read)
      const float p = t0 + i < n ? expf(s[i] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        acc[j].x += p * vr[i][j].x;
        acc[j].y += p * vr[i][j].y;
      }
    }
    m = m_new;
  }

  // merge the warps' partial softmax states: a warp that saw no row keeps
  // m = -1e30, l = 0 and drops out through exp(-1e30 - M) = 0
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int p = lane + 32 * j;
    if (p < pairs) {
      sm_acc[warp][2 * p] = acc[j].x;
      sm_acc[warp][2 * p + 1] = acc[j].y;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float num = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);
      num += sm_acc[w][d] * f;
      den += sm_l[w] * f;
    }
    o[d] = num / den;
  }
}

}  // namespace decode_attn

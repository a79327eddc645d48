// Paged decode attention (q_len == 1) over a paged fp32 KV pool, for
// Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py `_paged_kernel`
// (launched by `_paged_decode_attention_pallas`), the TPU kernel behind
// `paged_decode_attention`. Same math: softmax(q.k / sqrt(D)) . v over the
// rows [0, lengths[b]) of sequence b, where row t lives at page
// tables[b, t / pt], offset t % pt; rows past the length are masked with
// the same -1e30 constant (paddle_tpu/ops/pallas/_common.py NEG_INF).
//
// What bounds it: bytes. Per launch it must read 2 * B * H * len * D * 4
// bytes of K/V (len = live rows) and does 4 flops per K/V element pair, far
// below the card's flop/byte balance, so it is memory-bound.
//
// Design. The TPU kernel walks a sequential (B, H, W) grid, carrying the
// online-softmax state across grid steps in scratch. Blocks on a GPU run in
// parallel and in no order, so here one CTA owns one (b, h) pair and loops
// over the pages itself, reading tables[b, w] in the kernel (in place of
// the TPU's scalar prefetch). It visits only the ceil(len / pt) pages that
// hold live rows. Each of the CTA's warps takes a strided share of the rows,
// kRows rows per iteration, so every warp keeps 2 * kRows row loads in
// flight; a row of one head is D contiguous floats (256 bytes at D = 64)
// that the warp reads with float2 loads. Each warp keeps its own online
// softmax (max, denominator, accumulator) in fp32 registers; the warps
// merge through shared memory at the end.
//
// Known limit: at the main path's B = 8, H = 12 only 96 CTAs cover the
// 132 SMs. Splitting each sequence across CTAs (flash-decoding) is later
// work.
//
// Contract: 1 <= lengths[b] <= W * pt (the kernel clamps to that range),
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps per CTA
constexpr int kRows = 4;        // rows one warp has in flight per iteration
constexpr int kMaxPairs = 2;    // float2 per lane: D <= 2 * 32 * kMaxPairs
constexpr int kMaxD = 2 * 32 * kMaxPairs;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const float* __restrict__ k_pool,
                              const float* __restrict__ v_pool,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              float* __restrict__ out,
                              int H, int D, int pt, int W, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pairs = D / 2;
  const int len = min(max(lengths[b], 1), W * pt);
  const int* tbl = tables + static_cast<long long>(b) * W;

  const float2* q2 = reinterpret_cast<const float2*>(
      q + (static_cast<long long>(b) * H + h) * D);
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

  for (int t0 = warp * kRows; t0 < len; t0 += kWarps * kRows) {
    float2 kr[kRows][kMaxPairs];
    float2 vr[kRows][kMaxPairs];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = t0 + i;
      const bool live = t < len;
      long long row = 0;
      if (live) {
        row = (static_cast<long long>(tbl[t / pt]) * pt + t % pt) * H + h;
      }
      const float2* k2 = reinterpret_cast<const float2*>(k_pool + row * D);
      const float2* v2 = reinterpret_cast<const float2*>(v_pool + row * D);
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
      s[i] = t0 + i < len ? s[i] * scale : kNegInf;
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
      // a masked row contributes exactly nothing (its v was never read)
      const float p = t0 + i < len ? expf(s[i] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        acc[j].x += p * vr[i][j].x;
        acc[j].y += p * vr[i][j].y;
      }
    }
    m = m_new;
  }

  // merge the warps' partial softmax states: a warp that saw no live row
  // keeps m = -1e30, l = 0 and drops out through exp(-1e30 - M) = 0
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
  float* o = out + (static_cast<long long>(b) * H + h) * D;
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

}  // namespace

// C entry point, bound with ctypes. Shapes: q [B, H, D], k_pool/v_pool
// [P, pt, H, D], tables [B, W] int32, lengths [B] int32, out [B, H, D];
// all fp32 unless stated. Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int D, int pt, int W,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || (D & 1) || pt <= 0 ||
      W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(H, B);
  paged_decode_attention_kernel<<<grid, kWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), H, D, pt,
      W, scale);
  return static_cast<int>(cudaGetLastError());
}

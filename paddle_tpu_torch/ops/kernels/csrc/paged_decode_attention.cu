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
// hold live rows. The loop over the rows, the per-warp online softmax and
// the merge are decode_attention_common.cuh's, shared with the contiguous
// kernel (decode_attention.cu); this file gives it the address of row t,
// through the block table.
//
// Known limit: at the main path's B = 8, H = 12 only 96 CTAs cover the
// 132 SMs. Splitting each sequence across CTAs (flash-decoding) is later
// work.
//
// Contract: 1 <= lengths[b] <= W * pt (the kernel clamps to that range),
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include <cuda_runtime.h>

#include "decode_attention_common.cuh"

namespace {

using decode_attn::kMaxD;
using decode_attn::kWarps;

// row t of sequence b, head h: page tables[b, t / pt], offset t % pt
struct PagedRows {
  const int* tbl;
  int pt;
  int H;
  int h;
  __device__ long long operator()(int t) const {
    return (static_cast<long long>(tbl[t / pt]) * pt + t % pt) * H + h;
  }
};

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
  const int len = min(max(lengths[b], 1), W * pt);
  const long long bh = static_cast<long long>(b) * H + h;
  decode_attn::attend(q + bh * D, k_pool, v_pool, out + bh * D, len, false,
                      D, scale,
                      PagedRows{tables + static_cast<long long>(b) * W, pt,
                                H, h});
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

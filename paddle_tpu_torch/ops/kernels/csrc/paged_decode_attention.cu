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
// online-softmax state across grid steps in scratch. Here the rows of each
// (b, h) are split over a thread-block cluster of eight CTAs, each CTA
// streams its share of the rows through cp.async rings and keeps an online
// softmax, and the cluster merges the eight partial states in rank order
// through distributed shared memory (paged_decode_split.cuh, shared with
// the int8 kernel and the contiguous one). The block table is read in the kernel, in place of the
// TPU's scalar prefetch, and only the pages that hold live rows are read.
//
// Contract: 1 <= lengths[b] <= W * pt (the kernel clamps to that range),
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include "paged_decode_split.cuh"

// C entry point, bound with ctypes. Shapes: q [B, H, D], k_pool/v_pool
// [P, pt, H, D], tables [B, W] int32, lengths [B] int32, out [B, H, D];
// all fp32 unless stated. Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int D, int pt, int W,
    float scale, void* stream) {
  paged_split::Args<paged_split::F32Rows, paged_split::PagedRows> a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k_pool);
  a.v = static_cast<const float*>(v_pool);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.rows = {static_cast<const int*>(tables), pt, W};
  a.H = H;
  a.D = D;
  a.scale = scale;
  return paged_split::launch(a, B, static_cast<cudaStream_t>(stream));
}

// The launch geometry for (B, H, D, pt, W) into out[0..6]
// (paged_decode_split.cuh `geometry`); 0, or cudaErrorInvalidValue.
extern "C" int paged_decode_attention_f32_geometry(int B, int H, int D,
                                                   int pt, int W, int* out) {
  return paged_split::geometry<paged_split::F32Rows>(
      B, H, D, paged_split::PagedRows{nullptr, pt, W}, out);
}

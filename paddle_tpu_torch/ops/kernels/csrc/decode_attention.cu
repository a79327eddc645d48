// Decode attention (q_len == 1) over a contiguous fp32 KV cache, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py `_kernel` (launched
// by `_decode_attention_pallas`), the TPU kernel behind `decode_attention`
// on the contiguous-cache decode path (`gpt_decode_fns`' decode_step). Same
// math: softmax(q.k / sqrt(D)) . v over the rows [0, lengths[b]) of the
// cache panel k, v [B, cap, H, D] of sequence b, rows past the length
// masked with the same -1e30 constant (paddle_tpu/ops/pallas/_common.py
// NEG_INF). A length above cap counts as cap (every row live), and a
// length of 0 masks every row, which makes the plain version's softmax
// uniform: the output is then the mean of all cap rows of v, as there.
//
// What bounds it: bytes. Per launch it must read 2 * H * sum(len) * D * 4
// bytes of K/V (len = live rows of each sequence) and does 4 flops per K/V
// element pair, far below the card's flop/byte balance. At the decode
// path's B = 8, H = 12 one CTA per (b, h) left 96 CTAs on 132 SMs, the
// longest sequence's CTA walking its rows alone: 6.7x the bound.
//
// Design. The TPU kernel streams each (b, h) pair's whole [cap, D] panel
// into VMEM, after the wrapper has transposed k and v to [B*H, cap, D] and
// built a [1, cap] additive mask row per pair. Here there is no mask
// tensor and no transposed copy: the split-KV template of the paged kernels
// (paged_decode_split.cuh) runs with the contiguous row address
// `ContiguousRows`, row t of head h at ((b * cap + t) * H + h) * D. Each
// (b, h) is a cluster of eight CTAs that take an eighth of its live rows
// each through per-warp cp.async rings and merge their partial softmax
// states in rank order through distributed shared memory; only live rows
// are read, and with no block table a row's address needs no load.
//
// Contract: any lengths[b] (the kernel clamps it to [0, cap]), cap >= 1,
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it. The launch depends on (B, H, D, cap) alone.

#include "paged_decode_split.cuh"

// C entry point, bound with ctypes. Shapes: q [B, H, D], k/v
// [B, cap, H, D], lengths [B] int32, out [B, H, D]; all fp32 unless
// stated. Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int H, int D, int cap,
                                    float scale, void* stream) {
  paged_split::Args<paged_split::F32Rows, paged_split::ContiguousRows> a =
      {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.rows = {cap};
  a.H = H;
  a.D = D;
  a.scale = scale;
  return paged_split::launch(a, B, static_cast<cudaStream_t>(stream));
}

// The launch geometry for (B, H, D, cap) into out[0..6]
// (paged_decode_split.cuh `geometry`); 0, or cudaErrorInvalidValue.
extern "C" int decode_attention_f32_geometry(int B, int H, int D, int cap,
                                             int* out) {
  return paged_split::geometry<paged_split::F32Rows>(
      B, H, D, paged_split::ContiguousRows{cap}, out);
}

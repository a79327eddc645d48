// Paged decode attention (q_len == 1) over a paged int8 KV pool, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py `_paged_quant_kernel`
// (launched by `_paged_decode_attention_quant_pallas`), the TPU kernel
// behind `paged_decode_attention_quant`. Same math: the pages hold int8
// codes with one fp32 scale per (page, row, head) (paddle_tpu_torch/quant/
// kv.py), a row dequantizes to code * scale, and the result is
// softmax(q.k / sqrt(D)) . v over the rows [0, lengths[b]) of sequence b,
// row t at page tables[b, t / pt], offset t % pt; rows past the length are
// masked with -1e30 (paddle_tpu/ops/pallas/_common.py NEG_INF).
//
// What bounds it: bytes. Per launch it must read the live K and V rows,
// D int8 codes plus one fp32 scale per (row, head): 2 * rows * H * (D + 4)
// bytes, a quarter of the fp32 kernel's at D = 64, and it does 4 flops per
// K/V element pair.
//
// Design: the fp32 kernel's split-KV template (paged_decode_split.cuh)
// over int8 rows. A cluster of eight CTAs splits each (b, h)'s rows; the
// codes and their scales reach shared memory by cp.async (a scale is 4
// bytes, too small for a TMA box); the codes become fp32 in registers by
// an integer add and one fp32 subtract (`s8_to_f32`), and the scales are
// folded in where they cost one multiply per row: the score is
// (q . k_code) * k_scale / sqrt(D), and the row's softmax weight p is
// scaled by v_scale before it multiplies v_code (the denominator sums p
// itself). The scales are read in their [P, pt, H] layout; the TPU
// kernel's transpose to [P, H, pt] serves the TPU's lanes and is not
// copied.
//
// Contract: 1 <= lengths[b] <= W * pt (the kernel clamps to that range),
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include "paged_decode_split.cuh"

// C entry point, bound with ctypes. Shapes: q [B, H, D] fp32, k_pool/v_pool
// [P, pt, H, D] int8, k_scale/v_scale [P, pt, H] fp32, tables [B, W] int32,
// lengths [B] int32, out [B, H, D] fp32. Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int H, int D, int pt, int W,
    float scale, void* stream) {
  paged_split::Args<paged_split::I8Rows, paged_split::PagedRows> a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const signed char*>(k_pool);
  a.v = static_cast<const signed char*>(v_pool);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
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
extern "C" int paged_decode_attention_int8_geometry(int B, int H, int D,
                                                    int pt, int W,
                                                    int* out) {
  return paged_split::geometry<paged_split::I8Rows>(
      B, H, D, paged_split::PagedRows{nullptr, pt, W}, out);
}

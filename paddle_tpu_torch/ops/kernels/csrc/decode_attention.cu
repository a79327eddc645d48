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
// element pair, far below the card's flop/byte balance.
//
// Design. The TPU kernel streams each (b, h) pair's whole [cap, D] panel
// into VMEM, after the wrapper has transposed k and v to [B*H, cap, D] and
// built a [1, cap] additive mask row per pair. Here there is no mask
// tensor and no transposed copy: one CTA owns one (b, h) pair and reads
// row t of head h in place, at ((b * cap + t) * H + h) * D, and only the
// live rows. The loop over the rows, the per-warp online softmax and the
// merge are decode_attention_common.cuh's, shared with the paged kernel
// (paged_decode_attention.cu), which differs only in how it finds row t.
//
// Known limit: at the main path's B = 8, H = 12 only 96 CTAs cover the
// 132 SMs. Splitting each sequence across CTAs (flash-decoding) is later
// work.
//
// Contract: any lengths[b] (the kernel clamps it to [0, cap]), cap >= 1,
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include <cuda_runtime.h>

#include "decode_attention_common.cuh"

namespace {

using decode_attn::kMaxD;
using decode_attn::kWarps;

// row t of one (b, h) pair: base = b * cap * H + h, then H rows per t
struct ContiguousRows {
  long long base;
  int H;
  __device__ long long operator()(int t) const {
    return base + static_cast<long long>(t) * H;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int H, int D, int cap,
                        float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), cap);
  const long long bh = static_cast<long long>(b) * H + h;
  decode_attn::attend(q + bh * D, k, v, out + bh * D, len == 0 ? cap : len,
                      len == 0, D, scale,
                      ContiguousRows{static_cast<long long>(b) * cap * H + h,
                                     H});
}

}  // namespace

// C entry point, bound with ctypes. Shapes: q [B, H, D], k/v
// [B, cap, H, D], lengths [B] int32, out [B, H, D]; all fp32 unless
// stated. Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int H, int D, int cap,
                                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || (D & 1) || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(H, B);
  decode_attention_kernel<<<grid, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), H, D, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

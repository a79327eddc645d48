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
// Design: the fp32 kernel's (paged_decode_attention.cu). One CTA owns one
// (b, h) pair and loops over the live pages itself, reading tables[b, w]
// in the kernel; each of its 8 warps takes a strided share of the rows,
// kRows rows per iteration, so a warp keeps 2 * kRows row loads in flight.
// A row of one head is D contiguous bytes (64 at D = 64), which the warp
// reads as one char2 per lane (two at D > 64); the row's scale is one float
// that every lane reads (a broadcast). The codes are converted to fp32 in
// registers and the scales folded in where they cost one multiply per row:
// the score is
// (q . k_code) * k_scale / sqrt(D), and the row's softmax weight p is
// scaled by v_scale before it multiplies v_code (the denominator sums p
// itself). Each warp keeps its own online softmax (max, denominator,
// accumulator) in fp32 registers; the warps merge through shared memory.
// The scales are read in their [P, pt, H] layout; the TPU kernel's
// transpose to [P, H, pt] serves the TPU's lanes and is not copied.
//
// Measured on the H100, this kernel is bound by instruction issue, not by
// bytes: per byte loaded it does far more work than the fp32 kernel per
// float. So (i) the number of char2 per lane is a template parameter, one
// at D <= 64, so no lane issues loads and conversions for a masked second
// pair; (ii) an int8 code becomes a float with an integer add and one fp32
// subtract (the exponent trick in s8_to_f32) instead of the slower
// integer-to-float conversion instruction; (iii) rows past the length
// still load (row 0 of the sequence's first page, always mapped) and are
// masked afterwards, so every load issues without a branch. Each warp
// keeps 8 rows in flight, twice the fp32 kernel's 4: an int8 row costs a
// quarter of the registers.
//
// Contract: 1 <= lengths[b] <= W * pt (the kernel clamps to that range),
// D even and D <= 128, every tensor contiguous; the Python wrapper checks
// the static part of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // warps per CTA
constexpr int kRows = 8;        // rows one warp has in flight per iteration
constexpr int kMaxD = 128;      // two char2 per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// int8 code -> float, exactly: 2^23 + (c + 128) has c + 128 in the
// mantissa, so subtracting 2^23 + 128 leaves c.
__device__ __forceinline__ float s8_to_f32(signed char c) {
  return __int_as_float(0x4B000000 + (static_cast<int>(c) + 128)) -
         8388736.f;
}

// kPairs char2 per lane: D <= 2 * 32 * kPairs
template <int kPairs>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_attention_int8_kernel(const float* __restrict__ q,
                                   const int8_t* __restrict__ k_pool,
                                   const float* __restrict__ k_scale,
                                   const int8_t* __restrict__ v_pool,
                                   const float* __restrict__ v_scale,
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
  float2 qv[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = lane + 32 * j;
    qv[j] = p < pairs ? q2[p] : make_float2(0.f, 0.f);
  }

  float m = kNegInf;            // running max of this warp's scores
  float l = 0.f;                // running softmax denominator
  float2 acc[kPairs];        // running sum of p * v (unnormalised)
#pragma unroll
  for (int j = 0; j < kPairs; ++j) acc[j] = make_float2(0.f, 0.f);

  for (int t0 = warp * kRows; t0 < len; t0 += kWarps * kRows) {
    char2 kr[kRows][kPairs];
    char2 vr[kRows][kPairs];
    float ks[kRows];
    float vs[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      // a row past the length reads the sequence's row 0 and is masked
      const int t = t0 + i < len ? t0 + i : 0;
      const long long row =     // (page, offset, head) row index
          (static_cast<long long>(tbl[t / pt]) * pt + t % pt) * H + h;
      ks[i] = k_scale[row];
      vs[i] = v_scale[row];
      const char2* k2 = reinterpret_cast<const char2*>(k_pool + row * D);
      const char2* v2 = reinterpret_cast<const char2*>(v_pool + row * D);
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int p = lane + 32 * j;
        kr[i][j] = p < pairs ? k2[p] : make_char2(0, 0);
        vr[i][j] = p < pairs ? v2[p] : make_char2(0, 0);
      }
    }
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        s[i] += s8_to_f32(kr[i][j].x) * qv[j].x +
                s8_to_f32(kr[i][j].y) * qv[j].y;
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
      s[i] = t0 + i < len ? s[i] * ks[i] * scale : kNegInf;
      m_new = fmaxf(m_new, s[i]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      acc[j].x *= corr;
      acc[j].y *= corr;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      // a masked row contributes exactly nothing
      const float p = t0 + i < len ? expf(s[i] - m_new) : 0.f;
      l += p;
      const float pv = p * vs[i];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        acc[j].x += pv * s8_to_f32(vr[i][j].x);
        acc[j].y += pv * s8_to_f32(vr[i][j].y);
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
  for (int j = 0; j < kPairs; ++j) {
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
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || (D & 1) || pt <= 0 ||
      W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(H, B);
  auto kernel = D <= 64 ? paged_decode_attention_int8_kernel<1>
                        : paged_decode_attention_int8_kernel<2>;
  kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const float*>(k_scale), static_cast<const int8_t*>(v_pool),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), H, D, pt,
      W, scale);
  return static_cast<int>(cudaGetLastError());
}

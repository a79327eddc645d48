// Shared pieces of the SIMT fused linear + cross-entropy kernels, which
// take fp32 operands (the forward in fused_linear_ce_fwd.cu and the
// backward in fused_linear_ce_bwd.cu): the CTA shape, operand loads, and
// the tile of logits every kernel is built from. bf16 runs on the tensor
// cores (`lce_fwd_mma_kernel`, `lce_bwd_mma_kernel`, wgmma.cuh).
//
// Every kernel has one "resident" operand, R rows of [*, H] held in shared
// memory for the whole CTA, and one "streamed" operand, swept in tiles of
// kStream = 32 rows read from global memory (L2). The forward and dx
// kernels keep R rows of x and stream W; the dW kernel keeps R rows of W
// and streams x. R = 8, so that the dx/dW kernels' fp32 accumulator [R, H]
// and the resident rows fit one CTA's 227 KB at H = 2048.
//
// The logits tile [kStream, R] = streamed . resident^T over K = H: warp w
// owns streamed rows 4w..4w+3 against all R resident rows (4R sums per
// lane), and its 32 lanes split K in chunks of 8 (lane l takes chunks l,
// l+32, ...), so each 32-byte load of W or x feeds 4R or 32 FMAs. The
// lanes' partial sums are then summed by a butterfly reduce-scatter that
// leaves 4R/32 finished logits in each lane. fp32 products with fp32
// accumulation (the TPU kernel's preferred_element_type=f32), no TF32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lce {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;                   // streamed rows per warp
constexpr int kStream = kWarps * kPerWarp;    // streamed rows per tile
constexpr float kNegInf = -1e30f;             // the JAX package's mask
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;            // 227 KB, opt-in maximum

template <typename E>
struct Rows;
template <>
struct Rows<float> {
  static constexpr int R = 8;
};

// Eight consecutive elements of one row, as loaded (32 bytes of fp32);
// `to_float` hands them out.
template <typename E>
struct Raw8;

template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void load_vec(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void load_tail(const float* p, int n) {
    float h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = e < n ? p[e] : 0.f;
    a = make_float4(h[0], h[1], h[2], h[3]);
    b = make_float4(h[4], h[5], h[6], h[7]);
  }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Chunk c (elements [8c, 8c + 8)) of row `row` of a [count, H] matrix;
// zeros past the last row and past H. `vec`: H % 8 == 0 and 16-byte aligned
// bases, so a chunk is one aligned vector load.
template <typename E>
__device__ __forceinline__ void load_chunk(Raw8<E>& v, const E* base, int row,
                                           int count, int H, int c,
                                           bool vec) {
  const int k = 8 * c;
  if (row >= count || k >= H) {
    v.zero();
    return;
  }
  const E* p = base + static_cast<long long>(row) * H + k;
  if (vec) {
    v.load_vec(p);
  } else {
    v.load_tail(p, min(8, H - k));
  }
}

// Elements [c, c + 4) of a valid fp32 row; zeros past H.
__device__ __forceinline__ float4 load4(const float* p, int c, int H,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + c));
  return make_float4(c < H ? p[c] : 0.f, c + 1 < H ? p[c + 1] : 0.f,
                     c + 2 < H ? p[c + 2] : 0.f, c + 3 < H ? p[c + 3] : 0.f);
}

// Rows row0 .. row0 + R - 1 of src [count, H] into shared memory as [R, Hp]
// in the operand type (Hp = H rounded up to 8, zero padded; rows past
// `count` are zeros).
template <typename E, int R>
__device__ __forceinline__ void load_resident(E* dst, const E* src, int row0,
                                              int count, int H, int Hp,
                                              bool vec) {
  const int nck = Hp / 8;
  for (int e = threadIdx.x; e < R * nck; e += kThreads) {
    const int r = e / nck;
    const int c = e % nck;
    Raw8<E> v;
    load_chunk<E>(v, src, row0 + r, count, H, c, vec);
    *reinterpret_cast<Raw8<E>*>(dst + r * Hp + 8 * c) = v;
  }
}

// acc[q * R + r] = partial sum, over this lane's K chunks, of
// streamed[s0 + 4 * warp + q] . resident[r]. The next chunk's streamed
// rows are loaded before the current chunk's FMAs.
template <typename E, int R>
__device__ __forceinline__ void tile_partials(
    const E* sRes, int Hp, const E* streamed, int count, int H, int s0,
    bool vec, int warp, int lane, float (&acc)[kPerWarp * R]) {
#pragma unroll
  for (int i = 0; i < kPerWarp * R; ++i) acc[i] = 0.f;
  const int nck = Hp / 8;
  const int row = s0 + kPerWarp * warp;
  Raw8<E> nxt[kPerWarp];
  int c = lane;
  if (c < nck) {
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      load_chunk<E>(nxt[q], streamed, row + q, count, H, c, vec);
    }
  }
  while (c < nck) {
    float w[kPerWarp][8];
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) nxt[q].to_float(w[q]);
    const int cn = c + 32;
    if (cn < nck) {
#pragma unroll
      for (int q = 0; q < kPerWarp; ++q) {
        load_chunk<E>(nxt[q], streamed, row + q, count, H, cn, vec);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[8];
      reinterpret_cast<const Raw8<E>*>(sRes + r * Hp + 8 * c)->to_float(x);
#pragma unroll
      for (int q = 0; q < kPerWarp; ++q) {
        float s = acc[q * R + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(w[q][e], x[e], s);
        acc[q * R + r] = s;
      }
    }
    c = cn;
  }
}

// Butterfly reduce-scatter of C partial sums over the 32 lanes of a warp,
// one step per xor offset o = 16, 8, 4, 2, 1: a lane keeps the upper half
// of its entries when bit o of its index is set, the lower half otherwise,
// and adds its partner's copy of that half. Afterwards v[j] (j < C / 32)
// of lane l is the full sum of entry l * (C / 32) + j (`sum_index`).
template <int C, int HALF = C / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[C], int lane) {
  static_assert(C >= 32 && C % 32 == 0, "C must be a multiple of 32");
  constexpr int o = HALF * 32 / C;
  const bool hi = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float a = v[i];
    const float b = v[i + HALF];
    const float send = hi ? a : b;
    v[i] = (hi ? b : a) + __shfl_xor_sync(kFull, send, o);
  }
  if constexpr (o > 1) reduce_scatter<C, HALF / 2>(v, lane);
}

template <int C>
__device__ __forceinline__ int sum_index(int lane, int j) {
  return lane * (C / 32) + j;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// H rounded up to the 8-element chunk.
__host__ __device__ constexpr int padded(int H) { return (H + 7) & ~7; }

}  // namespace lce

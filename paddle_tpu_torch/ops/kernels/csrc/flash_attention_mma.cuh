// Tensor-core tile code of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): mma.sync m16n8k16
// (bf16 operands, fp32 accumulators), ldmatrix fragment loads, cp.async
// tile copies into a padded shared-memory layout.
//
// Fragments of mma.m16n8k16.row.col (lane = 4 g + tq, g < 8, tq < 4):
//   A [16 x 16]  a[0]: row g,     cols 2 tq, 2 tq + 1     a[1]: row g + 8
//                a[2]: row g,     cols 8 + 2 tq, ...      a[3]: row g + 8
//   B [16 x 8]   b[0]: rows 2 tq, 2 tq + 1 of col g       b[1]: rows + 8
//   C [16 x 8]   c[0..1]: row g, cols 2 tq, 2 tq + 1;  c[2..3]: row g + 8
// The C layout of two neighbouring n-tiles is the A layout of one k step,
// so a product's fp32 result, rounded to bf16 and packed, feeds the next
// product from registers (P . V, dS . K) without going through shared
// memory.
//
// Shared-memory tiles hold bf16 rows of DP (64 or 128) columns padded by
// 8: a row is DP + 8 elements (144 or 272 bytes) apart, so the eight
// 16-byte row addresses of one ldmatrix phase start on banks 4 i (mod 32)
// and touch every bank once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_attention_common.cuh"

namespace flash_mma {

using flash::kNegInf;                  // the JAX package's mask constant

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;              // each owns 16 rows of a 64-row tile
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kRows = 64;              // rows of a q tile (fwd, dq), k tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tile {
  static constexpr int LD = DP + 8;    // padded row, in elements
  static constexpr int KD = DP / 16;   // k steps over the head dimension
  static constexpr int ND = DP / 8;    // n tiles over the head dimension
};

// The route's operand contract, checked by the entry points on the host:
// D % 8 == 0, strides that are multiples of 8 elements and 16-byte aligned
// pointers, so that every row of every operand is whole 16-byte chunks.
inline bool aligned(int D, long long sb, long long st, long long sh,
                    std::initializer_list<const void*> ptrs) {
  if (D % 8 || sb % 8 || st % 8 || sh % 8) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two fp32 values rounded to bf16 (nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a [n, D] bf16 matrix (row stride
// `stride` elements, 16-byte aligned rows, D % 8 == 0) into a padded
// [ROWS, DP] tile; rows past n and columns past D are zero.
template <int DP, int ROWS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int n,
                                          int D) {
  constexpr int CPR = DP / 8;          // 16-byte chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CPR; e += kMmaThreads) {
    const int r = e / CPR;
    const int c = (e % CPR) * 8;
    const int t = row0 + r;
    const bool valid = t < n && c < D;
    cp_async16(dst + r * Tile<DP>::LD + c,
               valid ? src + t * stride + c : src, valid);
  }
}

// ROWS fp32 values of a per-row [n] vector (lse, delta) into shared
// memory; zero past n.
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int row0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += kMmaThreads) {
    const bool valid = row0 + r < n;
    cp_async4(dst + r, valid ? src + row0 + r : src, valid);
  }
}

// The q tile in place: each bf16 x becomes round_bf16(float(x) * scale),
// the scaled q of the contract.
template <int DP, int ROWS>
__device__ __forceinline__ void scale_tile(bf16* tile, float scale) {
  constexpr int LD = Tile<DP>::LD;
  for (int e = threadIdx.x; e < ROWS * DP / 2; e += kMmaThreads) {
    const int r = e / (DP / 2);
    const int c = (e % (DP / 2)) * 2;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(tile + r * LD + c);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * Tile<DP>::LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles where the tile's rows are the n index and its
// columns the k index (B = tileᵀ: K for q.kᵀ, q_scaled or dO for the
// transposed products): rows [n0, n0 + 16), columns [k0, k0 + 16).
// b[0], b[1] feed n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int DP>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Tile<DP>::LD +
                 k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles where the tile's rows are the k index and its
// columns the n index (V for P . V, K for dS . K, dO and q_scaled for the
// dk/dv products): rows [k0, k0 + 16), columns [n0, n0 + 16).
template <int DP>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                   Tile<DP>::LD + n0 + (lane >> 4) * 8);
}

// c[MT][NB / 8][4] = A . B[NB rows of `b_tile` from b_r0, DP]ᵀ: the [16,
// NB] score-shaped products of MT 16-row strips of A with a row-major tile
// over the head dimension (q.kᵀ, dO.vᵀ, k.qᵀ, v.dOᵀ). a_frag(a, mt, kd)
// puts the A fragment of strip mt, columns [16 kd, 16 kd + 16) into a
// (from shared memory or from registers). Each B fragment loaded serves
// all MT strips.
template <int DP, int NB, int MT, typename AFrag>
__device__ __forceinline__ void mm_abt(float (&c)[MT][NB / 8][4],
                                       AFrag a_frag, const bf16* b_tile,
                                       int b_r0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int kd = 0; kd < Tile<DP>::KD; ++kd) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) a_frag(a[mt], mt, kd);
#pragma unroll
    for (int jj = 0; jj < NB / 16; ++jj) {
      uint32_t b[4];
      load_b_nk<DP>(b, b_tile, b_r0 + jj * 16, kd * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(c[mt][2 * jj], a[mt], b[0], b[1]);
        mma(c[mt][2 * jj + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// One strip: c[NB / 8][4] = A[16 rows of `a_tile` from a_r0, DP] .
// B[NB rows of `b_tile` from b_r0, DP]ᵀ.
template <int DP, int NB>
__device__ __forceinline__ void mm_abt(float (&c)[NB / 8][4],
                                       const bf16* a_tile, int a_r0,
                                       const bf16* b_tile, int b_r0) {
  mm_abt<DP, NB, 1>(
      reinterpret_cast<float (&)[1][NB / 8][4]>(c),
      [&](uint32_t (&a)[4], int, int kd) {
        load_a<DP>(a, a_tile, a_r0, kd * 16);
      },
      b_tile, b_r0);
}

// acc[MT][ND][4] += bf16(S) . V[NK rows of `tile` from r0, DP], where S
// is MT strips of a [16, NK] fp32 product in C fragments s[MT][NK / 8][4]
// (P or dS). Each k step's A fragments are rounded to bf16 and packed from
// s just before their products; each V fragment loaded serves all MT
// strips.
template <int DP, int NK, int MT>
__device__ __forceinline__ void mm_pv(float (&acc)[MT][Tile<DP>::ND][4],
                                      const float (&s)[MT][NK / 8][4],
                                      const bf16* tile, int r0) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      a[mt][1] = pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      a[mt][2] = pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      a[mt][3] = pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dd = 0; dd < Tile<DP>::ND / 2; ++dd) {
      uint32_t b[4];
      load_b_kn<DP>(b, tile, r0 + kk * 16, dd * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * dd], a[mt], b[0], b[1]);
        mma(acc[mt][2 * dd + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// One strip: acc[ND][4] += bf16(S[16, NK]) . V.
template <int DP, int NK>
__device__ __forceinline__ void mm_pv(float (&acc)[Tile<DP>::ND][4],
                                      const float (&s)[NK / 8][4],
                                      const bf16* tile, int r0) {
  mm_pv<DP, NK, 1>(reinterpret_cast<float (&)[1][Tile<DP>::ND][4]>(acc),
                   reinterpret_cast<const float (&)[1][NK / 8][4]>(s), tile,
                   r0);
}

// Write a warp's [16, DP] fp32 accumulator times `mul` as bf16 rows
// row0 + g, row0 + g + 8 (below n, columns below D) of a contiguous
// [B, n, H, D] tensor at (b, h).
template <int DP>
__device__ __forceinline__ void store_strip(bf16* out,
                                           const float (&acc)[Tile<DP>::ND][4],
                                           int b, int h, int H, int n, int D,
                                           int row0, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + g + 8 * half;
    if (t >= n) continue;
    bf16* row = out + ((static_cast<long long>(b) * n + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < Tile<DP>::ND; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(row + col) =
            pack(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
      }
    }
  }
}

}  // namespace flash_mma

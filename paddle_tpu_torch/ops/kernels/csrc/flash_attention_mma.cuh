// mma.sync tile code shared by the bf16 kernels that run on Hopper's
// mma.sync tensor-core path (int8_weight_matmul.cu `int8_mma_kernel`, the
// fused linear-CE kernels' dlg fragments) and the small pieces every
// tensor-core kernel uses (shared-memory addresses, cp.async copies, bf16
// packing, the bf16 route's operand contract). It began as the first bf16
// flash-attention kernels' header; those kernels now run on wgmma
// (flash_attention_wgmma.cuh).
//
// Fragments of mma.m16n8k16.row.col (lane = 4 g + tq, g < 8, tq < 4):
//   A [16 x 16]  a[0]: row g,     cols 2 tq, 2 tq + 1     a[1]: row g + 8
//                a[2]: row g,     cols 8 + 2 tq, ...      a[3]: row g + 8
//   B [16 x 8]   b[0]: rows 2 tq, 2 tq + 1 of col g       b[1]: rows + 8
//   C [16 x 8]   c[0..1]: row g, cols 2 tq, 2 tq + 1;  c[2..3]: row g + 8
// The C layout of two neighbouring n-tiles is the A layout of one k step,
// so a product's fp32 result, rounded to bf16 and packed, feeds the next
// product from registers without going through shared memory.
//
// Shared-memory tiles for ldmatrix hold bf16 rows of DP columns padded by
// 8: a row is DP + 8 elements apart, so the eight 16-byte row addresses of
// one ldmatrix phase start on banks 4 i (mod 32) and touch every bank once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_attention_common.cuh"

namespace flash_mma {

using flash::kNegInf;                  // the JAX package's mask constant

typedef __nv_bfloat16 bf16;

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

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * Tile<DP>::LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles where the tile's rows are the k index and its
// columns the n index (a weight tile of x . W): rows [k0, k0 + 16),
// columns [n0, n0 + 16).
template <int DP>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                   Tile<DP>::LD + n0 + (lane >> 4) * 8);
}

}  // namespace flash_mma

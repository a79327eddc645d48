// Shared pieces of the bf16 flash-attention kernels on wgmma and TMA
// (flash_attention_fwd.cu `flash_fwd_wgmma_kernel`, flash_attention_bwd.cu
// `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel`).
//
// A CTA (`Cta`) is a producer warpgroup and one or two consumer
// warpgroups, each consumer owning 64 resident rows (q rows in the forward
// and dq kernels, key rows in the dk/dv kernel). Tiles are rows of DP = 64
// or 128 bf16 columns, stored as DP / 64 blocks of 64 columns in wgmma's
// 128-byte swizzle (wgmma.cuh), one block after the other: a [128, DP]
// tile is DP / 64 blocks of 16 KB, a [64, DP] one DP / 64 blocks of 8 KB.
// A consumer thread's rows of a 64-row result are r_lo = 16 warp + g and
// r_lo + 8 (lane = 4 g + tq), its columns 8 j + 2 tq + e.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace flash_wgmma {

using flash_mma::bf16;
using flash_mma::kLog2e;
using flash_mma::pack;

constexpr float kNegInf = -1e30f;      // the JAX package's mask constant
constexpr int kKeys = 128;             // keys of a k tile (forward, dq)
constexpr int kBlock128 = 128 * 128;   // bytes of a [128, 64] block
constexpr int kBlock64 = 64 * 128;     // bytes of a [64, 64] block
constexpr int kProducerRegs = 24;

// A CTA at head width DP: the producer warpgroup and kConsumers consumer
// warpgroups of 64 resident rows each (q rows in the forward and dq
// kernels, key rows in the dk/dv kernel). Two consumers in one CTA an SM
// at DP = 128; at DP <= 64 one, in two CTAs an SM, which then run their
// softmax and products out of step (measured faster than two consumers in
// lockstep). setmaxnreg gives the consumers what the producer leaves.
template <int DP>
struct Cta {
  static constexpr int kConsumers = DP > 64 ? 2 : 1;
  static constexpr int kPerSm = DP > 64 ? 1 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kRows = 64 * kConsumers;
  static constexpr int kResBlock = kRows * 128;   // bytes of [kRows, 64]
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = DP > 64 ? 240 : 232;
  static_assert(kPerSm * 128 * (kConsumers * kConsumerRegs + kProducerRegs)
                    <= 65536, "registers");
};

// Rows [r0, r0 + 64) of a swizzled tile of 64-column blocks `block` bytes
// apart, in place: each bf16 x becomes round_bf16(float(x) * scale), the
// scaled q of the contract (the swizzle does not matter to an elementwise
// pass). t is the thread's index in its warpgroup. When `out` is not null
// the scaled rows below `rows` also go to out + r * row_stride (columns
// below D): the q_s that the dk/dv kernel reads.
template <int DP>
__device__ __forceinline__ void scale_rows(unsigned char* tile, int block,
                                           int r0, int t, float scale,
                                           bf16* out, long long row_stride,
                                           int rows, int D) {
  constexpr int CPR = DP / 8;          // 16-byte chunks per row
#pragma unroll 4
  for (int e = t; e < 64 * CPR; e += 128) {
    const int r = e / CPR;
    const int c = e % CPR;
    uint4* p = reinterpret_cast<uint4*>(tile + (c / 8) * block +
                                        gmma::sw128(r0 + r, c % 8));
    uint4 x = *p;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(v[i]);
      v[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = x;
    if (out != nullptr && r < rows && 8 * c < D) {
      *reinterpret_cast<uint4*>(out + r * row_stride + 8 * c) = x;
    }
  }
}

// Write a consumer thread's share of a [64, DP] fp32 result times `mul` as
// bf16: rows r_lo and r_lo + 8 (below n, columns below D) of a contiguous
// [B, n, H, D] tensor at (b, h).
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[DP / 2], int b,
                                           int h, int H, int n, int D,
                                           int r_lo, int tq, float mul) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r_lo + 8 * hh;
    if (t >= n) continue;
    bf16* row = out + ((static_cast<long long>(b) * n + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(row + col) =
            pack(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
      }
    }
  }
}

// The A fragments of a [64, 16 KK] fp32 result held in wgmma's
// accumulator layout, rounded to bf16 and packed: a[kk] is k step kk of
// an `_rs` product.
template <int KK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4],
                                       const float (&d)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// d[64, DP] += A . B over KK k steps: A in registers (`pack_a`), B a tile
// of swizzled 64-column blocks `block` bytes apart read MN-major (its rows
// are the k index).
template <int DP, int KK>
__device__ __forceinline__ void mma_rs(float (&d)[DP / 2],
                                       const uint32_t (&a)[KK][4],
                                       const unsigned char* b, int block) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint64_t db = gmma::gmma_desc(b + kk * 16 * 128, block, 1024);
    if constexpr (DP == 128) {
      gmma::wgmma_64x128_rs(d, a[kk], db);
    } else {
      gmma::wgmma_64x64_rs(d, a[kk], db);
    }
  }
}

// d[64, 16 NJ] = A[64 rows of `a`, DP] . B[16 NJ rows of `b`, DP]ᵀ, both
// K-major tiles of swizzled 64-column blocks (`a_block`, `b_block` bytes
// apart); NJ = 8 (m64n64) or 16 (m64n128). The first k step overwrites d.
template <int DP, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2],
                                       const unsigned char* a, int a_block,
                                       const unsigned char* b, int b_block) {
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    const int col = (kd % 4) * 32;
    const uint64_t da =
        gmma::gmma_desc(a + (kd / 4) * a_block + col, 16, 1024);
    const uint64_t db =
        gmma::gmma_desc(b + (kd / 4) * b_block + col, 16, 1024);
    if constexpr (N == 128) {
      gmma::wgmma_64x128_ss(d, da, db, kd > 0);
    } else {
      gmma::wgmma_64x64_ss(d, da, db, kd > 0);
    }
  }
}

// 2^x on the SFU in one instruction (ex2.approx; subnormal results, below
// 2^-126, flush to zero, which no sum of these probabilities can see)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the per-warp release of a ring stage, once the warp's products have read
// it (wgmma_wait before)
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) tma::mbar_arrive(empty);
}

// The work of a persistent kernel: (b*h, tile) pairs, handed out in turn
// from a counter in device memory (zeroed by the caller before the launch)
// to whichever CTA's producer asks next, so the CTAs stay balanced. The
// order goes by groups of `group` heads, sized so that the operands every
// tile of a head streams (K and V for a q tile, q_s and dO for a k tile)
// of one group fit in L2 together; within a group, tiles longest first
// (rank 0 = the longest) across its heads.
struct Schedule {
  int* next;
  int heads, tiles, group;

  __device__ int works() const { return heads * tiles; }

  __device__ void decode(int w, int& bh, int& rank) const {
    const int per = group * tiles;
    const int g = w / per;
    const int in_group = min(group, heads - g * group);
    const int rem = w - g * per;
    rank = rem / in_group;
    bh = g * group + rem % in_group;
  }
};

// Heads per group of a Schedule whose heads each stream `bytes` per tile
// of work: a group's streamed operands take at most 16 MB of the 50 MB L2.
inline int group_heads(long long bytes, int heads) {
  const long long g = (16ll << 20) / (bytes > 0 ? bytes : 1);
  return static_cast<int>(g < 1 ? 1 : (g > heads ? heads : g));
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// carveout at its most shared memory (two CTAs an SM at DP <= 64); once,
// before any CUDA-graph capture. Returns the cudaError.
template <typename Kernel>
int opt_in(Kernel kernel, int smem, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

// CTAs of a persistent launch over `works` work tiles: `per_sm` on each SM
// of the current device, at most one per tile; 0 when the device cannot be
// queried.
inline int persistent_grid(int works, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return works < sms * per_sm ? works : sms * per_sm;
}

}  // namespace flash_wgmma

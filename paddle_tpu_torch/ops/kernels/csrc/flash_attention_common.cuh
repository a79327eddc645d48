// Shared pieces of the fp32 (SIMT) flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): tile sizes, shared-
// memory tile loads and the two small matrix products they are built from.
// The bf16 kernels run on the tensor cores (flash_attention_mma.cuh).
//
// Layout. A CTA of kThreads = 256 threads works on 64 x 64 score tiles.
// Thread t is (ty, tx) = (t / 16, t % 16); the 16 threads of one ty are
// one half of a warp, so a row reduction over them is four xor shuffles.
// In a score tile the thread owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4). In an output tile ([64 rows, DP columns]) it owns the same
// rows and the columns tx * 4 + 64 jj + c (c < 4, jj < DP / 64).
//
// Every tile lives in shared memory as fp32 and products accumulate in
// fp32 FMAs: exact fp32 arithmetic, the JAX package's fp32 contract. A row
// of a [64, DP] tile is DP + 4 floats apart, so the float4 loads of 8
// threads that read 8 different rows fall on 8 different groups of 4
// banks.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLP = kTile + 4;      // row stride of a [64, 64] score tile
constexpr float kNegInf = -1e30f;   // the JAX package's mask constant
constexpr unsigned kFull = 0xffffffffu;

// Sum (or max) over the 16 threads of a half warp that share one tile row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// dst[r, c] = src[(row0 + r) * stride + c] * mul for the rows below n and
// the columns below D; zero elsewhere (the ragged tail of the sequence and
// the padding columns D..DP-1).
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int row0, int n,
                                          int D, float mul) {
  constexpr int LD = DP + 4;
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP;
    const int c = e % DP;
    const int t = row0 + r;
    float x = 0.f;
    if (t < n && c < D) x = src[t * stride + c] * mul;
    dst[r * LD + c] = x;
  }
}

// out[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], both [64, DP] tiles.
template <int DP>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&out)[4][4], int ty, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[4];
    float4 b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = out[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        out[i][j] = s;
      }
    }
  }
}

// acc[i][4 jj + c] += sum_k P[ty + 16 i][k] * V[k][tx * 4 + 64 jj + c]:
// P a [64, 64] score tile (row stride kLP), V a [64, DP] tile.
template <int DP>
__device__ __forceinline__ void mm_nn_acc(const float* P, const float* V,
                                          float (&acc)[4][DP / 16], int ty,
                                          int tx) {
  constexpr int LD = DP + 4;
  constexpr int NJ = DP / 64;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLP + k);
      p[i][0] = q4.x;
      p[i][1] = q4.y;
      p[i][2] = q4.z;
      p[i][3] = q4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            V + (k + u) * LD + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i][u], v4.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i][u], v4.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i][u], v4.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i][u], v4.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Write rows row0 + ty + 16 i (below n) of acc * mul to a contiguous
// [B, n, H, D] output at (b, h).
template <int DP>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[4][DP / 16],
                                           int b, int h, int H, int n, int D,
                                           int row0, float mul, int ty,
                                           int tx) {
  constexpr int NJ = DP / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty + 16 * i;
    if (t >= n) continue;
    float* row = out + ((static_cast<long long>(b) * n + t) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx * 4 + 64 * jj + c;
        if (col < D) row[col] = acc[i][4 * jj + c] * mul;
      }
    }
  }
}

}  // namespace flash

// int8-weight matmul for Hopper (sm_90a): out = (x @ float(w_q)) * scale.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py `_mm_kernel` (launched
// by `_int8_weight_matmul_pallas`), the TPU kernel behind
// `int8_weight_matmul`. Same math:
//     out[m, n] = scale[n] * sum_k x[m, k] * float(w_q[k, n])
// with x fp32 [M, K], w_q int8 [K, N] (the `[in, out]` layout of
// paddle_tpu_torch/quant/ptq.py), scale fp32 [N] (one per output channel,
// constant along k, so it is applied once after the accumulate), out fp32.
//
// What bounds it: at decode shapes (M = batch rung, 1-8) bytes — the int8
// weight is read once (K * N bytes) and each weight byte feeds only M
// multiply-adds. At prefill shapes (M up to ~1000 prompt rows) fp32
// operations on CUDA cores: x is fp32, so an int8 tensor-core product
// would have to quantize x and change the function, and TF32 is never
// used.
//
// Design. The Pallas kernel holds all of x, w and out in VMEM as one block
// (no grid). Here two kernels cover the two regimes; both convert the int8
// values to fp32 in registers, do fp32 FMAs, and scale once at the end.
//   * M <= 8 (decode): a CTA owns a strip of C columns of out (C = 32, or
//     16 when N is too narrow for 32-column strips to give two CTAs per
//     two SMs) for every row. Its 256 threads are C/4 column groups (4
//     columns each: one 4-byte load per weight row) by 1024/C k groups,
//     each of which walks its own contiguous slice of K, 4 rows at a time,
//     holding all M rows of out for its 4 columns in registers (x comes
//     from L1/L2 as float4). The strip's whole K x C panel is thus in
//     flight at once; the k groups' partial sums of each output are then
//     added through shared memory in k-group order, so the result does not
//     depend on timing. The codes become floats with a byte permute and one
//     fp32 subtract (no integer-to-float conversion instruction): measured
//     on the H100 this path is bound by instruction issue more than by
//     bytes. At N = 768 that is 48 CTAs; with no split of K across CTAs
//     the card is not filled (later work).
//   * M > 8 (prefill): each CTA owns one 64 x 64 tile of out and loops over
//     K in 32-deep steps through shared memory: the x tile (fp32) and the w
//     tile (int8) are staged with 16-byte loads, and each thread
//     accumulates a 4 x 4 register tile (the classic SIMT SGEMM blocking),
//     summing k in ascending order.
// Ragged edges (M, N, K not multiples of the tile, or operands not aligned
// for vector loads) take the same kernels with scalar, bounds-checked
// loads.
//
// Known limits: no split-K across CTAs, no double buffering and no
// wgmma/TMA; those are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int8_weight_matmul_kernel(const float* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int M, int N, int K) {
  constexpr int kCols = BN / TN;             // threads across the tile
  constexpr int kRowsT = BM / TM;            // threads down the tile
  constexpr int kThreads = kCols * kRowsT;
  constexpr int kXPad = 4;                   // keeps float4 stores aligned
  __shared__ __align__(16) float xs[BM][BK + kXPad];
  __shared__ __align__(16) int8_t ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage x[m0:m0+BM, k0:k0+BK] -> xs (row-major, zero outside)
    if (VEC) {
      for (int idx = tid; idx < BM * BK / 4; idx += kThreads) {
        const int r = idx / (BK / 4);
        const int c = (idx % (BK / 4)) * 4;
        const int gm = m0 + r;
        const int gk = k0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gm < M && gk < K) {              // K % 4 == 0: all 4 in range
          v = *reinterpret_cast<const float4*>(
              x + static_cast<long long>(gm) * K + gk);
        }
        *reinterpret_cast<float4*>(&xs[r][c]) = v;
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        const int gm = m0 + r;
        const int gk = k0 + c;
        xs[r][c] = (gm < M && gk < K)
                       ? x[static_cast<long long>(gm) * K + gk] : 0.f;
      }
    }
    // stage w[k0:k0+BK, n0:n0+BN] -> ws (int8, zero outside)
    if (VEC) {
      for (int idx = tid; idx < BK * BN / 16; idx += kThreads) {
        const int r = idx / (BN / 16);
        const int c = (idx % (BN / 16)) * 16;
        const int gk = k0 + r;
        const int gn = n0 + c;
        int4 v = make_int4(0, 0, 0, 0);
        if (gk < K && gn < N) {              // N % 16 == 0: all 16 in range
          v = *reinterpret_cast<const int4*>(
              w + static_cast<long long>(gk) * N + gn);
        }
        *reinterpret_cast<int4*>(&ws[r][c]) = v;
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += kThreads) {
        const int r = idx / BN;
        const int c = idx % BN;
        const int gk = k0 + r;
        const int gn = n0 + c;
        ws[r][c] = (gk < K && gn < N)
                       ? w[static_cast<long long>(gk) * N + gn]
                       : static_cast<int8_t>(0);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + i * kRowsT][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = static_cast<float>(ws[k][tx + j * kCols]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx + j * kCols;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * kRowsT;
      if (gm < M) out[static_cast<long long>(gm) * N + gn] = acc[i][j] * s;
    }
  }
}

constexpr int kGemvM = 8;         // rows the decode kernel holds
constexpr int kGemvThreads = 256;

// The 4 int8 codes of `word` as exact floats: XOR 0x80 turns code c into
// the byte c + 128, a byte permute sets it under the exponent of 2^23,
// and subtracting 2^23 + 128 leaves c.
__device__ __forceinline__ void s8x4_to_f32(unsigned word, float (&f)[4]) {
  const unsigned u = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  }
}

template <bool VEC, int kCols>
__global__ void __launch_bounds__(kGemvThreads)
int8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int N, int K, int kchunk) {
  constexpr int kGroups = kGemvThreads / (kCols / 4);   // k groups
  __shared__ __align__(16) float red[kGroups][kGemvM][kCols];
  const int cg = threadIdx.x % (kCols / 4);  // column group: 4 columns
  const int g = threadIdx.x / (kCols / 4);   // k group
  const int n0 = blockIdx.x * kCols + cg * 4;
  const int kb = g * kchunk;
  const int ke = min(K, kb + kchunk);

  float acc[kGemvM][4];
#pragma unroll
  for (int m = 0; m < kGemvM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (VEC && n0 < N) {                       // N % 4 == 0, K % 4 == 0
#pragma unroll 2
    for (int k = kb; k < ke; k += 4) {       // kchunk % 4 == 0
      unsigned wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = *reinterpret_cast<const unsigned*>(
            w + static_cast<long long>(k + j) * N + n0);
      }
      float4 xv[kGemvM];
#pragma unroll
      for (int m = 0; m < kGemvM; ++m) {
        xv[m] = m < M ? __ldg(reinterpret_cast<const float4*>(
                            x + static_cast<long long>(m) * K + k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b[4];
        s8x4_to_f32(wv[j], b);
#pragma unroll
        for (int m = 0; m < kGemvM; ++m) {
          const float a = j == 0 ? xv[m].x : j == 1 ? xv[m].y
                        : j == 2 ? xv[m].z : xv[m].w;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(a, b[c], acc[m][c]);
        }
      }
    }
  } else if (!VEC) {
    for (int k = kb; k < ke; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + c;
        if (n >= N) continue;
        const float b = static_cast<float>(
            w[static_cast<long long>(k) * N + n]);
#pragma unroll
        for (int m = 0; m < kGemvM; ++m) {
          if (m < M) {
            acc[m][c] = fmaf(x[static_cast<long long>(m) * K + k], b,
                             acc[m][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kGemvM; ++m) {
    *reinterpret_cast<float4*>(&red[g][m][cg * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  // one output per thread: row m, column col of the strip
  const int m = threadIdx.x / kCols;
  const int col = threadIdx.x % kCols;
  const int n = blockIdx.x * kCols + col;
  if (m < M && n < N) {
    float sum = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < kGroups; ++gg) sum += red[gg][m][col];
    out[static_cast<long long>(m) * N + n] = sum * scale[n];
  }
}

template <int kCols>
int launch_gemv(const float* x, const int8_t* w, const float* scale,
                float* out, int M, int N, int K, bool vec,
                cudaStream_t stream) {
  constexpr int kGroups = kGemvThreads / (kCols / 4);
  // contiguous K slice per k group, a multiple of 4 rows
  const int kchunk = ((K + kGroups - 1) / kGroups + 3) / 4 * 4;
  dim3 grid((N + kCols - 1) / kCols);
  if (vec) {
    int8_gemv_kernel<true, kCols><<<grid, kGemvThreads, 0, stream>>>(
        x, w, scale, out, M, N, K, kchunk);
  } else {
    int8_gemv_kernel<false, kCols><<<grid, kGemvThreads, 0, stream>>>(
        x, w, scale, out, M, N, K, kchunk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int TM, int TN>
int launch(const float* x, const int8_t* w, const float* scale, float* out,
           int M, int N, int K, bool vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  if (vec) {
    int8_weight_matmul_kernel<BM, BN, BK, TM, TN, true>
        <<<grid, block, 0, stream>>>(x, w, scale, out, M, N, K);
  } else {
    int8_weight_matmul_kernel<BM, BN, BK, TM, TN, false>
        <<<grid, block, 0, stream>>>(x, w, scale, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. x fp32 [M, K], w int8 [K, N], scale
// fp32 [N], out fp32 [M, N], all contiguous. Launches on `stream` and does
// not synchronise. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
extern "C" int int8_weight_matmul_f32(const void* x, const void* w,
                                      const void* scale, void* out, int M,
                                      int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (K % 4 == 0) && (N % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kGemvM) {
    const bool vec4 = (K % 4 == 0) && (N % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(w) % 4 == 0);
    // 32-column strips while they give at least one CTA per two SMs
    return (N + 31) / 32 >= 66
               ? launch_gemv<32>(xf, wq, sf, of, M, N, K, vec4, s)
               : launch_gemv<16>(xf, wq, sf, of, M, N, K, vec4, s);
  }
  return launch<64, 64, 32, 4, 4>(xf, wq, sf, of, M, N, K, vec, s);
}

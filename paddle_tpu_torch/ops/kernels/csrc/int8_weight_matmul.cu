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
// What bounds it: at decode shapes (M = batch rung, 1-8) bytes -- the int8
// weight is read once (K * N bytes) and each weight byte feeds only M
// multiply-adds. At prefill shapes (M = the prompt's rows, up to ~1000)
// operations. There the tensor cores take the product without changing
// the function, by an exact split of x:
//   * every int8 code is exact in bf16 (|q| <= 128 needs 8 significant
//     bits);
//   * x = b0 + b1 + b2 exactly: b0 = x with its low 16 bits cleared (x
//     cut to bf16: its top 8 significant bits), b1 = x - b0 cut likewise
//     (x - b0 is exact in fp32 and has at most 16 significant bits), b2 =
//     x - b0 - b1 (exact, at most 8 significant bits left, so a bf16);
//     three bf16 pieces carry fp32's 24 significant bits;
//   * each product bi * q is exact in fp32, and the sums are fp32.
// Cutting rather than rounding to bf16 (b0 = bf16_rn(x), ...) splits as
// exactly and needs no conversion instruction, which measured faster on
// the H100.
// So three bf16 products with fp32 sums give the fp32 function to within
// fp32 rounding: no quantization of x, no TF32. Their bound is 3 x 2 MKN
// flops at 989 TFLOP/s (0.264 ms for the 48 block matmuls of GPT-2 124M at
// M = 512, against 1.299 ms for 2 MKN at the 67 TFLOP/s of the CUDA cores).
//
// Design. The Pallas kernel holds all of x, w and out in VMEM as one block
// (no grid). Here two kernels cover the two regimes; both scale once at
// the end.
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
//     bytes. fp32 FMAs on the CUDA cores. At N = 768 that is 48 CTAs; with
//     no split of K across CTAs the card is not filled (later work).
//   * M > 8 (prefill): `int8_mma_kernel`, mma.sync m16n8k16 (bf16
//     operands, fp32 sums). A CTA of four warps owns a 64 x 64 tile of out
//     (each warp 32 x 32) and walks its K range in 32-deep steps. Each
//     step's x tile [64, 32] (fp32) and w tile [32, 64] (int8) are loaded
//     into registers one step ahead, then split and converted once as
//     they are stored to shared memory: x into its three bf16 pieces
//     (three A tiles), w's codes into bf16 (the B tile, read N-major by
//     ldmatrix.trans, as the flash kernels read V). Per 16-deep k slice a
//     warp runs acc += b2.q, acc += b1.q, acc += b0.q, smallest first; the
//     B fragments serve all three pieces. Two shared-memory buffers, one
//     barrier a step. Padded rows (40 and 72 bf16) keep ldmatrix free of
//     bank conflicts. Measured alternatives that were no faster: 64 x 128
//     tiles, loads two steps ahead, a deeper split of K.
//     Filling 132 SMs: at M = 512 the step's four shapes (N = 768, 2304,
//     3072; K = 768 or 3072) give 96, 288 or 384 tiles. Where the tiles
//     are fewer than two per SM, K is split into S contiguous ranges of at
//     least 256 (S = ceil(2 SMs / tiles), 3 for both N = 768 shapes: 288
//     CTAs); each range's unscaled [M, N] partial goes to a workspace [S,
//     M, N] that the wrapper allocates, and a second kernel sums the
//     partials in range order and scales them. Fixed orders, no atomics:
//     two calls give the same bits.
// Ragged edges (M, N, K not multiples of the tile) are zero-filled in the
// staged tiles. Operands not aligned for vector loads (K % 4, N % 16, or a
// base off 16 bytes) take the same kernels with scalar, bounds-checked
// loads, so the wrapper copies nothing.

#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace {

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

// ------------------------------------------------ M > 8: tensor cores

namespace fm = flash_mma;
using fm::bf16;

constexpr int kBM = 64;                   // rows of out per CTA
constexpr int kBN = 64;                   // columns of out per CTA
constexpr int kBK = 32;                   // k per step
constexpr int kWarpsN = kBN / 32;         // warps across; 2 down, 32 x 32 each
constexpr int kMmaThreads = 64 * kWarpsN;
constexpr int kXLoads = kBM * kBK / 4 / kMmaThreads;   // float4s a thread
constexpr int kPieces = 3;                // bf16 pieces of x
constexpr int kLDA = fm::Tile<kBK>::LD;   // 40: padded bf16 row of a piece
constexpr int kLDB = fm::Tile<kBN>::LD;   // 72: padded bf16 row of w's tile
constexpr int kSplitMinK = 256;           // least K range of a split
static_assert(kBK * kBN / 16 == kMmaThreads, "one 16-byte w load a thread");

// x's three bf16 pieces, as floats: b0 = x with its low 16 bits cleared
// (x's top 8 significant bits), b1 = x - b0 likewise, b2 = x - b0 - b1 (at
// most 8 significant bits are left); the differences are exact in fp32
__device__ __forceinline__ void split3(float x, float (&b)[kPieces]) {
  b[0] = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r1 = x - b[0];
  b[1] = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
  b[2] = r1 - b[1];
}

// One k step's operands in registers: x rows (e / 8), columns 4 (e % 8) ..
// + 4 of the step for e = tid + i threads; w row tid / (kBN / 16),
// columns 16 (tid % (kBN / 16)) .. + 16 of the tile, as 16 int8 codes.
// Zeros outside [M, K] and [K, N].
template <bool VEC>
__device__ __forceinline__ void load_step(float (&xr)[kXLoads][4], uint4& wr,
                                          const float* x, const int8_t* w,
                                          int M, int N, int K, int m0,
                                          int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int gm = m0 + (e >> 3);
    const int gk = k0 + (e & 7) * 4;
    const float* p = x + static_cast<long long>(gm) * K + gk;
    if (VEC) {                           // K % 4 == 0: all 4 in range
      const float4 v = gm < M && gk < K
                           ? __ldg(reinterpret_cast<const float4*>(p))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xr[i][0] = v.x;
      xr[i][1] = v.y;
      xr[i][2] = v.z;
      xr[i][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xr[i][e] = gm < M && gk + e < K ? p[e] : 0.f;
      }
    }
  }
  const int gk = k0 + tid / (kBN / 16);
  const int gn = n0 + tid % (kBN / 16) * 16;
  const int8_t* p = w + static_cast<long long>(gk) * N + gn;
  if (VEC) {                             // N % 16 == 0: all 16 in range
    wr = gk < K && gn < N ? __ldg(reinterpret_cast<const uint4*>(p))
                          : make_uint4(0u, 0u, 0u, 0u);
  } else {
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const unsigned b = gk < K && gn + e < N
                             ? static_cast<unsigned char>(p[e]) : 0u;
      word[e / 4] |= b << (8 * (e % 4));
    }
    wr = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// The staged step into shared memory: x split into its three bf16 pieces,
// w's codes as bf16 (exact).
__device__ __forceinline__ void store_step(bf16 (&sA)[kPieces][kBM * kLDA],
                                           bf16 (&sB)[kBK * kLDB],
                                           const float (&xr)[kXLoads][4],
                                           const uint4& wr) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    float b[4][kPieces];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(xr[i][e], b[e]);
    const int t = tid + i * kMmaThreads;
    const int off = (t >> 3) * kLDA + (t & 7) * 4;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      *reinterpret_cast<uint2*>(&sA[q][off]) =
          make_uint2(fm::pack(b[0][q], b[1][q]), fm::pack(b[2][q], b[3][q]));
    }
  }
  const unsigned words[4] = {wr.x, wr.y, wr.z, wr.w};
  uint32_t packed[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    s8x4_to_f32(words[j], f);
    packed[2 * j] = fm::pack(f[0], f[1]);
    packed[2 * j + 1] = fm::pack(f[2], f[3]);
  }
  uint4* dst = reinterpret_cast<uint4*>(
      &sB[tid / (kBN / 16) * kLDB + tid % (kBN / 16) * 16]);
  dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// acc += x . w over one k step of the staged tiles: every fragment of the
// step is loaded first (the loads and products are ordered asm), then per
// 16-deep slice the pieces b2, b1, b0 (smallest first) against the same B
// fragments
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4],
                                         const bf16 (&sA)[kPieces][kBM * kLDA],
                                         const bf16 (&sB)[kBK * kLDB],
                                         int wm, int wn) {
  constexpr int KK = kBK / 16;
  uint32_t b[KK][2][4];
  uint32_t a[KK][kPieces][2][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    fm::load_b_kn<kBN>(b[kk][0], sB, 16 * kk, wn);
    fm::load_b_kn<kBN>(b[kk][1], sB, 16 * kk, wn + 16);
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      fm::load_a<kBK>(a[kk][q][0], sA[q], wm, 16 * kk);
      fm::load_a<kBK>(a[kk][q][1], sA[q], wm + 16, 16 * kk);
    }
  }
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int q = kPieces - 1; q >= 0; --q) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          fm::mma(acc[mt][2 * nb], a[kk][q][mt], b[kk][nb][0], b[kk][nb][1]);
          fm::mma(acc[mt][2 * nb + 1], a[kk][q][mt], b[kk][nb][2],
                  b[kk][nb][3]);
        }
      }
    }
  }
}

// out (part == nullptr) or the partial of K range blockIdx.z (part [S, M,
// N], unscaled) of one 64 x 64 tile; K range z is [z kchunk, (z + 1)
// kchunk).
template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
int8_mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ part, int M, int N, int K, int kchunk) {
  __shared__ __align__(16) bf16 sA[2][kPieces][kBM * kLDA];
  __shared__ __align__(16) bf16 sB[2][kBK * kLDB];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN * 32;      // the warp's rows of the tile
  const int wn = warp % kWarpsN * 32;      // and columns
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int nk = (min(K, kbeg + kchunk) - kbeg + kBK - 1) / kBK;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // step kt + 1 is loaded into registers while step kt's products run
  float xr[kXLoads][4];
  uint4 wr;
  if (nk > 0) {
    load_step<VEC>(xr, wr, x, w, M, N, K, m0, n0, kbeg);
    store_step(sA[0], sB[0], xr, wr);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_step<VEC>(xr, wr, x, w, M, N, K, m0, n0, kbeg + (kt + 1) * kBK);
    }
    mma_step(acc, sA[buf], sB[buf], wm, wn);
    if (kt + 1 < nk) store_step(sA[buf ^ 1], sB[buf ^ 1], xr, wr);
    __syncthreads();        // buffer buf is free; buf ^ 1 holds step kt + 1
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  float* dst = part ? part + static_cast<long long>(blockIdx.z) * M * N
                    : out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * tq;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float s0 = part ? 1.f : scale[col];
      const float s1 = part || !two ? 1.f : scale[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mt + g + 8 * h;
        if (row >= M) continue;
        float* o = dst + static_cast<long long>(row) * N + col;
        const float v0 = acc[mt][nt][2 * h] * s0;
        const float v1 = acc[mt][nt][2 * h + 1] * s1;
        if (VEC) {                         // N % 16 == 0: col + 1 < N
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

// out = (part[0] + part[1] + ... + part[S - 1]) * scale, in range order
__global__ void int8_splitk_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out,
                                          long long MN, int N, int S) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int z = 1; z < S; ++z) sum += part[z * MN + i];
    out[i] = sum * scale[i % N];
  }
}

// K ranges for an [M, N] out: 1 when the 64 x 64 tiles are at least two
// per SM, else enough to reach two CTAs per SM, each range at least
// kSplitMinK deep.
int split_k(int M, int N, int K) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + kBN - 1) / kBN);
  const long long want = 2LL * sms;
  if (tiles >= want) return 1;
  const long long most = K / kSplitMinK > 1 ? K / kSplitMinK : 1;
  const long long s = (want + tiles - 1) / tiles;
  return static_cast<int>(s < most ? s : most);
}

int launch_mma(const float* x, const int8_t* w, const float* scale,
               float* out, float* workspace, int M, int N, int K, bool vec,
               cudaStream_t stream) {
  const int S = split_k(M, N, K);
  if (S > 1 && workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int steps = (K + kBK - 1) / kBK;
  const int kchunk = (steps + S - 1) / S * kBK;
  float* part = S > 1 ? workspace : nullptr;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
  if (vec) {
    int8_mma_kernel<true><<<grid, kMmaThreads, 0, stream>>>(
        x, w, scale, out, part, M, N, K, kchunk);
  } else {
    int8_mma_kernel<false><<<grid, kMmaThreads, 0, stream>>>(
        x, w, scale, out, part, M, N, K, kchunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long blocks = (MN + 255) / 256;
  int8_splitk_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks
                                                              : 4096),
                              256, 0, stream>>>(workspace, scale, out, MN, N,
                                                S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace `int8_weight_matmul_f32` needs for an [M, K] x [K, N]
// product on the current device: S M N when the M > 8 kernel splits K into
// S ranges, else 0.
extern "C" long long int8_weight_matmul_workspace(int M, int N, int K) {
  if (M <= kGemvM || N <= 0 || K <= 0) return 0;
  const int S = split_k(M, N, K);
  return S > 1 ? static_cast<long long>(S) * M * N : 0;
}

// C entry point, bound with ctypes. x fp32 [M, K], w int8 [K, N], scale
// fp32 [N], out fp32 [M, N], all contiguous; workspace fp32 of
// `int8_weight_matmul_workspace(M, N, K)` floats (null when that is 0).
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int int8_weight_matmul_f32(const void* x, const void* w,
                                      const void* scale, void* out,
                                      void* workspace, int M, int N, int K,
                                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const bool vec = (K % 4 == 0) && (N % 16 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(workspace)) % 16 == 0);
  return launch_mma(xf, wq, sf, of, static_cast<float*>(workspace), M, N, K,
                    vec, s);
}

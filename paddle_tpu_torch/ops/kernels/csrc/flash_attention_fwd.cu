// Flash attention forward for Hopper (sm_90a): O and the per-row logsumexp
// of softmax(scale * q.k) . v, causal or full, fp32 or bf16.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (launched
// by `_fwd`), the TPU kernel behind `flash_attention`'s forward. Same
// arithmetic: q is scaled in fp32 and rounded to the operand type, scores
// accumulate in fp32, masked scores are -1e30, the online softmax keeps the
// running max m and denominator l in fp32, P is rounded to the operand type
// before P . V, l is clamped at 1e-30, O = acc / l in the input type and
// lse = m + log(l) in fp32.
//
// Layout: q, k, v are read in place as [B, T, H, D] through (batch, token,
// head) strides with a unit last stride, so the q/k/v chunks of a fused qkv
// projection need no transpose or copy (the TPU code transposes to
// [B*H, T, D]). O is written contiguous [B, T, H, D]; lse is [B*H, T] fp32
// (the TPU's lane-replicated [B*H, T, 128] layout is not kept).
//
// Two routes, chosen by the operand type. The choice is the arithmetic
// contract, not a fallback: each route computes what its type promises.
//   fp32  `flash_fwd_kernel`: fp32 FMAs on the CUDA cores over fp32
//         shared-memory tiles (flash_attention_common.cuh), exact fp32
//         products, the JAX package's 2e-5 contract. Tensor cores would
//         round fp32 operands to TF32 and break it.
//   bf16  `flash_fwd_mma_kernel`: the products on the tensor cores
//         (mma.sync m16n8k16, bf16 operands, fp32 accumulators;
//         flash_attention_mma.cuh), which is exactly the contract's bf16
//         operands with fp32 sums.
//
// What bounds it on the H100: at the main path's B = 16, H = 12, T = 1024,
// D = 64 causal bf16, the work is 4 * D flops per live (q, k) pair, 25.8
// GFLOP, or 0.026 ms at 989 TFLOP/s (bf16 dense); the bytes are q, k, v, O
// (25.2 MB each) and lse, 101 MB, or 0.030 ms at 3.35 TB/s. At GPT-3 1.3B's
// B = 4, H = 16, T = 2048, D = 128 the flops bound it: 68.7 GFLOP, 0.070 ms.
//
// Design. The TPU walks a sequential (BH, nq, nk) grid and carries (m, l,
// acc) in scratch across the k steps. Here one CTA owns one (b*h, 64-row q
// tile) and loops over the 64-row k tiles itself, only up to the diagonal
// when causal; m, l and acc live in registers. q tiles are scheduled
// longest-first so the causal triangle's long rows start early. Any T
// works: the kernels mask the ragged last tile themselves.
//   fp32: 256 threads, (ty, tx) ownership of 64 x 64 score tiles; D <= 128
//   (tiles padded to DP = 64 or 128 columns).
//   bf16: 4 warps, each owning 16 q rows (32 at D = 128, `fwd_m_tiles`),
//   so a CTA takes 64 (128) q rows. The q tile is copied once, scaled in
//   fp32 and rounded to bf16 in shared memory; at D <= 64 a warp holds its
//   A fragments in registers for the whole k loop. K and V tiles of 64
//   rows stream through a 2-stage cp.async ring: the next tile's copy is
//   issued before the current tile's products. S = q.kᵀ stays in
//   registers; the row max and sum are taken over the 4 lanes of a quad;
//   P = exp2(s log2(e) - m log2(e)) is rounded to bf16 and packed in
//   registers as the A operand of P . V (V through ldmatrix.trans), so P
//   never touches shared memory. Only tiles that cross the diagonal and a
//   ragged last tile are masked; a warp skips a tile its causal rows do not
//   reach. Shared memory: the q tile and 2 stages of K and V, padded bf16,
//   46 KB at D <= 64 and 104 KB at D = 128 (two CTAs per SM). The wrapper
//   gives this route D % 8 == 0 and 16-byte aligned rows (it zero-pads D
//   and copies misaligned operands); the entry point refuses anything else.

#include "flash_attention_mma.cuh"

namespace {

using namespace flash;

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int n, int D, long long sb,
                 long long st, long long sh, int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;

  const int nq = (n + kTile - 1) / kTile;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qi * kTile;

  load_tile<DP>(sQ, q + base, st, q0, n, D, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? qi + 1 : (n + kTile - 1) / kTile;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();            // every reader of the last sK/sV/sP is done
    load_tile<DP>(sK, k + base, st, k0, n, D, 1.f);
    load_tile<DP>(sV, v + base, st, k0, n, D, 1.f);
    __syncthreads();
    float s[4][4];
    mm_nt<DP>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= n || (causal && c > r)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty + 16 * i) * kLP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_nn_acc<DP>(sP, sV, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] / lc;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < n) lse[static_cast<long long>(bh) * n + r] = m[i] + logf(lc);
  }
  store_rows<DP>(o, acc, b, h, H, n, D, q0, 1.f, ty, tx);
}

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (DP + 4) + kTile * kLP);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int n, int H, int D, long long sb, long long st,
           long long sh, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((n + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse),
      H, n, D, sb, st, sh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16 route

// m-tiles (16 rows each) per warp. A warp of two m-tiles uses each K and V
// fragment it loads from shared memory twice. Measured on the H100, that
// is worth its few register spills at D = 128 and gains nothing at D = 64;
// 128-key tiles were slower at both widths.
template <int DP>
__host__ __device__ constexpr int fwd_m_tiles() {
  return DP > 64 ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr int fwd_q_rows() {
  return 16 * fwd_m_tiles<DP>() * flash_mma::kWarps;
}

template <int DP>
__global__ void __launch_bounds__(flash_mma::kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int n, int D, long long sb, long long st,
                     long long sh, int causal, float scale) {
  using namespace flash_mma;
  constexpr int LD = Tile<DP>::LD;
  constexpr int KD = Tile<DP>::KD;
  constexpr int ND = Tile<DP>::ND;
  constexpr int MT = fwd_m_tiles<DP>();
  constexpr int BM = fwd_q_rows<DP>();
  constexpr int BN = kRows;            // keys per tile
  constexpr int NJ = BN / 8;           // n-tiles of a [16, BN] score strip
  constexpr int TILE = BN * LD;
  // q fragments stay in registers while they take at most 32 of them
  constexpr bool kQRegs = MT * KD <= 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LD;             // two stages
  bf16* sV = sK + 2 * TILE;            // two stages

  const int nq = (n + BM - 1) / BM;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = qi * BM;
  const int w0 = warp * 16 * MT;       // the warp's first row in the tile
  const int wr0 = q0 + w0;             // ... and in the sequence
  const int nkt = (n + BN - 1) / BN;
  const int nk = causal ? min(nkt, (q0 + BM - 1) / BN + 1) : nkt;

  copy_tile<DP, BM>(sQ, q + base, st, q0, n, D);
  copy_tile<DP, BN>(sK, k + base, st, 0, n, D);
  copy_tile<DP, BN>(sV, v + base, st, 0, n, D);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  scale_tile<DP, BM>(sQ, scale);
  __syncthreads();
  uint32_t qf[kQRegs ? MT : 1][kQRegs ? KD : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        load_a<DP>(qf[mt][kd], sQ, w0 + 16 * mt, kd * 16);
      }
    }
  }

  float m[MT][2], l[MT][2];            // l: this lane's share of a row sum
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    }
  }

  for (int kj = 0; kj < nk; ++kj) {
    const int cur = kj & 1;
    if (kj + 1 < nk) {                 // next tile in flight during this one
      const int nxt = (cur ^ 1) * TILE;
      copy_tile<DP, BN>(sK + nxt, k + base, st, (kj + 1) * BN, n, D);
      copy_tile<DP, BN>(sV + nxt, v + base, st, (kj + 1) * BN, n, D);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + cur * TILE;
    const bf16* tV = sV + cur * TILE;
    const int k0 = kj * BN;
    // under the causal mask a warp whose rows all precede the tile skips it
    if (!(causal && k0 > wr0 + 16 * MT - 1)) {
      float s[MT][NJ][4];
      mm_abt<DP, BN, MT>(
          s,
          [&](uint32_t (&a)[4], int mt, int kd) {
            if constexpr (kQRegs) {
#pragma unroll
              for (int i = 0; i < 4; ++i) a[i] = qf[mt][kd][i];
            } else {
              load_a<DP>(a, sQ, w0 + 16 * mt, kd * 16);
            }
          },
          tK, 0);
      if ((causal && k0 + BN - 1 > wr0) || k0 + BN > n) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = k0 + 8 * j + 2 * tq + (e & 1);
              const int r = wr0 + 16 * mt + g + 8 * (e >> 1);
              if (c >= n || (causal && c > r)) s[mt][j][e] = kNegInf;
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * half], s[mt][j][2 * half + 1]));
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][half], mx);
          const float alpha = exp2f((m[mt][half] - m_new) * kLog2e);
          const float mL = m_new * kLog2e;
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e) {
              const float p = exp2f(fmaf(s[mt][j][e], kLog2e, -mL));
              s[mt][j][e] = p;
              ps += p;
            }
          }
          l[mt][half] = alpha * l[mt][half] + ps;
          m[mt][half] = m_new;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc[mt][j][2 * half] *= alpha;
            acc[mt][j][2 * half + 1] *= alpha;
          }
        }
      }
      // acc += P . V, P rounded to bf16 and packed from the registers of s
      mm_pv<DP, BN, MT>(acc, s, tV, 0);
    }
    __syncthreads();                   // stage `cur` is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lt = l[mt][half];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[mt][j][2 * half] /= lc;
        acc[mt][j][2 * half + 1] /= lc;
      }
      const int r = wr0 + 16 * mt + g + 8 * half;
      if (tq == 0 && r < n) {
        lse[static_cast<long long>(bh) * n + r] = m[mt][half] + logf(lc);
      }
    }
    store_strip<DP>(o, acc[mt], b, h, H, n, D, wr0 + 16 * mt, 1.f);
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int n, int H, int D, long long sb,
               long long st, long long sh, int causal, float scale,
               cudaStream_t stream) {
  constexpr int BM = fwd_q_rows<DP>();
  const size_t smem = (BM + 4 * flash_mma::kRows) *
                      flash_mma::Tile<DP>::LD * sizeof(__nv_bfloat16);
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((n + BM - 1) / BM, B * H);
  flash_fwd_mma_kernel<DP><<<grid, flash_mma::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, n, D, sb, st, sh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q, k, v [B, n, H, D] share the element
// strides (sb, st, sh) and have a unit last stride; o [B, n, H, D]
// contiguous in the input type; lse [B*H, n] fp32. bf16 = 1 for bfloat16
// inputs (the tensor-core route: D % 8 == 0, strides multiples of 8
// elements, 16-byte aligned pointers), 0 for fp32 (the SIMT route).
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int n, int H, int D, long long sb,
                                   long long st, long long sh, int causal,
                                   float scale, int bf16, void* stream) {
  if (B <= 0 || n <= 0 || H <= 0 || D <= 0 || D > 128 ||
      static_cast<long long>(B) * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {q, k, v, o})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_mma<64>(q, k, v, o, lse, B, n, H, D, sb, st, sh,
                                    causal, scale, s)
                   : launch_mma<128>(q, k, v, o, lse, B, n, H, D, sb, st,
                                     sh, causal, scale, s);
  }
  return D <= 64 ? launch<64>(q, k, v, o, lse, B, n, H, D, sb, st, sh, causal,
                              scale, s)
                 : launch<128>(q, k, v, o, lse, B, n, H, D, sb, st, sh,
                               causal, scale, s);
}

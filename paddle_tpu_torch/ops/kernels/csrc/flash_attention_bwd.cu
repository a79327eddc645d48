// Flash attention backward for Hopper (sm_90a): dq, dk, dv of
// flash_attention_fwd.cu's O from (q, k, v, O, lse, dO), recomputing the
// probabilities from the saved logsumexp; causal or full, fp32 or bf16.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (the two-pass `_bwd`, T > 1024 on the TPU) and the fused
// `_bwd_dkv_kernel(emit_dq=True)` (`_bwd_fused`, the nk == 1 route the TPU
// takes at T <= 1024). Same arithmetic: q is scaled in fp32 and rounded to
// the operand type, s = q.k accumulates in fp32, masked scores are -1e30,
// p = exp(s - lse), dp = dO . v^T, ds = p * (dp - delta) with
// delta = rowsum(dO * O) in fp32, p and ds are rounded to the operand type
// before their products, dk = ds^T . q (q carries the scale), dv = p^T . dO,
// dq = (ds . k) * scale; gradients come out in the input type.
//
// Why two kernels (design (a), deterministic). The TPU's fused backward is
// right only when one k block spans the whole sequence, so each dq block is
// written once; its 16 MB VMEM allows that up to T = 1024. A Hopper CTA has
// at most 227 KB of shared memory, so k tiles are 64 rows at every T and dq
// always sums over several k tiles. Rather than add those partial sums with
// atomics (run-to-run different rounding), dq gets its own kernel:
//   dq kernel   one CTA per (b*h, 64-row q tile), sweeping the k tiles up
//               to the diagonal; also writes delta [B*H, T] for the next;
//   dk/dv kernel one CTA per (b*h, 64-row k tile), sweeping the q tiles from
//               the diagonal on.
// Both recompute s and dp: 7 tile products per (q, k) tile pair where the
// fused form needs 5. Launch order on the stream: dq, then dk/dv.
//
// Two routes, chosen by the operand type; the choice is the arithmetic
// contract, not a fallback. fp32 (`flash_bwd_dq_kernel`,
// `flash_bwd_dkv_kernel`) runs fp32 FMAs on the CUDA cores
// (flash_attention_common.cuh), the JAX package's 5e-4 contract, which
// TF32 tensor cores would break. bf16 (`flash_bwd_dq_mma_kernel`,
// `flash_bwd_dkv_mma_kernel`) runs every product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators;
// flash_attention_mma.cuh): 4 warps, each owning 16 rows.
//   dq:    q (scaled and rounded in shared memory) and dO are copied once;
//          K and V tiles stream through a 2-stage cp.async ring. Per k
//          tile: S = q_s.kᵀ and dP = dO.vᵀ in registers, P = exp2(s log2(e)
//          - lse log2(e)), dS = P (dP - delta) rounded to bf16 and packed
//          as A fragments of dq += dS.K (K through ldmatrix.trans).
//   dk/dv: K and V stay in shared memory; q tiles (BQ = 64 rows at D <= 64,
//          32 at D = 128, which keeps the fp32 dK and dV accumulators, 128
//          registers a thread at D = 128, clear of spills) and their dO, lse
//          and delta stream through the ring. The warps own key rows, so
//          Sᵀ = K.q_sᵀ and dPᵀ = V.dOᵀ come out with Pᵀ and dSᵀ already in
//          the A layout of dV += Pᵀ.dO and dK += dSᵀ.q_s; lse and delta are
//          indexed by column.
//
// What bounds it on the H100: at B = 16, H = 12, T = 1024, D = 64 causal
// bf16 the least work is the 5 products, 10 * D flops per live (q, k) pair,
// 64.5 GFLOP, or 0.065 ms at 989 TFLOP/s; the bytes (q, k, v, O, dO, lse
// in; dq, dk, dv out) are 202 MB, or 0.060 ms at 3.35 TB/s. The split's 7
// products do 14 * D flops per live pair.

#include "flash_attention_mma.cuh"

namespace {

using namespace flash;

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, int H, int n,
                    int D, long long sb, long long st, long long sh,
                    int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* sK = sdO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sdS = sV + kTile * LD;
  float* sLse = sdS + kTile * kLP;
  float* sDelta = sLse + kTile;

  const int nq = (n + kTile - 1) / kTile;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  // O and dO are contiguous [B, n, H, D]
  const long long cbase = (static_cast<long long>(b) * n * H + h) * D;
  const long long cst = static_cast<long long>(H) * D;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = qi * kTile;

  load_tile<DP>(sQ, q + base, st, q0, n, D, scale);
  load_tile<DP>(sdO, dout + cbase, cst, q0, n, D, 1.f);
  // delta = rowsum(dO * O) in fp32, one warp per row
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int t = q0 + r;
    float acc = 0.f;
    if (t < n) {
      for (int d = lane; d < D; d += 32) {
        acc += dout[cbase + t * cst + d] * o[cbase + t * cst + d];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0) {
      sDelta[r] = acc;
      sLse[r] = t < n ? lse[static_cast<long long>(bh) * n + t] : 0.f;
      if (t < n) delta[static_cast<long long>(bh) * n + t] = acc;
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? qi + 1 : (n + kTile - 1) / kTile;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();
    load_tile<DP>(sK, k + base, st, k0, n, D, 1.f);
    load_tile<DP>(sV, v + base, st, k0, n, D, 1.f);
    __syncthreads();
    float s[4][4];
    float dp[4][4];
    mm_nt<DP>(sQ, sK, s, ty, tx);
    mm_nt<DP>(sdO, sV, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
      const int r = q0 + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool live = r < n && c < n && !(causal && c > r);
        const float p = live ? expf(s[i][j] - sLse[rr]) : 0.f;
        sdS[rr * kLP + tx + 16 * j] = p * (dp[i][j] - sDelta[rr]);
      }
    }
    __syncthreads();
    mm_nn_acc<DP>(sdS, sK, acc, ty, tx);
  }
  store_rows<DP>(dq, acc, b, h, H, n, D, q0, scale, ty, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int n, int D, long long sb,
                     long long st, long long sh, int causal, float scale) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sdO = sQ + kTile * LD;
  float* sP = sdO + kTile * LD;
  float* sdS = sP + kTile * kLP;
  float* sLse = sdS + kTile * kLP;
  float* sDelta = sLse + kTile;

  const int nq = (n + kTile - 1) / kTile;
  const int ki = blockIdx.x;     // causal: low k tiles have the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  const long long cbase = (static_cast<long long>(b) * n * H + h) * D;
  const long long cst = static_cast<long long>(H) * D;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int k0 = ki * kTile;

  load_tile<DP>(sK, k + base, st, k0, n, D, 1.f);
  load_tile<DP>(sV, v + base, st, k0, n, D, 1.f);

  float dk_acc[4][NC];
  float dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }
  }

  for (int qj = causal ? ki : 0; qj < nq; ++qj) {
    const int q0 = qj * kTile;
    __syncthreads();
    load_tile<DP>(sQ, q + base, st, q0, n, D, scale);
    load_tile<DP>(sdO, dout + cbase, cst, q0, n, D, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int t = q0 + r;
      const long long at = static_cast<long long>(bh) * n + t;
      sLse[r] = t < n ? lse[at] : 0.f;
      sDelta[r] = t < n ? delta[at] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are this CTA's k rows, columns the q rows
    float s[4][4];
    float dp[4][4];
    mm_nt<DP>(sK, sQ, s, ty, tx);
    mm_nt<DP>(sV, sdO, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int t = q0 + qc;
        const bool live = t < n && kr < n && !(causal && kr > t);
        const float p = live ? expf(s[i][j] - sLse[qc]) : 0.f;
        const int at = (ty + 16 * i) * kLP + qc;
        sP[at] = p;
        sdS[at] = p * (dp[i][j] - sDelta[qc]);
      }
    }
    __syncthreads();
    mm_nn_acc<DP>(sP, sdO, dv_acc, ty, tx);
    mm_nn_acc<DP>(sdS, sQ, dk_acc, ty, tx);
  }
  store_rows<DP>(dk, dk_acc, b, h, H, n, D, k0, 1.f, ty, tx);
  store_rows<DP>(dv, dv_acc, b, h, H, n, D, k0, 1.f, ty, tx);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (DP + 4) + kTile * kLP + 2 * kTile);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (DP + 4) + 2 * kTile * kLP + 2 * kTile);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const void* lse;
  void* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, n, H, D;
  long long sb, st, sh;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int DP>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.H, a.n, a.D,
      a.sb, a.st, a.sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.n, a.D, a.sb,
      a.st, a.sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16 route

using flash_mma::bf16;
using flash_mma::kLog2e;
using flash_mma::kMmaThreads;
using flash_mma::kRows;
using flash_mma::Tile;

// P of the [16, NB] strip held as the C fragments s (in place): exp(s -
// lse) where (row, col) is live, else 0. `row_of(e)` and `col_of(j, e)`
// give the global (query or key) indices of element e of n-tile j;
// lseL(j, e) is the matching lse times log2(e).
template <int NB, typename Live, typename LseL>
__device__ __forceinline__ void probs(float (&s)[NB / 8][4], bool masked,
                                      Live live, LseL lse_l) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], kLog2e, -lse_l(j, e)));
      s[j][e] = (!masked || live(j, e)) ? p : 0.f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta, int H, int n, int D,
                        long long sb, long long st, long long sh, int causal,
                        float scale) {
  using namespace flash_mma;
  constexpr int LD = Tile<DP>::LD;
  constexpr int ND = Tile<DP>::ND;
  constexpr int NJ = kRows / 8;
  constexpr int TILE = kRows * LD;
  constexpr int CPR = DP / 8;          // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + TILE;
  bf16* sK = sdO + TILE;               // two stages
  bf16* sV = sK + 2 * TILE;            // two stages
  float* sDelta = reinterpret_cast<float*>(sV + 2 * TILE);

  const int nq = (n + kRows - 1) / kRows;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  // O and dO are contiguous [B, n, H, D]
  const long long cbase = (static_cast<long long>(b) * n * H + h) * D;
  const long long cst = static_cast<long long>(H) * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = qi * kRows;
  const int r_lo = q0 + warp * 16 + g;
  const int nk = causal ? qi + 1 : nq;

  copy_tile<DP, kRows>(sQ, q + base, st, q0, n, D);
  copy_tile<DP, kRows>(sdO, dout + cbase, cst, q0, n, D);
  copy_tile<DP, kRows>(sK, k + base, st, 0, n, D);
  copy_tile<DP, kRows>(sV, v + base, st, 0, n, D);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  scale_tile<DP, kRows>(sQ, scale);
  // delta = rowsum(dO * O) in fp32: CPR consecutive threads share a row
#pragma unroll
  for (int e = threadIdx.x; e < kRows * CPR; e += kMmaThreads) {
    const int r = e / CPR;
    const int c = (e % CPR) * 8;
    const int t = q0 + r;
    float part = 0.f;
    if (t < n && c < D) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + cbase + t * cst + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(sdO + r * LD + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 d = __bfloat1622float2(d2[i]);
        part = fmaf(a.x, d.x, part);
        part = fmaf(a.y, d.y, part);
      }
    }
#pragma unroll
    for (int off = CPR / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (e % CPR == 0) {
      sDelta[r] = part;
      if (t < n) delta[static_cast<long long>(bh) * n + t] = part;
    }
  }
  __syncthreads();
  float lse_l[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    lse_l[half] = r < n ? lse[static_cast<long long>(bh) * n + r] * kLog2e : 0.f;
    dlt[half] = sDelta[warp * 16 + g + 8 * half];
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int kj = 0; kj < nk; ++kj) {
    const int cur = kj & 1;
    if (kj + 1 < nk) {
      const int nxt = (cur ^ 1) * TILE;
      copy_tile<DP, kRows>(sK + nxt, k + base, st, (kj + 1) * kRows, n, D);
      copy_tile<DP, kRows>(sV + nxt, v + base, st, (kj + 1) * kRows, n, D);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + cur * TILE;
    const bf16* tV = sV + cur * TILE;
    const int k0 = kj * kRows;

    float s[NJ][4];
    mm_abt<DP, kRows>(s, sQ, warp * 16, tK, 0);
    probs<kRows>(
        s, (causal && kj == qi) || k0 + kRows > n,
        [&](int j, int e) {
          const int c = k0 + 8 * j + 2 * tq + (e & 1);
          return c < n && !(causal && c > r_lo + 8 * (e >> 1));
        },
        [&](int, int e) { return lse_l[e >> 1]; });
    float dp[NJ][4];
    mm_abt<DP, kRows>(dp, sdO, warp * 16, tV, 0);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dlt[e >> 1];
    }
    mm_pv<DP, kRows>(acc, s, tK, 0);           // dq += dS . K
    __syncthreads();                   // stage `cur` is refilled next
  }
  store_strip<DP>(dq, acc, b, h, H, n, D, q0 + warp * 16, scale);
}

template <int DP>
__host__ __device__ constexpr int dkv_q_rows() { return DP > 64 ? 32 : 64; }

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int n, int D, long long sb, long long st,
                         long long sh, int causal, float scale) {
  using namespace flash_mma;
  constexpr int LD = Tile<DP>::LD;
  constexpr int ND = Tile<DP>::ND;
  constexpr int BQ = dkv_q_rows<DP>();
  constexpr int NJ = BQ / 8;
  constexpr int QT = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;          // two stages
  bf16* sdO = sQ + 2 * QT;             // two stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * QT);   // two stages
  float* sDelta = sLse + 2 * BQ;                          // two stages

  const int ki = blockIdx.x;     // causal: low k tiles have the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long base = b * sb + h * sh;
  const long long cbase = (static_cast<long long>(b) * n * H + h) * D;
  const long long cst = static_cast<long long>(H) * D;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int k0 = ki * kRows;
  const int kr_lo = k0 + warp * 16 + g;     // this thread's key rows
  const int nqt = (n + BQ - 1) / BQ;
  const int qj0 = causal ? k0 / BQ : 0;

  copy_tile<DP, kRows>(sK, k + base, st, k0, n, D);
  copy_tile<DP, kRows>(sV, v + base, st, k0, n, D);
  copy_tile<DP, BQ>(sQ, q + base, st, qj0 * BQ, n, D);
  copy_tile<DP, BQ>(sdO, dout + cbase, cst, qj0 * BQ, n, D);
  copy_rows<BQ>(sLse, lse_bh, qj0 * BQ, n);
  copy_rows<BQ>(sDelta, delta_bh, qj0 * BQ, n);
  cp_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }

  for (int qj = qj0; qj < nqt; ++qj) {
    const int cur = (qj - qj0) & 1;
    if (qj + 1 < nqt) {
      const int nxt = cur ^ 1;
      const int q1 = (qj + 1) * BQ;
      copy_tile<DP, BQ>(sQ + nxt * QT, q + base, st, q1, n, D);
      copy_tile<DP, BQ>(sdO + nxt * QT, dout + cbase, cst, q1, n, D);
      copy_rows<BQ>(sLse + nxt * BQ, lse_bh, q1, n);
      copy_rows<BQ>(sDelta + nxt * BQ, delta_bh, q1, n);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    bf16* tQ = sQ + cur * QT;
    const bf16* tdO = sdO + cur * QT;
    const float* tLse = sLse + cur * BQ;
    const float* tDelta = sDelta + cur * BQ;
    scale_tile<DP, BQ>(tQ, scale);
    __syncthreads();
    const int q0 = qj * BQ;

    // transposed strips: rows are this warp's key rows, columns q rows
    float s[NJ][4];
    mm_abt<DP, BQ>(s, sK, warp * 16, tQ, 0);
    probs<BQ>(
        s, (causal && q0 < k0 + kRows) || q0 + BQ > n,
        [&](int j, int e) {
          const int t = q0 + 8 * j + 2 * tq + (e & 1);
          return t < n && !(causal && kr_lo + 8 * (e >> 1) > t);
        },
        [&](int j, int e) { return tLse[8 * j + 2 * tq + (e & 1)] * kLog2e; });
    mm_pv<DP, BQ>(dv_acc, s, tdO, 0);          // dV += Pᵀ . dO
    float dp[NJ][4];
    mm_abt<DP, BQ>(dp, sV, warp * 16, tdO, 0);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - tDelta[8 * j + 2 * tq + (e & 1)]);
      }
    }
    mm_pv<DP, BQ>(dk_acc, dp, tQ, 0);          // dK += dSᵀ . q_s
    __syncthreads();                           // stage `cur` is refilled next
  }
  store_strip<DP>(dk, dk_acc, b, h, H, n, D, k0 + warp * 16, 1.f);
  store_strip<DP>(dv, dv_acc, b, h, H, n, D, k0 + warp * 16, 1.f);
}

template <int DP>
constexpr size_t dq_mma_smem_bytes() {
  return 6 * kRows * Tile<DP>::LD * sizeof(bf16) + kRows * sizeof(float);
}

template <int DP>
constexpr size_t dkv_mma_smem_bytes() {
  return (2 * kRows + 4 * dkv_q_rows<DP>()) * Tile<DP>::LD * sizeof(bf16) +
         4 * dkv_q_rows<DP>() * sizeof(float);
}

template <int DP>
int launch_dq_mma(const Args& a) {
  const size_t smem = dq_mma_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kRows - 1) / kRows, a.B * a.H);
  flash_bwd_dq_mma_kernel<DP><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<bf16*>(a.dq), static_cast<float*>(a.delta), a.H, a.n, a.D,
      a.sb, a.st, a.sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_mma(const Args& a) {
  const size_t smem = dkv_mma_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_mma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kRows - 1) / kRows, a.B * a.H);
  flash_bwd_dkv_mma_kernel<DP><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.n, a.D,
      a.sb, a.st, a.sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int n, int H, int D) {
  return B <= 0 || n <= 0 || H <= 0 || D <= 0 || D > 128 ||
         static_cast<long long>(B) * H > 65535;
}

}  // namespace

// C entry points, bound with ctypes. q, k, v [B, n, H, D] share the element
// strides (sb, st, sh) with a unit last stride; o, dout and the gradients
// are contiguous [B, n, H, D] in the input type; lse and delta are
// [B*H, n] fp32. bf16 = 1 for bfloat16 inputs (the tensor-core route: D %
// 8 == 0, strides multiples of 8 elements, 16-byte aligned pointers), 0 for
// fp32 (the SIMT route). Each launches one
// kernel on `stream` without synchronising and returns cudaGetLastError()
// (0 = cudaSuccess). Call flash_attention_bwd_dq first: it writes the delta
// that flash_attention_bwd_dkv reads.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int n,
                                      int H, int D, long long sb, long long st,
                                      long long sh, int causal, float scale,
                                      int bf16, void* stream) {
  if (bad_shape(B, n, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, B, n, H, D,
         sb, st, sh, causal, scale, static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {q, k, v, o, dout, dq})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_dq_mma<64>(a) : launch_dq_mma<128>(a);
  }
  return D <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int n, int H,
                                       int D, long long sb, long long st,
                                       long long sh, int causal, float scale,
                                       int bf16, void* stream) {
  if (bad_shape(B, n, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk,
         dv, B, n, H, D, sb, st, sh, causal, scale,
         static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {q, k, v, dout, dk, dv})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_dkv_mma<64>(a) : launch_dkv_mma<128>(a);
  }
  return D <= 64 ? launch_dkv<64>(a) : launch_dkv<128>(a);
}

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
// at most 227 KB of shared memory, so k tiles are 64 or 128 rows at every T
// and dq always sums over several k tiles. Rather than add those partial
// sums with atomics (run-to-run different rounding), dq gets its own
// kernel:
//   dq kernel   one CTA per (b*h, q tile), sweeping the k tiles up to the
//               diagonal; also writes delta [B*H, T] for the next (and, in
//               bf16, the scaled q);
//   dk/dv kernel one CTA per (b*h, k tile), sweeping the q tiles from the
//               diagonal on.
// Both recompute s and dp: 7 tile products per (q, k) tile pair where the
// fused form needs 5. Launch order on the stream: dq, then dk/dv.
//
// Two routes, chosen by the operand type; the choice is the arithmetic
// contract, not a fallback. fp32 (`flash_bwd_dq_kernel`,
// `flash_bwd_dkv_kernel`) runs fp32 FMAs on the CUDA cores
// (flash_attention_common.cuh), 64-row tiles, the JAX package's 5e-4
// contract, which TF32 tensor cores would break. bf16
// (`flash_bwd_dq_wgmma_kernel`, `flash_bwd_dkv_wgmma_kernel`) runs every
// product on the tensor cores by wgmma (bf16 operands, fp32 accumulators),
// warp-specialized like the forward (tma.cuh, flash_attention_wgmma.cuh):
// a producer warpgroup whose first thread loads by TMA through rings with
// full and empty mbarriers, and consumer warpgroups of 64 resident rows
// each (two in one CTA an SM at D = 128 with 240 registers a thread, one
// in each of two CTAs an SM at D <= 64 with 232), one CTA per (b*h, tile).
// Each tile is taken whole before the next (overlapping two measured no
// faster, and at D = 128 the accumulators leave no room for it).
//   dq:    the q and dO rows are loaded once; each consumer scales its q
//          rows in fp32, rounds them to bf16 in place and writes them out
//          as q_s [B, T, H, D], and computes delta for its rows. K and V
//          tiles of 128 keys stream through rings of 3 and 2 stages (V
//          leaves first). Per k tile: S = q_s.kᵀ and dP = dO.vᵀ by wgmma
//          m64n128k16 from shared memory, P = exp2(s log2(e) - lse
//          log2(e)), dS = P (dP - delta) rounded to bf16 in registers, the
//          A operand of dq += dS.K (K read MN-major).
//   dk/dv: the K and V rows stay in shared memory; q_s and dO stream by
//          TMA, 64 q rows a stage (3 stages at D = 128, 4 at D <= 64), so q
//          is not scaled again at every visit, and the producer's second
//          warp copies the stage's lse and delta (a TMA box starting at an
//          odd T is not 16-byte aligned). The consumers own key rows, so
//          Sᵀ = K.q_sᵀ and dPᵀ = V.dOᵀ (m64n64k16) come out with Pᵀ and dSᵀ
//          already in the A layout of dV += Pᵀ.dO and dK += dSᵀ.q_s
//          (m64n{D}k16, dO and q_s read MN-major); lse and delta are
//          indexed by column. At D = 128 the fp32 dK and dV accumulators
//          alone take 128 registers a thread.
// Tiles are masked only where they cross the diagonal or the ragged end;
// rows past T come in as zeros.
//
// What bounds it on the H100: at B = 16, H = 12, T = 1024, D = 64 causal
// bf16 the least work is the 5 products, 10 * D flops per live (q, k) pair,
// 64.5 GFLOP, or 0.065 ms at 989 TFLOP/s; the bytes (q, k, v, O, dO, lse
// in; dq, dk, dv out) are 202 MB, or 0.060 ms at 3.35 TB/s. The split's 7
// products do 14 * D flops per live pair.

#include "flash_attention_wgmma.cuh"

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
  void* qs;
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

namespace fw = flash_wgmma;
using fw::bf16;
using fw::kLog2e;

template <int DP>
struct DqShape : fw::Cta<DP> {
  using C = fw::Cta<DP>;
  // K stays in its stage longer than V (until dq += dS . K is done), so
  // its ring is deeper
  static constexpr int kStagesK = 3;
  static constexpr int kStagesV = 2;
  static constexpr int kRes = DP / 64 * C::kResBlock;     // [kRows, DP]
  static constexpr int kTile = DP / 64 * fw::kBlock128;   // [128, DP]
  static constexpr int kBars = 1 + 2 * (kStagesK + kStagesV);
  static constexpr int kSmem = 1024 + 2 * kRes +
                               (kStagesK + kStagesV) * kTile +
                               4 * C::kRows + 8 * kBars;
  static_assert(C::kPerSm * (kSmem + 1024) <= 233472,
                "shared memory over the SM's");
};

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::kThreads,
                                  DqShape<DP>::kPerSm)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const bf16* __restrict__ o,
                          const float* __restrict__ lse,
                          bf16* __restrict__ dq, float* __restrict__ delta,
                          bf16* __restrict__ qs, int H, int n, int D,
                          int causal, float scale) {
  using S = DqShape<DP>;
  constexpr int NK = S::kStagesK;
  constexpr int NV = S::kStagesV;
  constexpr int NB = DP / 64;
  constexpr int CPR = DP / 8;          // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = tma::align1024(smem_raw);
  unsigned char* sdO = sQ + S::kRes;
  unsigned char* sK = sdO + S::kRes;   // NK stages
  unsigned char* sV = sK + NK * S::kTile;                  // NV stages
  float* sDelta = reinterpret_cast<float*>(sV + NV * S::kTile);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(sDelta + S::kRows);
  uint64_t* k_full = res_full + 1;
  uint64_t* k_empty = k_full + NK;
  uint64_t* v_full = k_empty + NK;
  uint64_t* v_empty = v_full + NV;

  const int nq = (n + S::kRows - 1) / S::kRows;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qi * S::kRows;
  const int nkt = (n + fw::kKeys - 1) / fw::kKeys;
  // the k tiles up to the q tile's last row when causal
  const int nk = causal ? min(nkt, (q0 + S::kRows + fw::kKeys - 1) /
                                       fw::kKeys)
                        : nkt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tma::mbar_init(res_full, 1);
    for (int s = 0; s < NK; ++s) {
      tma::mbar_init(k_full + s, 1);
      tma::mbar_init(k_empty + s, S::kConsumerWarps);
    }
    for (int s = 0; s < NV; ++s) {
      tma::mbar_init(v_full + s, 1);
      tma::mbar_init(v_empty + s, S::kConsumerWarps);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer
    tma::regs_dec<fw::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma::mbar_expect_tx(res_full, 2 * S::kRes);
      for (int c = 0; c < NB; ++c) {
        tma::load_4d(sQ + c * S::kResBlock, &tq, res_full, 64 * c, h, q0, b);
        tma::load_4d(sdO + c * S::kResBlock, &tdo, res_full, 64 * c, h, q0,
                     b);
      }
      for (int j = 0; j < nk; ++j) {
        const int sk = j % NK;
        const int sv = j % NV;
        tma::mbar_wait(k_empty + sk, ((j / NK) & 1) ^ 1);
        tma::mbar_expect_tx(k_full + sk, S::kTile);
        for (int c = 0; c < NB; ++c) {
          tma::load_4d(sK + sk * S::kTile + c * fw::kBlock128, &tk,
                       k_full + sk, 64 * c, h, j * fw::kKeys, b);
        }
        tma::mbar_wait(v_empty + sv, ((j / NV) & 1) ^ 1);
        tma::mbar_expect_tx(v_full + sv, S::kTile);
        for (int c = 0; c < NB; ++c) {
          tma::load_4d(sV + sv * S::kTile + c * fw::kBlock128, &tv,
                       v_full + sv, 64 * c, h, j * fw::kKeys, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup cw: q rows [q0 + 64 cw, q0 + 64 cw + 64)
  tma::regs_inc<S::kConsumerRegs>();
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq4 = lane & 3;
  const int wr0 = q0 + 64 * cw;
  const int r_lo = wr0 + 16 * warp + g;        // rows r_lo, r_lo + 8
  // O, dO, dq and q_s are contiguous [B, n, H, D]
  const long long cbase = (static_cast<long long>(b) * n * H + h) * D;
  const long long cst = static_cast<long long>(H) * D;

  tma::mbar_wait(res_full, 0);
  fw::scale_rows<DP>(sQ, S::kResBlock, 64 * cw, t, scale,
                     qs + cbase + wr0 * cst, cst, n - wr0, D);
  // delta = rowsum(dO * O) in fp32: CPR consecutive threads share a row
#pragma unroll
  for (int e = t; e < 64 * CPR; e += 128) {
    const int r = e / CPR;
    const int c = e % CPR;
    const int tt = wr0 + r;
    float part = 0.f;
    if (tt < n && 8 * c < D) {
      const uint4 ov =
          *reinterpret_cast<const uint4*>(o + cbase + tt * cst + 8 * c);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          sdO + (c / 8) * S::kResBlock + gmma::sw128(64 * cw + r, c % 8));
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
    if (c == 0) {
      sDelta[64 * cw + r] = part;
      if (tt < n) delta[static_cast<long long>(bh) * n + tt] = part;
    }
  }
  gmma::fence_proxy_async();
  tma::named_sync(1 + cw, 128);
  float lse_l[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    lse_l[hh] = r < n ? lse[static_cast<long long>(bh) * n + r] * kLog2e
                      : 0.f;
    dlt[hh] = sDelta[r - q0];
  }

  unsigned char* sQw = sQ + 64 * cw * 128;     // this warpgroup's rows
  unsigned char* sdOw = sdO + 64 * cw * 128;
  float acc[DP / 2], sc[64], dp[64];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = dp[i] = 0.f;
  uint32_t ds[8][4];                   // dS in bf16: 8 k steps of 16 keys

  // one k tile at a time (overlapping two measured no faster)
  for (int j = 0; j < nk; ++j) {
    const unsigned char* tK = sK + j % NK * S::kTile;
    tma::mbar_wait(k_full + j % NK, (j / NK) & 1);
    tma::mbar_wait(v_full + j % NV, (j / NV) & 1);
    gmma::wgmma_fence();
    fw::mma_ss<DP, 128>(sc, sQw, S::kResBlock, tK, fw::kBlock128);
    fw::mma_ss<DP, 128>(dp, sdOw, S::kResBlock, sV + j % NV * S::kTile,
                        fw::kBlock128);
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    gmma::hold(sc);
    gmma::hold(dp);
    fw::release(v_empty + j % NV, lane);

    // dS = P (dP - delta), P = exp(s - lse) where (row, key) is live
    const int k0 = j * fw::kKeys;
    const bool masked = (causal && k0 + fw::kKeys - 1 > wr0) ||
                        k0 + fw::kKeys > n;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * jj + 2 * tq4 + (e & 1);
        const int r = r_lo + 8 * (e >> 1);
        float p =
            fw::exp2_fast(fmaf(sc[4 * jj + e], kLog2e, -lse_l[e >> 1]));
        if (masked && (c >= n || (causal && c > r))) p = 0.f;
        sc[4 * jj + e] = p * (dp[4 * jj + e] - dlt[e >> 1]);
      }
    }
    fw::pack_a<8>(ds, sc);
    gmma::wgmma_fence();
    fw::mma_rs<DP, 8>(acc, ds, tK, fw::kBlock128);   // dq += dS . K
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    gmma::hold(acc);
    fw::release(k_empty + j % NK, lane);
  }
  fw::store_rows<DP>(dq, acc, b, h, H, n, D, r_lo, tq4, scale);
}

template <int DP>
struct DkvShape : fw::Cta<DP> {
  using C = fw::Cta<DP>;
  static constexpr int kStages = DP > 64 ? 3 : 4;
  static constexpr int kRes = DP / 64 * C::kResBlock;     // [kRows, DP]
  static constexpr int kQ = DP / 64 * fw::kBlock64;       // [64, DP]
  static constexpr int kQRows = 64;                       // q rows a stage
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 + 2 * kRes + 2 * kStages * kQ +
                               2 * kStages * kQRows * 4 + 8 * kBars;
  static_assert(C::kPerSm * (kSmem + 1024) <= 233472,
                "shared memory over the SM's");
};

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::kThreads,
                                  DkvShape<DP>::kPerSm)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tqs,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int n, int D, int causal) {
  using S = DkvShape<DP>;
  constexpr int NS = S::kStages;
  constexpr int NB = DP / 64;
  constexpr int BQ = S::kQRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = tma::align1024(smem_raw);
  unsigned char* sV = sK + S::kRes;
  unsigned char* sQ = sV + S::kRes;    // q_s, NS stages
  unsigned char* sdO = sQ + NS * S::kQ;
  float* sLse = reinterpret_cast<float*>(sdO + NS * S::kQ);
  float* sDelta = sLse + NS * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + NS * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int ki = blockIdx.x;     // causal: low k tiles have the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = ki * S::kRows;
  const int nqt = (n + BQ - 1) / BQ;
  const int qj0 = causal ? k0 / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tma::mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      tma::mbar_init(full + s, 1 + 32);   // the TMA thread and warp 1
      tma::mbar_init(empty + s, S::kConsumerWarps);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer
    tma::regs_dec<fw::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma::mbar_expect_tx(kv_full, 2 * S::kRes);
      for (int c = 0; c < NB; ++c) {
        tma::load_4d(sK + c * S::kResBlock, &tk, kv_full, 64 * c, h, k0, b);
        tma::load_4d(sV + c * S::kResBlock, &tv, kv_full, 64 * c, h, k0, b);
      }
      for (int i = 0; qj0 + i < nqt; ++i) {
        const int s = i % NS;
        const int t0 = (qj0 + i) * BQ;
        tma::mbar_wait(empty + s, ((i / NS) & 1) ^ 1);
        tma::mbar_expect_tx(full + s, 2 * S::kQ);
        for (int c = 0; c < NB; ++c) {
          tma::load_4d(sQ + s * S::kQ + c * fw::kBlock64, &tqs, full + s,
                       64 * c, h, t0, b);
          tma::load_4d(sdO + s * S::kQ + c * fw::kBlock64, &tdo, full + s,
                       64 * c, h, t0, b);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // warp 1 copies each tile's lse and delta (a box of a [B*H, T] row
      // starting at an odd T is not 16-byte aligned, which TMA refuses)
      const int l = threadIdx.x - 32;
      const float* lse_bh = lse + static_cast<long long>(bh) * n;
      const float* delta_bh = delta + static_cast<long long>(bh) * n;
      for (int i = 0; qj0 + i < nqt; ++i) {
        const int s = i % NS;
        const int t0 = (qj0 + i) * BQ;
        tma::mbar_wait(empty + s, ((i / NS) & 1) ^ 1);
        for (int c = l; c < BQ; c += 32) {
          const bool in = t0 + c < n;
          sLse[s * BQ + c] = in ? lse_bh[t0 + c] : 0.f;
          sDelta[s * BQ + c] = in ? delta_bh[t0 + c] : 0.f;
        }
        tma::mbar_arrive(full + s);
      }
    }
    return;
  }

  // consumer warpgroup cw: key rows [k0 + 64 cw, k0 + 64 cw + 64)
  tma::regs_inc<S::kConsumerRegs>();
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq4 = lane & 3;
  const int wk0 = k0 + 64 * cw;
  const int kr_lo = wk0 + 16 * (t >> 5) + g;   // key rows kr_lo, kr_lo + 8
  const unsigned char* sKw = sK + 64 * cw * 128;
  const unsigned char* sVw = sV + 64 * cw * 128;

  float dk_acc[DP / 2], dv_acc[DP / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa[4][4], da[4][4];         // Pᵀ and dSᵀ in bf16: 4 k steps
  tma::mbar_wait(kv_full, 0);

  // one q tile at a time: at D = 128 the dK and dV accumulators take 128
  // registers a thread, too many to hold a second tile's Sᵀ and dPᵀ beside
  // them, and at D = 64 overlapping two tiles measured no faster
  for (int i = 0; qj0 + i < nqt; ++i) {
    const int s = i % NS;
    const unsigned char* tQ = sQ + s * S::kQ;
    const unsigned char* tdO = sdO + s * S::kQ;
    // transposed products Sᵀ = K.q_sᵀ, dPᵀ = V.dOᵀ: rows are this
    // warpgroup's keys, columns the tile's q rows (a tile that the causal
    // mask hides from all of them gives Pᵀ = dSᵀ = 0)
    tma::mbar_wait(full + s, (i / NS) & 1);
    gmma::wgmma_fence();
    fw::mma_ss<DP, 64>(st, sKw, S::kResBlock, tQ, fw::kBlock64);
    fw::mma_ss<DP, 64>(dpt, sVw, S::kResBlock, tdO, fw::kBlock64);
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    gmma::hold(st);
    gmma::hold(dpt);

    // Pᵀ = exp(s - lse) where (q row, key) is live, dSᵀ = Pᵀ (dPᵀ - delta)
    const int q0 = (qj0 + i) * BQ;
    const float* tLse = sLse + s * BQ;
    const float* tDelta = sDelta + s * BQ;
    const bool masked = (causal && q0 < wk0 + 64) || q0 + BQ > n;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * tq4 + (e & 1);
        const int tt = q0 + col;
        float p = fw::exp2_fast(
            fmaf(st[4 * jj + e], kLog2e, -tLse[col] * kLog2e));
        if (masked && (tt >= n || (causal && kr_lo + 8 * (e >> 1) > tt))) {
          p = 0.f;
        }
        st[4 * jj + e] = p;
        dpt[4 * jj + e] = p * (dpt[4 * jj + e] - tDelta[col]);
      }
    }
    fw::pack_a<4>(pa, st);
    fw::pack_a<4>(da, dpt);
    gmma::wgmma_fence();
    fw::mma_rs<DP, 4>(dv_acc, pa, tdO, fw::kBlock64);    // dV += Pᵀ . dO
    fw::mma_rs<DP, 4>(dk_acc, da, tQ, fw::kBlock64);     // dK += dSᵀ . q_s
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    gmma::hold(dv_acc);
    gmma::hold(dk_acc);
    fw::release(empty + s, lane);
  }
  fw::store_rows<DP>(dk, dk_acc, b, h, H, n, D, kr_lo, tq4, 1.f);
  fw::store_rows<DP>(dv, dv_acc, b, h, H, n, D, kr_lo, tq4, 1.f);
}

template <int DP>
int launch_dq_wgmma(const Args& a) {
  using S = DqShape<DP>;
  static bool opted_in = false;
  if (int err = fw::opt_in(flash_bwd_dq_wgmma_kernel<DP>, S::kSmem,
                           opted_in)) {
    return err;
  }
  // O and dO are contiguous [B, n, H, D]
  const long long sh = a.D, st = sh * a.H, sb = st * a.n;
  CUtensorMap tq, tk, tv, tdo;
  if (!tma::rows_map(&tq, a.q, a.B, a.n, a.H, a.D, a.sb, a.st, a.sh,
                     S::kRows) ||
      !tma::rows_map(&tk, a.k, a.B, a.n, a.H, a.D, a.sb, a.st, a.sh,
                     fw::kKeys) ||
      !tma::rows_map(&tv, a.v, a.B, a.n, a.H, a.D, a.sb, a.st, a.sh,
                     fw::kKeys) ||
      !tma::rows_map(&tdo, a.dout, a.B, a.n, a.H, a.D, sb, st, sh,
                     S::kRows)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  dim3 grid((a.n + S::kRows - 1) / S::kRows, a.B * a.H);
  flash_bwd_dq_wgmma_kernel<DP><<<grid, S::kThreads, S::kSmem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(a.o),
      static_cast<const float*>(a.lse), static_cast<bf16*>(a.dq),
      static_cast<float*>(a.delta), static_cast<bf16*>(a.qs), a.H, a.n, a.D,
      a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_wgmma(const Args& a) {
  using S = DkvShape<DP>;
  static bool opted_in = false;
  if (int err = fw::opt_in(flash_bwd_dkv_wgmma_kernel<DP>, S::kSmem,
                           opted_in)) {
    return err;
  }
  // q_s and dO are contiguous [B, n, H, D]
  const long long sh = a.D, st = sh * a.H, sb = st * a.n;
  CUtensorMap tqs, tk, tv, tdo;
  if (!tma::rows_map(&tqs, a.qs, a.B, a.n, a.H, a.D, sb, st, sh,
                     S::kQRows) ||
      !tma::rows_map(&tk, a.k, a.B, a.n, a.H, a.D, a.sb, a.st, a.sh,
                     S::kRows) ||
      !tma::rows_map(&tv, a.v, a.B, a.n, a.H, a.D, a.sb, a.st, a.sh,
                     S::kRows) ||
      !tma::rows_map(&tdo, a.dout, a.B, a.n, a.H, a.D, sb, st, sh,
                     S::kQRows)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  dim3 grid((a.n + S::kRows - 1) / S::kRows, a.B * a.H);
  flash_bwd_dkv_wgmma_kernel<DP>
      <<<grid, S::kThreads, S::kSmem, a.stream>>>(
          tqs, tk, tv, tdo, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.H, a.n, a.D, a.causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int n, int H, int D) {
  return B <= 0 || n <= 0 || H <= 0 || D <= 0 || D > 128 ||
         static_cast<long long>(B) * H > 65535;
}

}  // namespace

// C entry points, bound with ctypes. q, k, v [B, n, H, D] share the element
// strides (sb, st, sh) with a unit last stride; o, dout, qs and the
// gradients are contiguous [B, n, H, D] in the input type; lse and delta
// are [B*H, n] fp32. bf16 = 1 for bfloat16 inputs (the tensor-core route:
// D % 8 == 0, strides multiples of 8 elements, 16-byte aligned pointers),
// 0 for fp32 (the SIMT route, which takes qs = nullptr and scales q
// itself). Each launches one kernel on `stream` without synchronising and
// returns cudaGetLastError() (0 = cudaSuccess), or cudaErrorNotSupported
// when cuTensorMapEncodeTiled refuses a tensor map. Call
// flash_attention_bwd_dq first: it writes the delta that
// flash_attention_bwd_dkv reads and, in bf16, the scaled q (qs =
// round_bf16(q * scale)) that the dk/dv kernel streams.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* qs, int B,
                                      int n, int H, int D, long long sb,
                                      long long st, long long sh, int causal,
                                      float scale, int bf16, void* stream) {
  if (bad_shape(B, n, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr, qs, B, n, H, D,
         sb, st, sh, causal, scale, static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {q, k, v, o, dout, dq, qs})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_dq_wgmma<64>(a) : launch_dq_wgmma<128>(a);
  }
  return D <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, const void* qs,
                                       int B, int n, int H, int D,
                                       long long sb, long long st,
                                       long long sh, int causal, float scale,
                                       int bf16, void* stream) {
  if (bad_shape(B, n, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk,
         dv, const_cast<void*>(qs), B, n, H, D, sb, st, sh, causal, scale,
         static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {k, v, dout, dk, dv, qs})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_dkv_wgmma<64>(a) : launch_dkv_wgmma<128>(a);
  }
  return D <= 64 ? launch_dkv<64>(a) : launch_dkv<128>(a);
}

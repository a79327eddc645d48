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
//   bf16  `flash_fwd_wgmma_kernel`: the products on the tensor cores by
//         wgmma (bf16 operands, fp32 accumulators), which is exactly the
//         contract's bf16 operands with fp32 sums.
//
// What bounds it on the H100: at the main path's B = 16, H = 12, T = 1024,
// D = 64 causal bf16, the work is 4 * D flops per live (q, k) pair, 25.8
// GFLOP, or 0.026 ms at 989 TFLOP/s (bf16 dense); the bytes are q, k, v, O
// (25.2 MB each) and lse, 101 MB, or 0.030 ms at 3.35 TB/s. At GPT-3 1.3B's
// B = 4, H = 16, T = 2048, D = 128 the flops bound it: 68.7 GFLOP, 0.070 ms.
//
// Design. The TPU walks a sequential (BH, nq, nk) grid and carries (m, l,
// acc) in scratch across the k steps. Here a CTA owns a (b*h, q tile) and
// loops over the k tiles itself, only up to the diagonal when causal; m, l
// and acc live in registers. Any T works: out-of-range rows come in as
// zeros and the kernel masks the ragged last tile by column.
//   fp32: one CTA per (b*h, 64-row q tile), longest first; 256 threads,
//   (ty, tx) ownership of 64 x 64 score tiles; D <= 128 (tiles padded to DP
//   = 64 or 128 columns).
//   bf16: warp-specialized and persistent (tma.cuh,
//   flash_attention_wgmma.cuh). A CTA is a producer warpgroup and two
//   consumer warpgroups of 64 q rows at DP = 128 (one CTA an SM), one at
//   DP = 64 (two CTAs an SM); `setmaxnreg` gives the consumers 240 (232)
//   registers a thread and leaves the producer 24. The producer's first
//   thread takes (b*h, q tile) work tiles from a counter in device memory
//   (fw::Schedule: a few heads at a time, so their K and V stay in L2;
//   longest first) and loads by TMA from 4-D tensor maps over (D, H, T, B)
//   (the fused-qkv views in place, zeros past D and past T, 128-byte
//   swizzle): the q tile into one of two buffers, and K and V tiles of 128
//   keys through rings of 3 and 2 stages with full and empty mbarriers.
//   A consumer scales its q rows in fp32 and rounds them to bf16 in place,
//   then per k tile j: S = q.kᵀ by wgmma m64n128k16 from shared memory;
//   only tiles that cross the diagonal or the ragged end are masked (by
//   column: zero-filled keys score 0, not -1e30); the row max and sum over
//   the 4 lanes of a quad; P = exp2(s log2(e) - m log2(e)) (one SFU
//   instruction) rounded to bf16 in registers, which are the A operand of O
//   += P . V by wgmma m64n{DP}k16 (V read MN-major), so P never touches
//   shared memory. The products of tile j + 1's S and of P_j . V_j are in
//   flight together, and tile j + 1's softmax runs while P_j . V_j does.
//   The wrapper gives this route D % 8 == 0, 16-byte aligned rows and
//   strides that are multiples of 8 elements (TMA's 16-byte stride rule).

#include "flash_attention_wgmma.cuh"

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

namespace fw = flash_wgmma;
using fw::bf16;

template <int DP>
struct FwdShape : fw::Cta<DP> {
  using C = fw::Cta<DP>;
  // K leaves its stage when S is done, V when P . V is: the K ring is one
  // deeper, and the q tile is double-buffered so the next work tile's
  // loads overlap this one's last products and epilogue
  static constexpr int kStagesK = 3;
  static constexpr int kStagesV = 2;
  static constexpr int kQTile = DP / 64 * C::kResBlock;   // [kRows, DP]
  static constexpr int kTile = DP / 64 * fw::kBlock128;   // [128, DP]
  static constexpr int kBars = 4 + 2 * (kStagesK + kStagesV);
  static constexpr int kSmem = 1024 + 2 * kQTile +
                               (kStagesK + kStagesV) * kTile + 8 * kBars + 8;
  static_assert(C::kPerSm * (kSmem + 1024) <= 233472,
                "shared memory over the SM's");
};

// One k tile of the online softmax, in place on a consumer thread's share
// of S [64 rows, 128 keys from k0] (wgmma's accumulator layout): masks the
// keys past n and, when causal, after each row (only on a tile that crosses
// the diagonal or the end; rows from r_lo), takes each row's max and sum
// over the four lanes of a quad, writes P = exp2(s log2(e) - m log2(e)),
// and updates m and this lane's share of l. alpha[h] = exp2((m_old -
// m_new) log2(e)) rescales the rows' accumulators.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int wr0, int r_lo,
                                             int tq4, int n, int causal) {
  if ((causal && k0 + fw::kKeys - 1 > wr0) || k0 + fw::kKeys > n) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * jj + 2 * tq4 + (e & 1);
        const int r = r_lo + 8 * (e >> 1);
        if (c >= n || (causal && c > r)) sc[4 * jj + e] = fw::kNegInf;
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = fw::kNegInf;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    alpha[hh] = fw::exp2_fast((m[hh] - m_new) * fw::kLog2e);
    const float mL = m_new * fw::kLog2e;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
        const float p =
            fw::exp2_fast(fmaf(sc[4 * jj + e], fw::kLog2e, -mL));
        sc[4 * jj + e] = p;
        ps += p;
      }
    }
    l[hh] = alpha[hh] * l[hh] + ps;
    m[hh] = m_new;
  }
}

// Persistent: each CTA takes (b*h, q tile) work tiles from `sched` (the
// CTAs at work together share a few heads, whose K and V stay in L2: all
// heads' K and V, 64 MB at GPT-3 1.3B's shape, do not fit).
template <int DP>
__global__ void __launch_bounds__(FwdShape<DP>::kThreads,
                                  FwdShape<DP>::kPerSm)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       fw::Schedule sched, int H, int n, int D, int causal,
                       float scale) {
  using S = FwdShape<DP>;
  constexpr int NK = S::kStagesK;
  constexpr int NV = S::kStagesV;
  constexpr int NB = DP / 64;          // 64-column blocks of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = tma::align1024(smem_raw);   // two buffers
  unsigned char* sK = sQ + 2 * S::kQTile;         // NK stages
  unsigned char* sV = sK + NK * S::kTile;         // NV stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + NV * S::kTile);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + NK;
  uint64_t* v_full = k_empty + NK;
  uint64_t* v_empty = v_full + NV;
  int* work = reinterpret_cast<int*>(v_empty + NV);   // one per q buffer

  const int nq = sched.tiles;
  const int nkt = (n + fw::kKeys - 1) / fw::kKeys;   // k tiles of a head
  const int works = sched.works();
  // the k tiles a q tile sees: up to its last row when causal
  auto k_tiles = [&](int qi, int all, int c) {
    return c ? min(all, ((qi + 1) * S::kRows + fw::kKeys - 1) / fw::kKeys)
             : all;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      tma::mbar_init(q_full + i, 1);
      tma::mbar_init(q_empty + i, S::kConsumerWarps);
    }
    for (int i = 0; i < NK; ++i) {
      tma::mbar_init(k_full + i, 1);
      tma::mbar_init(k_empty + i, S::kConsumerWarps);
    }
    for (int i = 0; i < NV; ++i) {
      tma::mbar_init(v_full + i, 1);
      tma::mbar_init(v_empty + i, S::kConsumerWarps);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer
    tma::regs_dec<fw::kProducerRegs>();
    if (threadIdx.x == 0) {
      tma::prefetch_map(&tq);
      tma::prefetch_map(&tk);
      tma::prefetch_map(&tv);
      int it = 0;                      // K/V tiles loaded so far
      for (int wi = 0;; ++wi) {
        tma::mbar_wait(q_empty + (wi & 1), ((wi >> 1) & 1) ^ 1);
        const int w = atomicAdd(sched.next, 1);
        work[wi & 1] = w;              // published by the arrival below
        if (w >= works) {
          tma::mbar_arrive(q_full + (wi & 1));
          break;
        }
        int bh, rank;
        sched.decode(w, bh, rank);
        const int qi = nq - 1 - rank;
        const int b = bh / H;
        const int h = bh % H;
        const int nk = k_tiles(qi, nkt, causal);
        unsigned char* q_buf = sQ + (wi & 1) * S::kQTile;
        tma::mbar_expect_tx(q_full + (wi & 1), S::kQTile);
        for (int c = 0; c < NB; ++c) {
          tma::load_4d(q_buf + c * S::kResBlock, &tq, q_full + (wi & 1),
                       64 * c, h, qi * S::kRows, b);
        }
        for (int j = 0; j < nk; ++j, ++it) {
          const int sk = it % NK;
          const int sv = it % NV;
          tma::mbar_wait(k_empty + sk, ((it / NK) & 1) ^ 1);
          tma::mbar_expect_tx(k_full + sk, S::kTile);
          for (int c = 0; c < NB; ++c) {
            tma::load_4d(sK + sk * S::kTile + c * fw::kBlock128, &tk,
                         k_full + sk, 64 * c, h, j * fw::kKeys, b);
          }
          tma::mbar_wait(v_empty + sv, ((it / NV) & 1) ^ 1);
          tma::mbar_expect_tx(v_full + sv, S::kTile);
          for (int c = 0; c < NB; ++c) {
            tma::load_4d(sV + sv * S::kTile + c * fw::kBlock128, &tv,
                         v_full + sv, 64 * c, h, j * fw::kKeys, b);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup cw: q rows [64 cw, 64 cw + 64) of each work tile
  tma::regs_inc<S::kConsumerRegs>();
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq4 = lane & 3;
  float acc[DP / 2], sc[64], alpha[2], m[2], l[2];
  uint32_t pa[8][4];                   // P in bf16: 8 k steps of 16 keys
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  int it = 0;                          // K/V tiles consumed so far
  for (int wi = 0;; ++wi) {
    tma::mbar_wait(q_full + (wi & 1), (wi >> 1) & 1);
    const int w = work[wi & 1];
    if (w >= works) break;
    int bh, rank;
    sched.decode(w, bh, rank);
    const int qi = nq - 1 - rank;
    const int b = bh / H;
    const int h = bh % H;
    const int nk = k_tiles(qi, nkt, causal);
    const int wr0 = qi * S::kRows + 64 * cw;   // the warpgroup's first row
    const int r_lo = wr0 + 16 * warp + g;       // rows r_lo, r_lo + 8
    unsigned char* q_buf = sQ + (wi & 1) * S::kQTile;
    unsigned char* sQw = q_buf + 64 * cw * 128; // this warpgroup's rows

    fw::scale_rows<DP>(q_buf, S::kResBlock, 64 * cw, t, scale, nullptr, 0,
                       0, 0);
    gmma::fence_proxy_async();
    tma::named_sync(1 + cw, 128);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = fw::kNegInf;
    l[0] = l[1] = 0.f;                 // this lane's share of a row sum

    // S and P of k tile 0; then per tile j < nk - 1 the products of tile
    // j + 1's S and of O += P_j . V_j are in flight together, and the
    // softmax of tile j + 1 runs while P_j . V_j is on the tensor cores (no
    // branch around a product inside the loop: ptxas serializes wgmma
    // where it cannot tell which group a wait retires); the last P . V
    // after the loop
    tma::mbar_wait(k_full + it % NK, (it / NK) & 1);
    gmma::wgmma_fence();
    fw::mma_ss<DP, 128>(sc, sQw, S::kResBlock, sK + it % NK * S::kTile,
                        fw::kBlock128);
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    fw::release(k_empty + it % NK, lane);
    gmma::hold(sc);
    softmax_tile(sc, m, l, alpha, 0, wr0, r_lo, tq4, n, causal);
    fw::pack_a<8>(pa, sc);
    for (int j = 0; j + 1 < nk; ++j) {
      const int i0 = it + j;
      const int i1 = i0 + 1;
      tma::mbar_wait(k_full + i1 % NK, (i1 / NK) & 1);
      tma::mbar_wait(v_full + i0 % NV, (i0 / NV) & 1);
      gmma::wgmma_fence();
      fw::mma_ss<DP, 128>(sc, sQw, S::kResBlock, sK + i1 % NK * S::kTile,
                          fw::kBlock128);
      gmma::wgmma_commit();
      fw::mma_rs<DP, 8>(acc, pa, sV + i0 % NV * S::kTile, fw::kBlock128);
      gmma::wgmma_commit();
        gmma::wgmma_wait<1>();           // S of tile j + 1 is in
      fw::release(k_empty + i1 % NK, lane);
      gmma::hold(sc);
      softmax_tile(sc, m, l, alpha, (j + 1) * fw::kKeys, wr0, r_lo, tq4, n,
                   causal);
      gmma::wgmma_wait<0>();
      gmma::hold(acc);
      fw::release(v_empty + i0 % NV, lane);
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * jj + e] *= alpha[e >> 1];
      }
      fw::pack_a<8>(pa, sc);
    }
    const int il = it + nk - 1;
    tma::mbar_wait(v_full + il % NV, (il / NV) & 1);
    gmma::wgmma_fence();
    fw::mma_rs<DP, 8>(acc, pa, sV + il % NV * S::kTile, fw::kBlock128);
    gmma::wgmma_commit();
    gmma::wgmma_wait<0>();
    gmma::hold(acc);
    fw::release(v_empty + il % NV, lane);
    fw::release(q_empty + (wi & 1), lane);
    it += nk;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        acc[4 * jj + 2 * hh] /= lc;
        acc[4 * jj + 2 * hh + 1] /= lc;
      }
      const int r = r_lo + 8 * hh;
      if (tq4 == 0 && r < n) {
        lse[static_cast<long long>(bh) * n + r] = m[hh] + logf(lc);
      }
    }
    fw::store_rows<DP>(o, acc, b, h, H, n, D, r_lo, tq4, 1.f);
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, void* counter, int B, int n, int H, int D,
                 long long sb, long long st, long long sh, int causal,
                 float scale, cudaStream_t stream) {
  using S = FwdShape<DP>;
  static bool opted_in = false;
  if (int err = fw::opt_in(flash_fwd_wgmma_kernel<DP>, S::kSmem,
                           opted_in)) {
    return err;
  }
  CUtensorMap tq, tk, tv;
  if (!tma::rows_map(&tq, q, B, n, H, D, sb, st, sh, S::kRows) ||
      !tma::rows_map(&tk, k, B, n, H, D, sb, st, sh, fw::kKeys) ||
      !tma::rows_map(&tv, v, B, n, H, D, sb, st, sh, fw::kKeys)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const int nq = (n + S::kRows - 1) / S::kRows;
  // a q tile streams its head's K and V
  const fw::Schedule sched{static_cast<int*>(counter), B * H, nq,
                           fw::group_heads(4ll * n * DP, B * H)};
  const int grid = fw::persistent_grid(B * H * nq, S::kPerSm);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  flash_fwd_wgmma_kernel<DP><<<grid, S::kThreads, S::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), sched, H,
      n, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q, k, v [B, n, H, D] share the element
// strides (sb, st, sh) and have a unit last stride; o [B, n, H, D]
// contiguous in the input type; lse [B*H, n] fp32. bf16 = 1 for bfloat16
// inputs (the tensor-core route: D % 8 == 0, strides multiples of 8
// elements, 16-byte aligned pointers), 0 for fp32 (the SIMT route).
// `counter` is one int in device memory, zero at the launch, from which the
// bf16 kernel's CTAs take their work (the fp32 route takes nullptr).
// Returns cudaErrorNotSupported when cuTensorMapEncodeTiled refuses a
// tensor map.
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   void* counter, int B, int n, int H, int D,
                                   long long sb, long long st, long long sh,
                                   int causal, float scale, int bf16,
                                   void* stream) {
  if (B <= 0 || n <= 0 || H <= 0 || D <= 0 || D > 128 ||
      static_cast<long long>(B) * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!flash_mma::aligned(D, sb, st, sh, {q, k, v, o})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return D <= 64 ? launch_wgmma<64>(q, k, v, o, lse, counter, B, n, H, D,
                                      sb, st, sh, causal, scale, s)
                   : launch_wgmma<128>(q, k, v, o, lse, counter, B, n, H, D,
                                       sb, st, sh, causal, scale, s);
  }
  return D <= 64 ? launch<64>(q, k, v, o, lse, B, n, H, D, sb, st, sh, causal,
                              scale, s)
                 : launch<128>(q, k, v, o, lse, B, n, H, D, sb, st, sh,
                               causal, scale, s);
}

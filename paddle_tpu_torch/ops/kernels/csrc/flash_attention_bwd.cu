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
//   flash_bwd_dq_kernel  one CTA per (b*h, q tile), sweeping the k tiles;
//                        also writes delta [B*H, T] for the next kernel;
//   flash_bwd_dkv_kernel one CTA per (b*h, k tile), sweeping the q tiles.
// Both recompute s and dp: 7 tile products per (q, k) tile pair where the
// fused form needs 5. Launch order on the stream: dq, then dkv.
//
// What bounds it on the H100: at B = 16, H = 12, T = 1024, D = 64 causal
// bf16 the least work is the 5 products, 10 * D flops per live (q, k) pair,
// 64.5 GFLOP, or 0.065 ms at 989 TFLOP/s; the bytes (q, k, v, O, dO, lse
// in; dq, dk, dv out) are 202 MB, or 0.060 ms at 3.35 TB/s. Like the
// forward, these kernels run their products as fp32 FMAs on the CUDA cores
// (flash_attention_common.cuh), so they sit far above that bound; the
// tensor-core version is later work.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename E, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ o,
                    const E* __restrict__ dout, const float* __restrict__ lse,
                    E* __restrict__ dq, float* __restrict__ delta, int H, int n,
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

  load_tile<E, DP>(sQ, q + base, st, q0, n, D, scale);
  load_tile<E, DP>(sdO, dout + cbase, cst, q0, n, D, 1.f);
  // delta = rowsum(dO * O) in fp32, one warp per row
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int t = q0 + r;
    float acc = 0.f;
    if (t < n) {
      for (int d = lane; d < D; d += 32) {
        acc += Elem<E>::load(dout[cbase + t * cst + d]) *
               Elem<E>::load(o[cbase + t * cst + d]);
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
    load_tile<E, DP>(sK, k + base, st, k0, n, D, 1.f);
    load_tile<E, DP>(sV, v + base, st, k0, n, D, 1.f);
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
        sdS[rr * kLP + tx + 16 * j] =
            Elem<E>::round(p * (dp[i][j] - sDelta[rr]));
      }
    }
    __syncthreads();
    mm_nn_acc<DP>(sdS, sK, acc, ty, tx);
  }
  store_rows<E, DP>(dq, acc, b, h, H, n, D, q0, scale, ty, tx);
}

template <typename E, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     E* __restrict__ dv, int H, int n, int D, long long sb,
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

  load_tile<E, DP>(sK, k + base, st, k0, n, D, 1.f);
  load_tile<E, DP>(sV, v + base, st, k0, n, D, 1.f);

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
    load_tile<E, DP>(sQ, q + base, st, q0, n, D, scale);
    load_tile<E, DP>(sdO, dout + cbase, cst, q0, n, D, 1.f);
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
        sP[at] = Elem<E>::round(p);
        sdS[at] = Elem<E>::round(p * (dp[i][j] - sDelta[qc]));
      }
    }
    __syncthreads();
    mm_nn_acc<DP>(sP, sdO, dv_acc, ty, tx);
    mm_nn_acc<DP>(sdS, sQ, dk_acc, ty, tx);
  }
  store_rows<E, DP>(dk, dk_acc, b, h, H, n, D, k0, 1.f, ty, tx);
  store_rows<E, DP>(dv, dv_acc, b, h, H, n, D, k0, 1.f, ty, tx);
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

template <typename E, int DP>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<E, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dq_kernel<E, DP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.o),
      static_cast<const E*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<E*>(a.dq), static_cast<float*>(a.delta), a.H, a.n, a.D,
      a.sb, a.st, a.sh, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int DP>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<E, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((a.n + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dkv_kernel<E, DP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<E*>(a.dk), static_cast<E*>(a.dv), a.H, a.n, a.D, a.sb,
      a.st, a.sh, a.causal, a.scale);
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
// [B*H, n] fp32. bf16 = 1 for bfloat16 inputs, 0 for fp32. Each launches one
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
    return D <= 64 ? launch_dq<__nv_bfloat16, 64>(a)
                   : launch_dq<__nv_bfloat16, 128>(a);
  }
  return D <= 64 ? launch_dq<float, 64>(a) : launch_dq<float, 128>(a);
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
    return D <= 64 ? launch_dkv<__nv_bfloat16, 64>(a)
                   : launch_dkv<__nv_bfloat16, 128>(a);
  }
  return D <= 64 ? launch_dkv<float, 64>(a) : launch_dkv<float, 128>(a);
}

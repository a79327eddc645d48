// Fused linear + cross-entropy forward for Hopper (sm_90a): per row of x,
// lse = logsumexp(x . W^T) and lab = (x . W^T)[label], without writing the
// [N, V] logits anywhere; the loss is lse - lab.
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py `_fwd_kernel` (launched by
// `_fwd_pallas`), the TPU kernel behind `linear_cross_entropy(fused=True)`'s
// forward. Same arithmetic: logits in fp32 from operands in their own type,
// vocab columns at or past V masked to -1e30, an online logsumexp by vocab
// tile (m_new = max(m, max(tile)); l = l exp(m - m_new) + sum exp(tile -
// m_new)), l clamped at 1e-30 before the log, lab = the label column's
// logit (labels are int64 and compared as indices). Not carried over: the
// TPU's vocab padding of W to a multiple of its block (a 210 MB copy per
// call at V = 50304) -- the kernel masks the ragged last tile itself -- and
// the lane-replicated [N, 128] layout of lse and lab.
//
// What bounds it on the H100: at the training step's N = 8192, H = 2048,
// V = 50304 bf16, the product is 2 N H V = 1.688 TFLOP, 1.71 ms at 989
// TFLOP/s; the bytes (x 33.5 MB, W 206 MB, labels, lse, lab) take 0.07 ms
// at 3.35 TB/s. So operations bind, and only the tensor cores could reach
// the bound.
//
// Design. One CTA owns R rows of x (R = 16 for bf16, 8 for fp32), keeps
// them in shared memory, and sweeps the vocabulary in tiles of 32 rows of
// W (fused_linear_ce_common.cuh `tile_partials`, fp32 FMAs on the CUDA
// cores); (m, l, lab) of each row live in the registers of the warp that
// owns the row. W (206 MB) is read once per CTA, mostly from L2, where
// the CTAs resident together sweep it at about the same pace. At N = 8192
// that is 512 CTAs. SIMT is simple and exact in the operand type but runs
// at the 67 TFLOP/s fp32 rate at best; moving the product to mma/wgmma is
// the next step for speed.

#include "fused_linear_ce_common.cuh"

namespace {

using namespace lce;

template <typename E, int R>
__global__ void __launch_bounds__(kThreads)
lce_fwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const long long* __restrict__ labels, float* __restrict__ lse,
               float* __restrict__ lab, int N, int V, int H, int vec) {
  constexpr int C = kPerWarp * R;
  constexpr int RW = R / kWarps;        // rows of x per warp
  constexpr int LS = R + 1;             // row stride of the logits tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = padded(H);
  E* sX = reinterpret_cast<E*>(smem);
  float* sS = reinterpret_cast<float*>(smem + sizeof(E) * R * Hp);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * R;
  load_resident<E, R>(sX, x, n0, N, H, Hp, vec != 0);

  float m[RW], l[RW], lb[RW];
  long long lbl[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int n = n0 + warp + kWarps * i;
    m[i] = kNegInf;
    l[i] = 0.f;
    lb[i] = 0.f;
    lbl[i] = n < N ? labels[n] : -1;
  }
  __syncthreads();

  for (int v0 = 0; v0 < V; v0 += kStream) {
    float acc[C];
    tile_partials<E, R>(sX, Hp, w, V, H, v0, vec != 0, warp, lane, acc);
    reduce_scatter<C>(acc, lane);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int idx = sum_index<C>(lane, j);
      const int s = kPerWarp * warp + idx / R;
      sS[s * LS + idx % R] = v0 + s < V ? acc[j] : kNegInf;
    }
    __syncthreads();
    // lane = the tile's vocab column, for each row this warp owns
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float val = sS[lane * LS + warp + kWarps * i];
      const float mn = fmaxf(m[i], warp_max(val));
      const float e = warp_sum(expf(val - mn));
      l[i] = l[i] * expf(m[i] - mn) + e;
      m[i] = mn;
      lb[i] += warp_sum(static_cast<long long>(v0 + lane) == lbl[i] ? val
                                                                     : 0.f);
    }
    __syncthreads();            // every reader of sS is done
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int n = n0 + warp + kWarps * i;
    if (lane == 0 && n < N) {
      lse[n] = m[i] + logf(fmaxf(l[i], 1e-30f));
      lab[n] = lb[i];
    }
  }
}

template <typename E>
size_t fwd_smem_bytes(int H) {
  return sizeof(E) * Rows<E>::R * padded(H) +
         sizeof(float) * kStream * (Rows<E>::R + 1);
}

template <typename E>
int launch(const void* x, const void* w, const void* labels, void* lse,
           void* lab, int N, int V, int H, int vec, cudaStream_t stream) {
  constexpr int R = Rows<E>::R;
  const size_t smem = fwd_smem_bytes<E>(H);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_fwd_kernel<E, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int grid = (N + R - 1) / R;
  lce_fwd_kernel<E, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w),
      static_cast<const long long*>(labels), static_cast<float*>(lse),
      static_cast<float*>(lab), N, V, H, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. x [N, H] and w [V, H] contiguous in one
// type (bf16 = 1 for bfloat16, 0 for fp32), labels [N] int64, lse and lab
// [N] fp32. Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fused_linear_ce_fwd(const void* x, const void* w,
                                   const void* labels, void* lse, void* lab,
                                   int N, int V, int H, int bf16,
                                   void* stream) {
  if (N <= 0 || V <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = H % 8 == 0 &&
                  ((reinterpret_cast<size_t>(x) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(x, w, labels, lse, lab, N, V, H, vec, s);
  }
  return launch<float>(x, w, labels, lse, lab, N, V, H, vec, s);
}

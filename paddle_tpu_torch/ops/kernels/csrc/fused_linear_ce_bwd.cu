// Fused linear + cross-entropy backward for Hopper (sm_90a): from the
// forward's per-row lse and the loss gradient g [N],
//
//   dlg = round_E((softmax(x . W^T) - onehot(label)) * g)   [N, V], never
//                                                            stored
//   dx  = dlg . W      [N, H] in x's type     (fused_linear_ce_bwd_dx)
//   dW  = dlg^T . x    [V, H] in W's type     (fused_linear_ce_bwd_dw)
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py `_bwd_dx_kernel` and
// `_bwd_dw_kernel` (both launched by `_bwd_pallas`). Same arithmetic: each
// logits block recomputed in fp32 from the operands in their own type,
// columns at or past V masked to -1e30, p = exp(logit - lse), dlg = (p -
// onehot) g in fp32 rounded to the operand type before its product (round_E
// above; fused_ce.py:164 and :195), products accumulated in fp32, dx and dW
// stored in the operands' type. Labels are int64 and compared as indices.
//
// What bounds it on the H100: at N = 8192, H = 2048, V = 50304 bf16 each
// kernel does two products of 2 N H V = 1.688 TFLOP (the logits again and
// the gradient), 3.41 ms at 989 TFLOP/s; bytes (x 33.5 MB, W 206 MB, the
// output, per-row scalars) take 0.07-0.13 ms at 3.35 TB/s. Operations
// bind.
//
// Design. The TPU keeps a [bn, H] (dx) or [bv, H] (dW) fp32 scratch in 16
// MB of VMEM and walks the other axis as a sequential grid dimension. A
// Hopper CTA has 227 KB, and blocks run in no order, so one CTA owns R
// resident rows (R = 16 bf16, 8 fp32): rows of x for dx, rows of W for dW.
// It keeps them and their fp32 [R, H] accumulator in shared memory (192 KB
// in bf16 at H = 2048) and loops over the other operand itself in tiles of
// 32 streamed rows: the logits tile (fused_linear_ce_common.cuh), then dlg
// into shared memory, then acc += dlg^T . streamed tile, each thread
// owning 4 columns of all R rows. No atomics: every output element is
// summed by one thread in a fixed order, so runs are bit for bit
// repeatable. Each CTA reads the streamed operand twice (logits, then the
// gradient product), mostly from L2: at N = 8192, dx's 512 CTAs read W
// 1024 times (211 GB), and dW's 3144 CTAs read x 6288 times (211 GB) from
// a 33.5 MB x that stays in the 50 MB L2. The dx and dW kernels are one
// template with the roles of x and W swapped. fp32 FMAs on the CUDA cores:
// simple and exact in the operand type, far from the tensor-core bound;
// mma/wgmma is the next step for speed.

#include "fused_linear_ce_common.cuh"

namespace {

using namespace lce;

template <typename E, int R, bool kDW>
__global__ void __launch_bounds__(kThreads)
lce_bwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ g,
               E* __restrict__ out, int N, int V, int H, int vec) {
  constexpr int C = kPerWarp * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = padded(H);
  E* sRes = reinterpret_cast<E*>(smem);
  float* sAcc = reinterpret_cast<float*>(smem + sizeof(E) * R * Hp);
  float* sD = sAcc + R * Hp;                  // dlg tile [kStream, R]

  const E* res = kDW ? w : x;
  const E* str = kDW ? x : w;
  const int n_res = kDW ? V : N;
  const int n_str = kDW ? N : V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * R;

  load_resident<E, R>(sRes, res, r0, n_res, H, Hp, vec != 0);
  for (int e = threadIdx.x; e < R * Hp; e += kThreads) sAcc[e] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < n_str; s0 += kStream) {
    float acc[C];
    tile_partials<E, R>(sRes, Hp, str, n_str, H, s0, vec != 0, warp, lane,
                        acc);
    reduce_scatter<C>(acc, lane);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int idx = sum_index<C>(lane, j);
      const int s = kPerWarp * warp + idx / R;
      const int r = idx % R;
      const int n = kDW ? s0 + s : r0 + r;     // row of x
      const int v = kDW ? r0 + r : s0 + s;     // vocab column
      float d = 0.f;
      if (n < N && v < V) {
        const float p = expf(acc[j] - lse[n]);
        const float hot = static_cast<long long>(v) == labels[n] ? 1.f : 0.f;
        d = Elem<E>::round((p - hot) * g[n]);
      }
      sD[s * R + r] = d;
    }
    __syncthreads();

    // acc[r, c] += sum_s dlg[s, r] streamed[s0 + s, c]
    const int ns = min(kStream, n_str - s0);
    for (int c = 4 * threadIdx.x; c < Hp; c += 4 * kThreads) {
      float4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = *reinterpret_cast<const float4*>(sAcc + r * Hp + c);
      }
#pragma unroll 4
      for (int s = 0; s < ns; ++s) {
        const float4 b = load4(
            str + static_cast<long long>(s0 + s) * H, c, H, vec != 0);
#pragma unroll
        for (int r4 = 0; r4 < R; r4 += 4) {
          const float4 d = *reinterpret_cast<const float4*>(sD + s * R + r4);
          const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[r4 + i].x = fmaf(dd[i], b.x, a[r4 + i].x);
            a[r4 + i].y = fmaf(dd[i], b.y, a[r4 + i].y);
            a[r4 + i].z = fmaf(dd[i], b.z, a[r4 + i].z);
            a[r4 + i].w = fmaf(dd[i], b.w, a[r4 + i].w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        *reinterpret_cast<float4*>(sAcc + r * Hp + c) = a[r];
      }
    }
    __syncthreads();            // sD and sAcc are free for the next tile
  }

  for (int e = threadIdx.x; e < R * Hp; e += kThreads) {
    const int r = e / Hp;
    const int c = e % Hp;
    if (r0 + r < n_res && c < H) {
      out[static_cast<long long>(r0 + r) * H + c] = Elem<E>::store(sAcc[e]);
    }
  }
}

template <typename E>
size_t bwd_smem_bytes(int H) {
  constexpr int R = Rows<E>::R;
  return (sizeof(E) + sizeof(float)) * R * padded(H) +
         sizeof(float) * kStream * R;
}

template <typename E, bool kDW>
int launch(const void* x, const void* w, const void* labels, const void* lse,
           const void* g, void* out, int N, int V, int H, int vec,
           cudaStream_t stream) {
  constexpr int R = Rows<E>::R;
  const size_t smem = bwd_smem_bytes<E>(H);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_bwd_kernel<E, R, kDW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int grid = ((kDW ? V : N) + R - 1) / R;
  lce_bwd_kernel<E, R, kDW><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w),
      static_cast<const long long*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<E*>(out), N, V, H, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDW>
int dispatch(const void* x, const void* w, const void* labels,
             const void* lse, const void* g, void* out, int N, int V, int H,
             int bf16, void* stream) {
  if (N <= 0 || V <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = H % 8 == 0 &&
                  ((reinterpret_cast<size_t>(x) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, kDW>(x, w, labels, lse, g, out, N, V, H,
                                      vec, s);
  }
  return launch<float, kDW>(x, w, labels, lse, g, out, N, V, H, vec, s);
}

}  // namespace

// C entry points, bound with ctypes. x [N, H] and w [V, H] contiguous in
// one type (bf16 = 1 for bfloat16, 0 for fp32), labels [N] int64, lse and g
// [N] fp32; dx [N, H] or dw [V, H] contiguous in the operand type. Each
// launches on `stream` and does not synchronise, and returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fused_linear_ce_bwd_dx(const void* x, const void* w,
                                      const void* labels, const void* lse,
                                      const void* g, void* dx, int N, int V,
                                      int H, int bf16, void* stream) {
  return dispatch<false>(x, w, labels, lse, g, dx, N, V, H, bf16, stream);
}

extern "C" int fused_linear_ce_bwd_dw(const void* x, const void* w,
                                      const void* labels, const void* lse,
                                      const void* g, void* dw, int N, int V,
                                      int H, int bf16, void* stream) {
  return dispatch<true>(x, w, labels, lse, g, dw, N, V, H, bf16, stream);
}

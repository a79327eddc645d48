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
// What bounds it on the H100: at the main path's B = 16, H = 12, T = 1024,
// D = 64 causal bf16, the work is 4 * D flops per live (q, k) pair, 25.8
// GFLOP, or 0.026 ms at 989 TFLOP/s (bf16 dense); the bytes are q, k, v, O
// (25.2 MB each) and lse, 101 MB, or 0.030 ms at 3.35 TB/s. The two are
// close, and only a kernel on the tensor cores could approach either.
//
// Design. The TPU walks a sequential (BH, nq, nk) grid and carries (m, l,
// acc) in scratch across the k steps. Here one CTA owns one (b*h, 64-row q
// tile) and loops over the 64-row k tiles itself, only up to the diagonal
// when causal; m, l and acc live in registers. The products are fp32 FMAs
// on the CUDA cores over fp32 shared-memory tiles (flash_attention_common.cuh):
// simple and exact in the operand type, but limited to the 67 TFLOP/s fp32
// rate, about 15x short of the bf16 tensor-core bound above. Moving the two
// products to mma/wgmma is the next step for speed. q tiles are scheduled
// longest-first so the causal triangle's long rows start early. Any T works:
// the kernel masks the ragged last tile itself. D <= 128 (tiles are padded
// to DP = 64 or 128 columns).

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename E, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o,
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

  load_tile<E, DP>(sQ, q + base, st, q0, n, D, scale);

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
    load_tile<E, DP>(sK, k + base, st, k0, n, D, 1.f);
    load_tile<E, DP>(sV, v + base, st, k0, n, D, 1.f);
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
        sP[(ty + 16 * i) * kLP + tx + 16 * j] = Elem<E>::round(p);
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
  store_rows<E, DP>(o, acc, b, h, H, n, D, q0, 1.f, ty, tx);
}

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (DP + 4) + kTile * kLP);
}

template <typename E, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int n, int H, int D, long long sb, long long st,
           long long sh, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP>();
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<E, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((n + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<E, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), static_cast<float*>(lse),
      H, n, D, sb, st, sh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q, k, v [B, n, H, D] share the element
// strides (sb, st, sh) and have a unit last stride; o [B, n, H, D]
// contiguous in the input type; lse [B*H, n] fp32. bf16 = 1 for bfloat16
// inputs, 0 for fp32. Launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
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
    return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, n, H, D,
                                               sb, st, sh, causal, scale, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, n, H, D,
                                                sb, st, sh, causal, scale, s);
  }
  return D <= 64 ? launch<float, 64>(q, k, v, o, lse, B, n, H, D, sb, st, sh,
                                     causal, scale, s)
                 : launch<float, 128>(q, k, v, o, lse, B, n, H, D, sb, st, sh,
                                      causal, scale, s);
}

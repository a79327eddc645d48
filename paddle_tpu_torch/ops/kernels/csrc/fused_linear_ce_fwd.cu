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
// call at V = 50304) -- the kernels mask the ragged last tile themselves --
// and the lane-replicated [N, 128] layout of lse and lab.
//
// What bounds it on the H100: at the training step's N = 8192, H = 2048,
// V = 50304 bf16, the product is 2 N H V = 1.688 TFLOP, 1.71 ms at 989
// TFLOP/s; the bytes (x 33.5 MB, W 206 MB, labels, lse, lab) take 0.07 ms
// at 3.35 TB/s. So operations bind, and bf16 goes to the tensor cores.
//
// bf16: `lce_fwd_mma_kernel`, a GEMM with an online-logsumexp epilogue.
// A CTA owns 128 rows of x and walks a chunk of the vocabulary in tiles of
// 256 columns; each tile is the logits [128, 256] = x_tile . W_tile^T over
// all of H, by wgmma m64n256k16 (bf16 operands, fp32 sums) on two
// warpgroups of 64 rows, 128 fp32 accumulators a thread. x and W are both
// K-major (H contiguous), the layout wgmma reads from 128-byte-swizzled
// shared memory with no transpose. H is streamed in 64-column stages
// (x 16 KB + W 32 KB) through a ring of four (192 KB) by cp.async, two
// stages ahead of the wgmma, whose groups overlap one step; the stages run
// on across tile boundaries, so the next tile's loads are in flight during
// a tile's epilogue. The epilogue masks columns >= V, takes the label
// column's logit, and folds the tile into each row's (m, l) with exp2 and
// log2 e folded in: per thread over its 64 columns of two rows, then over
// the four lanes that share a row. The [N, V] logits never leave
// registers.
// Filling 132 SMs: N = 8192 gives 64 row blocks, so the vocabulary is split
// into S chunks (S = SMs / row blocks, at most the tile count: 2 at the
// slice's shape, 128 CTAs); each chunk's (m, l, lab) goes to a scratch [3,
// S, N] the wrapper allocates, and `lce_fwd_combine_kernel` combines the
// chunks in chunk order and takes the log. Fixed orders, no atomics: two
// calls give the same bits.
//
// fp32: `lce_fwd_kernel` on the CUDA cores (TF32 would break the fp32
// contract). One CTA owns 8 rows of x, keeps them in shared memory, and
// sweeps the vocabulary in tiles of 32 rows of W (fused_linear_ce_common.cuh
// `tile_partials`, fp32 FMAs); (m, l, lab) of each row live in the
// registers of the warp that owns the row.

#include "fused_linear_ce_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace lce;

// ------------------------------------------------- fp32: CUDA-core FMAs

constexpr int kRows = Rows<float>::R;   // resident rows of x per CTA

__global__ void __launch_bounds__(kThreads)
lce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const long long* __restrict__ labels, float* __restrict__ lse,
               float* __restrict__ lab, int N, int V, int H, int vec) {
  constexpr int C = kPerWarp * kRows;
  constexpr int RW = kRows / kWarps;    // rows of x per warp
  constexpr int LS = kRows + 1;         // row stride of the logits tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const int Hp = padded(H);
  float* sX = reinterpret_cast<float*>(smem);
  float* sS = sX + kRows * Hp;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRows;
  load_resident<float, kRows>(sX, x, n0, N, H, Hp, vec != 0);

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
    tile_partials<float, kRows>(sX, Hp, w, V, H, v0, vec != 0, warp, lane,
                                acc);
    reduce_scatter<C>(acc, lane);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int idx = sum_index<C>(lane, j);
      const int s = kPerWarp * warp + idx / kRows;
      sS[s * LS + idx % kRows] = v0 + s < V ? acc[j] : kNegInf;
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

size_t simt_smem_bytes(int H) {
  return sizeof(float) * (kRows * padded(H) + kStream * (kRows + 1));
}

int launch_simt(const void* x, const void* w, const void* labels, void* lse,
                void* lab, int N, int V, int H, int vec,
                cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(H);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int grid = (N + kRows - 1) / kRows;
  lce_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const long long*>(labels), static_cast<float*>(lse),
      static_cast<float*>(lab), N, V, H, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bf16: tensor cores

namespace fm = flash_mma;

using fm::bf16;
using namespace gmma;

constexpr int kTcRows = 128;              // rows of x per CTA
constexpr int kTcCols = 256;              // vocab columns per tile
constexpr int kTcK = 64;                  // H columns per stage (128 bytes)
constexpr int kTcStages = 4;              // the ring
constexpr int kTcAhead = kTcStages - 2;   // stages loaded ahead of wgmma
constexpr int kTcThreads = 256;           // two warpgroups
constexpr int kTileX = kTcRows * 128;     // 16,384 bytes a stage
constexpr int kTileW = kTcCols * 128;     // 32,768
constexpr int kStageBytes = kTileX + kTileW;
constexpr int kTcSmem = kTcStages * kStageBytes;    // 196,608
static_assert(kTcSmem <= kSmemLimit, "shared memory over the opt-in");

// Stage `it` of a CTA's walk (vocab tile t0 + it / KT, H columns
// [64 (it % KT), + 64)) into ring slot it % 4: rows of x and of W, zeros
// past N, V and H.
__device__ __forceinline__ void load_stage(unsigned char* smem,
                                           const bf16* x, const bf16* w,
                                           int it, int KT, int t0, int r0,
                                           int N, int V, int H) {
  unsigned char* st = smem + (it % kTcStages) * kStageBytes;
  const int k0 = (it % KT) * kTcK;
  const int v0 = (t0 + it / KT) * kTcCols;
#pragma unroll
  for (int i = 0; i < (kTcRows + kTcCols) * 8 / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const bool is_x = e < kTcRows * 8;          // i < 4
    const int r = (is_x ? e : e - kTcRows * 8) >> 3;
    const int c = e & 7;
    const int row = (is_x ? r0 : v0) + r;
    const bool valid = row < (is_x ? N : V) && k0 + 8 * c < H;
    const bf16* src = is_x ? x : w;
    fm::cp_async16(st + (is_x ? 0 : kTileX) + sw128(r, c),
                   valid ? src + static_cast<long long>(row) * H + k0 + 8 * c
                         : src,
                   valid);
  }
}

// max and sum over the four lanes that hold one row (lanes 4 g .. 4 g + 3)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// 2^x (MUFU.EX2; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's step of the online logsumexp for row h of this thread: the
// row's logits are acc[4 j + 2 h + e], columns 8 j + e (+ 2 tq) of the
// tile; with kRagged, those at or past `lim` read as -1e30 (the columns
// past V of the last tile). (m, l) become those of the row's logits so
// far, over the four lanes that share the row.
template <bool kRagged>
__device__ __forceinline__ void online_lse(const float (&acc)[128], int h,
                                           int lim, float& m, float& l) {
  float tmax = kNegInf;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = !kRagged || 8 * j + e < lim ? acc[4 * j + 2 * h + e]
                                                  : kNegInf;
      tmax = fmaxf(tmax, a);
    }
  }
  const float mn = fmaxf(m, quad_max(tmax));
  const float off = -mn * fm::kLog2e;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!kRagged || 8 * j + e < lim) {
        sum += fast_exp2(fmaf(acc[4 * j + 2 * h + e], fm::kLog2e, off));
      }
    }
  }
  l = l * fast_exp2(fmaf(m, fm::kLog2e, off)) + quad_sum(sum);
  m = mn;
}

// Chunk blockIdx.y of the vocabulary (tiles [y T / S, (y + 1) T / S) of the
// T = ceil(V / 256)) against rows [128 blockIdx.x, + 128) of x: each row's
// (m, l, lab) over the chunk into part [3, S, N].
__global__ void __launch_bounds__(kTcThreads, 1)
lce_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const long long* __restrict__ labels,
                   float* __restrict__ part, int N, int V, int H) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int S = gridDim.y;
  const int T = (V + kTcCols - 1) / kTcCols;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.y) * T / S);
  const int t1 = static_cast<int>((blockIdx.y + 1LL) * T / S);
  const int KT = (H + kTcK - 1) / kTcK;
  const int total = (t1 - t0) * KT;
  const int r0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;                  // warpgroup: rows 64 wg ..
  const int g = lane >> 2;
  const int tq = lane & 3;

  // this thread's two rows: 64 wg + 16 (warp % 4) + g + 8 h; the tile
  // and the column in it of each row's label (-1: no row)
  int lt[2], lc[2];
  float m[2], l[2], lb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = r0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
    const long long label = n < N ? labels[n] : -1;
    lt[h] = label < 0 ? -1 : static_cast<int>(label / kTcCols);
    lc[h] = static_cast<int>(label % kTcCols) - 2 * tq;
    m[h] = kNegInf;
    l[h] = 0.f;
    lb[h] = 0.f;
  }

  // acc is written by wgmma only (the first product of a tile overwrites
  // it) and read by plain code only after the wait for every group
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  hold(acc);

#pragma unroll
  for (int i = 0; i < kTcAhead; ++i) {
    if (i < total) load_stage(smem, x, w, i, KT, t0, r0, N, V, H);
    fm::cp_commit();
  }
  int it = 0;                                // stage of the walk
  for (int t = t0; t < t1; ++t) {
    for (int kt = 0; kt < KT; ++kt, ++it) {
      fm::cp_wait<kTcAhead - 1>();           // stage it is in
      fence_proxy_async();
      __syncthreads();      // and every warpgroup is done with it - 2's slot
      if (it + kTcAhead < total) {
        load_stage(smem, x, w, it + kTcAhead, KT, t0, r0, N, V, H);
      }
      fm::cp_commit();
      const unsigned char* st = smem + (it % kTcStages) * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < kTcK / 16; ++kd) {
        wgmma_64x256_ss(acc,
                        gmma_desc(st + wg * (kTileX / 2) + 32 * kd, 16,
                                  1024),
                        gmma_desc(st + kTileX + 32 * kd, 16, 1024),
                        kt > 0 || kd > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                       // group it - 1 is done
    }
    wgmma_wait<0>();
    hold(acc);

    // the tile's epilogue: this thread holds columns t 256 + 2 tq + 8 j + e
    // of its rows h = 0, 1
    const int v0 = t * kTcCols + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lt[h] == t) {                      // the label's tile
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (lc[h] == 8 * j + e) lb[h] = acc[4 * j + 2 * h + e];
          }
        }
      }
      if (v0 - 2 * tq + kTcCols <= V) {
        online_lse<false>(acc, h, 0, m[h], l[h]);
      } else {
        online_lse<true>(acc, h, V - v0, m[h], l[h]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lab_h = quad_sum(lb[h]);     // one lane at most holds it
    const int n = r0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
    if (tq == 0 && n < N) {
      const long long i = static_cast<long long>(blockIdx.y) * N + n;
      const long long SN = static_cast<long long>(S) * N;
      part[i] = m[h];
      part[SN + i] = l[h];
      part[2 * SN + i] = lab_h;
    }
  }
}

// lse and lab of each row from the S chunks' (m, l, lab), in chunk order
__global__ void lce_fwd_combine_kernel(const float* __restrict__ part,
                                       float* __restrict__ lse,
                                       float* __restrict__ lab, int N,
                                       int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long long SN = static_cast<long long>(S) * N;
  float m = kNegInf;
  for (int s = 0; s < S; ++s) {
    m = fmaxf(m, part[static_cast<long long>(s) * N + n]);
  }
  float l = 0.f;
  float lb = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long i = static_cast<long long>(s) * N + n;
    l += part[SN + i] * exp2f((part[i] - m) * fm::kLog2e);
    lb += part[2 * SN + i];
  }
  lse[n] = m + logf(fmaxf(l, 1e-30f));
  lab[n] = lb;
}

// Vocabulary chunks S for N rows on the current device: enough 128-row x
// 256-column CTAs to fill the SMs once, at most one chunk per tile.
int fwd_chunks(int N, int V) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int row_blocks = (N + kTcRows - 1) / kTcRows;
  const int tiles = (V + kTcCols - 1) / kTcCols;
  const int s = sms / row_blocks > 1 ? sms / row_blocks : 1;
  return s < tiles ? s : tiles;
}

int launch_mma(const void* x, const void* w, const void* labels, void* lse,
               void* lab, void* scratch, int N, int V, int H,
               cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<size_t>(x) |
                         reinterpret_cast<size_t>(w)) & 15) == 0;
  if (H % 8 != 0 || !aligned || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int S = fwd_chunks(N, V);
  float* part = static_cast<float*>(scratch);
  lce_fwd_mma_kernel<<<dim3((N + kTcRows - 1) / kTcRows, S), kTcThreads,
                       kTcSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const long long*>(labels), part, N, V, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      part, static_cast<float*>(lse), static_cast<float*>(lab), N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch `fused_linear_ce_fwd` needs for N rows and V vocab
// columns on the current device: 3 S N for bf16 (S vocabulary chunks), 0
// for fp32.
extern "C" long long fused_linear_ce_fwd_scratch(int N, int V, int bf16) {
  if (!bf16 || N <= 0 || V <= 0) return 0;
  return 3LL * fwd_chunks(N, V) * N;
}

// C entry point, bound with ctypes. x [N, H] and w [V, H] contiguous in one
// type (bf16 = 1 for bfloat16, 0 for fp32), labels [N] int64, lse and lab
// [N] fp32, scratch fp32 of `fused_linear_ce_fwd_scratch` floats. bf16
// takes H % 8 == 0 and 16-byte aligned x and w (the wrapper pads or
// copies); fp32 takes any H up to its shared-memory limit. Launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launches (0 = cudaSuccess), or cudaErrorInvalidValue for shapes the
// kernels do not take.
extern "C" int fused_linear_ce_fwd(const void* x, const void* w,
                                   const void* labels, void* lse, void* lab,
                                   void* scratch, int N, int V, int H,
                                   int bf16, void* stream) {
  if (N <= 0 || V <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_mma(x, w, labels, lse, lab, scratch, N, V, H, s);
  }
  const int vec = H % 8 == 0 &&
                  ((reinterpret_cast<size_t>(x) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  return launch_simt(x, w, labels, lse, lab, N, V, H, vec, s);
}

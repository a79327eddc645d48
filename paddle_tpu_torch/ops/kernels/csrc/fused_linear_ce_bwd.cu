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
// columns at or past V masked, p = exp(logit - lse), dlg = (p - onehot) g
// in fp32 rounded to the operand type before its product (fused_ce.py:164
// and :195), products accumulated in fp32, dx and dW stored in the
// operands' type. Labels are int64 and compared as indices.
//
// What bounds it on the H100: at N = 8192, H = 2048, V = 50304 bf16 each
// kernel does two products of 2 N H V = 1.688 TFLOP (the logits again and
// the gradient), 3.41 ms at 989 TFLOP/s; bytes (x 33.5 MB, W 206 MB, the
// output, per-row scalars) take 0.07-0.13 ms at 3.35 TB/s. Operations
// bind, so bf16 goes to the tensor cores.
//
// bf16: `lce_bwd_mma_kernel`, wgmma (bf16 operands, fp32 sums). The TPU
// keeps a [bn, H] fp32 scratch in 16 MB of VMEM; a Hopper SM holds 256 KB
// of registers, too few for 64 rows of fp32 gradient at H = 2048 (512
// KB). So a thread-block cluster of C = ceil(H / 512) CTAs (4 at H =
// 2048) splits H: the CTA of rank r owns columns [512 r, 512 r + 512) of
// 64 resident rows (x for dx, W for dW), keeps that slice of them in
// shared memory and its fp32 [64, 512] gradient in registers (128 a
// thread, two warpgroups of 256 columns), and walks the other operand in
// tiles of 64 streamed rows, double-buffered by cp.async. Per tile:
//   1. the partial logits [64, 64] over the CTA's 512 columns by wgmma
//      from shared memory, the two 256-column halves on warpgroups 0 and
//      1, summed in shared memory (half 0 + half 1);
//   2. the cluster sums the C partials through distributed shared memory
//      in rank order (rank 0 + rank 1 + ...): CTA r sums rows i = r mod C
//      for all C CTAs, forms dlg, rounds it to bf16 and writes it into the
//      dlg tile of every CTA of the cluster;
//   3. acc += dlg . tile by wgmma, dlg's A fragments loaded from shared
//      memory into registers (ldmatrix), the tile read in place, MN-major.
// Two cluster barriers a tile order the exchange; every sum runs in a
// fixed order and nothing is atomic, so two calls give the same bits. The
// streamed operand crosses L2 once per CTA: 26 GB per kernel at N = 8192
// against the SIMT kernels' 211 GB. dx and dW are one template with the
// roles of x and W swapped; dW computes the logits transposed, W rows
// against x rows, and reads the per-row lse, g and labels of each x tile.
//
// fp32: `lce_bwd_kernel` on the CUDA cores (TF32 would break the fp32
// contract; fp32 needs no rounding of dlg). One CTA owns 8 resident rows
// and their fp32 [8, H] accumulator in shared memory and loops over the
// other operand in tiles of 32 streamed rows: the logits tile
// (fused_linear_ce_common.cuh), then dlg into shared memory, then acc +=
// dlg^T . streamed tile, each thread owning 4 columns of all 8 rows; no
// atomics.

#include <cooperative_groups.h>

#include "fused_linear_ce_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace lce;

// ------------------------------------------------- fp32: CUDA-core FMAs

constexpr int kRows = Rows<float>::R;     // resident rows per CTA

template <bool kDW>
__global__ void __launch_bounds__(kThreads)
lce_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const long long* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ g,
               float* __restrict__ out, int N, int V, int H, int vec) {
  constexpr int C = kPerWarp * kRows;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int Hp = padded(H);
  float* sRes = reinterpret_cast<float*>(smem);
  float* sAcc = sRes + kRows * Hp;
  float* sD = sAcc + kRows * Hp;             // dlg tile [kStream, kRows]

  const float* res = kDW ? w : x;
  const float* str = kDW ? x : w;
  const int n_res = kDW ? V : N;
  const int n_str = kDW ? N : V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;

  load_resident<float, kRows>(sRes, res, r0, n_res, H, Hp, vec != 0);
  for (int e = threadIdx.x; e < kRows * Hp; e += kThreads) sAcc[e] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < n_str; s0 += kStream) {
    float acc[C];
    tile_partials<float, kRows>(sRes, Hp, str, n_str, H, s0, vec != 0,
                                warp, lane, acc);
    reduce_scatter<C>(acc, lane);
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int idx = sum_index<C>(lane, j);
      const int s = kPerWarp * warp + idx / kRows;
      const int r = idx % kRows;
      const int n = kDW ? s0 + s : r0 + r;     // row of x
      const int v = kDW ? r0 + r : s0 + s;     // vocab column
      float d = 0.f;
      if (n < N && v < V) {
        const float p = expf(acc[j] - lse[n]);
        const float hot = static_cast<long long>(v) == labels[n] ? 1.f : 0.f;
        d = (p - hot) * g[n];
      }
      sD[s * kRows + r] = d;
    }
    __syncthreads();

    // acc[r, c] += sum_s dlg[s, r] streamed[s0 + s, c]
    const int ns = min(kStream, n_str - s0);
    for (int c = 4 * threadIdx.x; c < Hp; c += 4 * kThreads) {
      float4 a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a[r] = *reinterpret_cast<const float4*>(sAcc + r * Hp + c);
      }
#pragma unroll 4
      for (int s = 0; s < ns; ++s) {
        const float4 b = load4(
            str + static_cast<long long>(s0 + s) * H, c, H, vec != 0);
#pragma unroll
        for (int r4 = 0; r4 < kRows; r4 += 4) {
          const float4 d =
              *reinterpret_cast<const float4*>(sD + s * kRows + r4);
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
      for (int r = 0; r < kRows; ++r) {
        *reinterpret_cast<float4*>(sAcc + r * Hp + c) = a[r];
      }
    }
    __syncthreads();            // sD and sAcc are free for the next tile
  }

  for (int e = threadIdx.x; e < kRows * Hp; e += kThreads) {
    const int r = e / Hp;
    const int c = e % Hp;
    if (r0 + r < n_res && c < H) {
      out[static_cast<long long>(r0 + r) * H + c] = sAcc[e];
    }
  }
}

size_t simt_smem_bytes(int H) {
  return sizeof(float) * (2 * kRows * padded(H) + kStream * kRows);
}

template <bool kDW>
int launch_simt(const void* x, const void* w, const void* labels,
                const void* lse, const void* g, void* out, int N, int V,
                int H, int vec, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(H);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_bwd_kernel<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int grid = ((kDW ? V : N) + kRows - 1) / kRows;
  lce_bwd_kernel<kDW><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const long long*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(out), N, V, H, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bf16: tensor cores

namespace fm = flash_mma;
namespace cg = cooperative_groups;

using namespace gmma;

using fm::bf16;

constexpr int kSlice = 512;              // H columns per CTA of a cluster
constexpr int kMaxCluster = 8;           // portable cluster size
constexpr int kRes = 64;                 // resident rows per CTA
constexpr int kTile = 64;                // streamed rows per tile
// The resident slice and the streamed tiles are [64 rows, 512 columns] in
// wgmma's 128-byte-swizzled layout: eight 8 KB blocks of 64 columns, row r
// of a block 128 bytes at r * 128, its 16-byte chunk c stored at c ^ (r %
// 8). Read K-major (the logits: rows are M or N, columns K) and MN-major
// (the gradient: the tile's rows are K, its columns N).
constexpr int kBlock = 64 * 128;         // bytes of one 64-column block
constexpr int kSliceBytes = 8 * kBlock;  // 65,536
constexpr int kLDD = fm::Tile<kTile>::LD;    // bf16 row of dlg [64, 64]: 72
constexpr int kLDP = kTile + 4;              // fp32 row of the partials: 68
constexpr int kPartBytes = kRes * kLDP * 4;          // 17,408
constexpr int kDlgBytes = kRes * kLDD * 2;           // 9,216
constexpr int kScalarBytes = kTile * (4 + 4 + 8);    // lse, g, label
constexpr int kMmaSmem = 3 * kSliceBytes + kPartBytes + kDlgBytes +
                         kScalarBytes;               // 224,256
static_assert(kMmaSmem <= kSmemLimit, "shared memory over the opt-in");
static_assert(kThreads == 256 && kRes == 64 && kTile == 64,
              "two warpgroups on 64 x 64 tiles");

// Rows [row0, row0 + 64) of a [n, H] bf16 matrix, columns [col0, col0 +
// 512), into a swizzled [64, 512] tile; zeros past n and past H.
__device__ __forceinline__ void copy_slice(unsigned char* dst,
                                           const bf16* src, int row0, int n,
                                           int H, int col0) {
  constexpr int CPR = kSlice / 8;        // 16-byte chunks per row
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * CPR; e += kThreads) {
    const int r = e / CPR;
    const int c = e % CPR;
    const int t = row0 + r;
    const bool valid = t < n && col0 + 8 * c < H;
    fm::cp_async16(dst + (c / 8) * kBlock + sw128(r, c % 8),
                   valid ? src + static_cast<long long>(t) * H + col0 + 8 * c
                         : src,
                   valid);
  }
}

// lse, g and label of x row row0 + threadIdx.x (called by the threads
// below 64; a row past N reads as lse 0, g 0, label -1).
__device__ __forceinline__ void row_scalars(float& l, float& gg,
                                            long long& lab,
                                            const float* lse, const float* g,
                                            const long long* labels,
                                            int row0, int N) {
  const int n = row0 + static_cast<int>(threadIdx.x);
  const bool valid = n < N;
  l = valid ? lse[n] : 0.f;
  gg = valid ? g[n] : 0.f;
  lab = valid ? labels[n] : -1;
}

template <bool kDW>
__global__ void __launch_bounds__(kThreads, 1)
lce_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const long long* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ g, bf16* __restrict__ out,
                   int N, int V, int H) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sRes = smem;
  unsigned char* sStr = smem + kSliceBytes;          // two tiles
  float* sPart = reinterpret_cast<float*>(smem + 3 * kSliceBytes);
  bf16* sDlg = reinterpret_cast<bf16*>(smem + 3 * kSliceBytes + kPartBytes);
  float* sLse = reinterpret_cast<float*>(smem + kMmaSmem - kScalarBytes);
  float* sG = sLse + kTile;
  long long* sLab = reinterpret_cast<long long*>(sG + kTile);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = rank * kSlice;
  const int r0 = static_cast<int>(blockIdx.x) / C * kRes;
  const bf16* res = kDW ? w : x;
  const bf16* str = kDW ? x : w;
  const int n_res = kDW ? V : N;
  const int n_str = kDW ? N : V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;              // warpgroup
  const int wr = (warp & 3) * 16;        // the warp's rows in a 64-row tile
  const int g8 = lane >> 2;              // fragment row
  const int tq = lane & 3;               // fragment column pair

  copy_slice(sRes, res, r0, n_res, H, col0);
  copy_slice(sStr, str, 0, n_str, H, col0);
  fm::cp_commit();
  if (!kDW && threadIdx.x < kRes) {      // dx: the resident rows' scalars
    float l, gg;
    long long lab;
    row_scalars(l, gg, lab, lse, g, labels, r0, N);
    sLse[threadIdx.x] = l;
    sG[threadIdx.x] = gg;
    sLab[threadIdx.x] = lab;
  }

  // the gradient: warpgroup wg owns columns 256 wg .. 256 wg + 256 of all
  // 64 rows, warp w rows wr .. wr + 16 of them
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  const int n_tiles = (n_str + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * kTile;
    const unsigned char* sT = sStr + (t & 1) * kSliceBytes;
    fm::cp_wait<0>();
    fence_proxy_async();
    __syncthreads();                     // tile t is in; tile t - 1 is done
    if (t + 1 < n_tiles) {
      copy_slice(sStr + ((t + 1) & 1) * kSliceBytes, str, s0 + kTile, n_str,
                 H, col0);
    }
    fm::cp_commit();
    float l = 0.f, gg = 0.f;
    long long lab = -1;
    if (kDW && threadIdx.x < kTile) {    // dW: this x tile's scalars
      row_scalars(l, gg, lab, lse, g, labels, s0, N);
    }

    // 1. partial logits [64 resident, 64 streamed] over this CTA's columns:
    // warpgroup wg sums K half wg (256 columns, 16 steps)
    float c[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] = 0.f;
    hold(c);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < kSlice / 32; ++kd) {
      const int k0 = wg * (kSlice / 2) + kd * 16;
      const int off = (k0 / 64) * kBlock + (k0 % 64) * 2;
      wgmma_64x64_ss(c, gmma_desc(sRes + off, 16, 1024),
                     gmma_desc(sT + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(c);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = sPart + (wr + g8 + 8 * h) * kLDP + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(p) =
              make_float2(c[4 * j + 2 * h], c[4 * j + 2 * h + 1]);
        }
      }
    }
    if (kDW && threadIdx.x < kTile) {
      sLse[threadIdx.x] = l;
      sG[threadIdx.x] = gg;
      sLab[threadIdx.x] = lab;
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(
              sPart + (wr + g8 + 8 * h) * kLDP + 8 * j + 2 * tq);
          const float2 o = *p;
          *p = make_float2(c[4 * j + 2 * h] + o.x,
                           c[4 * j + 2 * h + 1] + o.y);
        }
      }
    }
    cluster.sync();                      // every CTA's partials are in

    // 2. CTA `rank` finishes rows rank, rank + C, ... for the whole cluster
    const int mine = (kRes - rank + C - 1) / C;
    for (int e = threadIdx.x; e < mine * (kTile / 4); e += kThreads) {
      const int i = rank + C * (e / (kTile / 4));
      const int j = (e % (kTile / 4)) * 4;
      float4 p[kMaxCluster];             // every load in flight at once
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C) {
          p[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(sPart, q) + i * kLDP + j);
        }
      }
      float4 s = p[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q) {
        if (q < C) {
          s.x += p[q].x;
          s.y += p[q].y;
          s.z += p[q].z;
          s.w += p[q].w;
        }
      }
      float d[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = kDW ? s0 + j + u : r0 + i;     // row of x
        const int v = kDW ? r0 + i : s0 + j + u;     // vocab column
        const int k = kDW ? j + u : i;               // its scalars
        float dd = 0.f;
        if (n < N && v < V) {
          const float p = exp2f((d[u] - sLse[k]) * fm::kLog2e);
          const float hot = static_cast<long long>(v) == sLab[k] ? 1.f : 0.f;
          dd = (p - hot) * sG[k];
        }
        d[u] = dd;
      }
      const uint2 packed = make_uint2(fm::pack(d[0], d[1]),
                                      fm::pack(d[2], d[3]));
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C) {
          *reinterpret_cast<uint2*>(cluster.map_shared_rank(sDlg, q) +
                                    i * kLDD + j) = packed;
        }
      }
    }
    cluster.sync();                      // dlg is whole in every CTA

    // 3. acc += dlg [64, 64] . tile [64, 512]: dlg's A fragments from
    // shared memory (ldmatrix), the tile's columns of this warpgroup
    uint32_t a[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      fm::load_a<kTile>(a[kk], sDlg, wr, 16 * kk);
    }
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_64x256_rs(acc, a[kk],
                      gmma_desc(sT + 4 * wg * kBlock + kk * 16 * 128,
                                kBlock, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wr + g8 + 8 * h;
    if (row >= n_res) continue;
    bf16* dst = out + static_cast<long long>(row) * H;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 256 * wg + 8 * j + 2 * tq;
      if (col < H) {                     // H even: col + 1 < H too
        *reinterpret_cast<uint32_t*>(dst + col) =
            fm::pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <bool kDW>
int launch_mma(const void* x, const void* w, const void* labels,
               const void* lse, const void* g, void* out, int N, int V,
               int H, cudaStream_t stream) {
  const int C = (H + kSlice - 1) / kSlice;
  const bool aligned = ((reinterpret_cast<size_t>(x) |
                         reinterpret_cast<size_t>(w) |
                         reinterpret_cast<size_t>(out)) & 15) == 0;
  if (H % 8 != 0 || C > kMaxCluster || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;   // once, before any CUDA-graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        lce_bwd_mma_kernel<kDW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((kDW ? V : N) + kRes - 1) / kRes * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kMmaSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, lce_bwd_mma_kernel<kDW>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<const long long*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<bf16*>(out), N, V, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDW>
int dispatch(const void* x, const void* w, const void* labels,
             const void* lse, const void* g, void* out, int N, int V, int H,
             int bf16, void* stream) {
  if (N <= 0 || V <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_mma<kDW>(x, w, labels, lse, g, out, N, V, H, s);
  }
  const int vec = H % 8 == 0 &&
                  ((reinterpret_cast<size_t>(x) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  return launch_simt<kDW>(x, w, labels, lse, g, out, N, V, H, vec, s);
}

}  // namespace

// C entry points, bound with ctypes. x [N, H] and w [V, H] contiguous in
// one type (bf16 = 1 for bfloat16, 0 for fp32), labels [N] int64, lse and g
// [N] fp32; dx [N, H] or dw [V, H] contiguous in the operand type. bf16
// takes H % 8 == 0, H <= 4096 and 16-byte aligned x, w and output (the
// wrapper pads or copies); fp32 takes any H up to its shared-memory limit.
// Each launches on `stream` and does not synchronise, and returns
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

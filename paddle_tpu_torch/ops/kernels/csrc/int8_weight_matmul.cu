// int8-weight matmul for Hopper (sm_90a): out = (x @ float(w_q)) * scale.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py `_mm_kernel` (launched
// by `_int8_weight_matmul_pallas`), the TPU kernel behind
// `int8_weight_matmul`. Same math:
//     out[m, n] = scale[n] * sum_k x[m, k] * float(w_q[k, n])
// with x fp32 [M, K], w_q int8 [K, N] (the `[in, out]` layout of
// paddle_tpu_torch/quant/ptq.py), scale fp32 [N] (one per output channel,
// constant along k, so it is applied once after the accumulate), out fp32.
//
// What bounds it: at decode shapes (M = batch rung, 1-8) bytes -- the int8
// weight is read once (K * N bytes) and each weight byte feeds only M
// multiply-adds. At prefill shapes (M = the prompt's rows, up to ~1000)
// operations. There the tensor cores take the product without changing
// the function, by an exact split of x:
//   * every int8 code is exact in bf16 (|q| <= 128 needs 8 significant
//     bits);
//   * x = b0 + b1 + b2 exactly: b0 = x with its low 16 bits cleared (x
//     cut to bf16: its top 8 significant bits), b1 = x - b0 cut likewise
//     (x - b0 is exact in fp32 and has at most 16 significant bits), b2 =
//     x - b0 - b1 (exact, at most 8 significant bits left, so a bf16);
//     three bf16 pieces carry fp32's 24 significant bits;
//   * each product bi * q is exact in fp32, and the sums are fp32.
// Cutting rather than rounding to bf16 (b0 = bf16_rn(x), ...) splits as
// exactly and needs no conversion instruction, which measured faster on
// the H100.
// So three bf16 products with fp32 sums give the fp32 function to within
// fp32 rounding: no quantization of x, no TF32. Their bound is 3 x 2 MKN
// flops at 989 TFLOP/s (0.264 ms for the 48 block matmuls of GPT-2 124M at
// M = 512, against 1.299 ms for 2 MKN at the 67 TFLOP/s of the CUDA cores).
//
// Design. The Pallas kernel holds all of x, w and out in VMEM as one block
// (no grid). Here two kernels cover the two regimes; both run the three
// bf16 products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 sums) and scale once at the end.
//   * M <= 8 (decode): `int8_gemv_mma_kernel`, bound by the weight's bytes
//     (0.027 ms for the 48 block matmuls of a GPT-2 124M step at 3.35
//     TB/s). Its CUDA-core predecessor (one CTA a strip of 16 or 32
//     columns, 4-byte weight loads, 8 rows of fp32 FMAs whatever M) took
//     14.6x that: 48 to 96 CTAs on 132 SMs, 160 registers a thread, about
//     8 KB of weight in flight an SM, and 679 M FMAs a step, 20 us of the
//     card's whole CUDA-core rate. At these sizes (0.6 to 2.4 MB a launch)
//     a launch is a chain of latencies more than a stream of bytes; here:
//       - a thread-block cluster of S <= 8 CTAs splits K for one strip of
//         16, 32 or 64 columns (the widest that still gives 264 CTAs, two
//         an SM; S as many as that takes): 288 CTAs at each of the step's
//         four shapes. CTA r takes K range r; one thread issues TMA
//         boxes for the whole range at once (up to 256 rows of the strip's
//         codes a box, in TMA's 32- or 64-byte swizzle, and x as one 3-D
//         box already in the operands' layout; tensor maps cached by
//         pointer), so the whole weight is in flight together and no
//         thread spends instructions or request slots on the copies
//         (16-byte cp.async copies issued by every thread, and TMA boxes of
//         one 16-column block by one k step, measured slower on the H100);
//       - its four warps each own 16 columns and a part of the range (four
//         k parts of one 16-column strip, or one part of four 16-column
//         strips); per 16-deep step a warp's lanes read two 4-byte words
//         of codes (rows g and g + 8, columns 4 tq .. 4 tq + 3), convert
//         them to bf16 (exact), and `movmatrix.trans` turns the four 8 x 8
//         k-major pieces into the A fragment of w^T (16 columns by 16 k:
//         the mma's rows are the columns of out, permuted); x is the B
//         operand (16 k by 8 rows: M <= 8 needs no padding), cut into its
//         three bf16 pieces (split3) as it is read; one accumulator per
//         piece, so the products of four steps run as three independent
//         chains, added b2 + b1 + b0 at the end;
//       - each CTA adds its warps' partials in k-part order and pushes its
//         [M, strip] partial into CTA 0 through distributed shared memory,
//         one mbarrier arrival a CTA (CTA 0 pulling the partials after a
//         cluster barrier measured slower); CTA 0 adds them in rank
//         order, scales and writes. One launch, no workspace, no atomics:
//         two calls give the same bits, and the launch depends on (M, N,
//         K) alone (`gemv_plan`, mirrored by ops/kernels/quant_matmul.py
//         `gemv_geometry`), so a CUDA graph can hold it.
//   * M > 8 (prefill): `int8_mma_kernel`, mma.sync m16n8k16 (bf16
//     operands, fp32 sums). A CTA of four warps owns a 64 x 64 tile of out
//     (each warp 32 x 32) and walks its K range in 32-deep steps. Each
//     step's x tile [64, 32] (fp32) and w tile [32, 64] (int8) are loaded
//     into registers one step ahead, then split and converted once as
//     they are stored to shared memory: x into its three bf16 pieces
//     (three A tiles), w's codes into bf16 (the B tile, read N-major by
//     ldmatrix.trans, as the flash kernels read V). Per 16-deep k slice a
//     warp runs acc += b2.q, acc += b1.q, acc += b0.q, smallest first; the
//     B fragments serve all three pieces. Two shared-memory buffers, one
//     barrier a step. Padded rows (40 and 72 bf16) keep ldmatrix free of
//     bank conflicts. Measured alternatives that were no faster: 64 x 128
//     tiles, loads two steps ahead, a deeper split of K.
//     Filling 132 SMs: at M = 512 the step's four shapes (N = 768, 2304,
//     3072; K = 768 or 3072) give 96, 288 or 384 tiles. Where the tiles
//     are fewer than two per SM, K is split into S contiguous ranges of at
//     least 256 (S = ceil(2 SMs / tiles), 3 for both N = 768 shapes: 288
//     CTAs); each range's unscaled [M, N] partial goes to a workspace [S,
//     M, N] that the wrapper allocates, and a second kernel sums the
//     partials in range order and scales them. Fixed orders, no atomics:
//     two calls give the same bits.
// Ragged edges (M, N, K not multiples of the tile) are zero-filled in the
// staged tiles. Operands not aligned for vector loads or TMA (K % 4, N %
// 16, or a base off 16 bytes) take the same kernels with scalar,
// bounds-checked loads, so the wrapper copies nothing.

#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>

#include "flash_attention_mma.cuh"
#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
namespace fm = flash_mma;
using fm::bf16;

constexpr int kPieces = 3;                // bf16 pieces of x

// The 4 int8 codes of `word` as exact floats: XOR 0x80 turns code c into
// the byte c + 128, a byte permute sets it under the exponent of 2^23,
// and subtracting 2^23 + 128 leaves c.
__device__ __forceinline__ void s8x4_to_f32(unsigned word, float (&f)[4]) {
  const unsigned u = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  }
}

// x's three bf16 pieces, as floats: b0 = x with its low 16 bits cleared
// (x's top 8 significant bits), b1 = x - b0 likewise, b2 = x - b0 - b1 (at
// most 8 significant bits are left); the differences are exact in fp32
__device__ __forceinline__ void split3(float x, float (&b)[kPieces]) {
  b[0] = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
  const float r1 = x - b[0];
  b[1] = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
  b[2] = r1 - b[1];
}

// ------------------------------------------------ M <= 8: the decode GEMV

constexpr int kGemvM = 8;                 // rows of x it takes: the mma's n
constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvMaxSplit = 8;          // CTAs a cluster: the portable size
constexpr int kGemvTargetCtas = 264;      // two CTAs on each of 132 SMs
constexpr int kGemvMaxStrip = 64;         // columns of out a CTA owns, at most
constexpr int kStep = 16;                 // k of one mma
constexpr int kXStepBytes = kGemvM * 16 * 4;    // a step's box of x
constexpr int kBoxAlign = 1024;           // boxes start on the swizzle's span

// The GEMV's launch for an [M <= 8, K] x [K, N] product: a function of N
// and K alone (ops/kernels/quant_matmul.py `gemv_geometry` mirrors it).
// A pass stages `wrows` k rows of the strip's codes ([wrows][strip] bytes,
// TMA boxes of up to 256 rows) and `pass` steps of x ([pass][8][16]
// floats).
struct GemvPlan {
  int strip;      // columns of out a CTA owns: 16, 32 or 64 (16 a warp)
  int strips;     // ceil(N / strip): grid y
  int split;      // CTAs of a cluster, one K range each: grid x
  int chunk;      // 16-deep k steps of a K range
  int pass;       // k steps staged in shared memory at once
  int box_rows;   // k rows of a weight box
  int wrows;      // k rows of the staged weight: whole boxes
  int smem;       // dynamic shared memory bytes
};

inline GemvPlan gemv_plan(int N, int K) {
  GemvPlan p;
  const int steps = (K + kStep - 1) / kStep;
  p.strip = 16;                   // the widest strip that keeps 264 CTAs
  for (int w = kGemvMaxStrip; w > 16; w /= 2) {
    if ((N + w - 1) / w * kGemvMaxSplit >= kGemvTargetCtas) {
      p.strip = w;
      break;
    }
  }
  p.strips = (N + p.strip - 1) / p.strip;
  p.split = (kGemvTargetCtas + p.strips - 1) / p.strips;
  if (p.split > kGemvMaxSplit) p.split = kGemvMaxSplit;
  if (p.split > steps) p.split = steps;
  p.chunk = (steps + p.split - 1) / p.split;
  // a pass's boxes stay within 48 KB beside the static arrays
  const int most = p.strip == 16 ? 32 : 16;
  p.pass = p.chunk < most ? p.chunk : most;
  p.box_rows = p.pass * kStep < 256 ? p.pass * kStep : 256;
  p.wrows = (p.pass * kStep + p.box_rows - 1) / p.box_rows * p.box_rows;
  p.smem = p.wrows * p.strip + p.pass * kXStepBytes + kBoxAlign;
  return p;
}

// d = the 8 x 8 bf16 matrix of a (one pair a lane, row lane / 4, columns
// 2 (lane % 4), + 1), transposed, in the same layout
__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// Byte offset of code (row, column) in the staged weight [rows][strip]:
// TMA's 32- and 64-byte swizzles (strip 32 and 64) move the 16-byte chunk
// of a row to chunk ^ (row / 4 mod 2) and chunk ^ (row / 2 mod 4), so the
// eight rows a warp reads at once lie on distinct banks.
__device__ __forceinline__ int wbyte(int row, int col, int strip) {
  const int chunk = col >> 4;
  const int sw = strip == 64 ? (row >> 1) & 3 : strip == 32 ? (row >> 2) & 1
                                                            : 0;
  return row * strip + ((chunk ^ sw) << 4) + (col & 15);
}

// One warp, one 16-deep k step, its 16 columns: the operands of the step's
// three products w^T . x^T on the tensor cores. `ws` is the staged weight
// ([rows][strip], swizzled), `row0` the step's first row in it, `col0`
// the warp's first column; `xt` the step's box of x ([8 rows][16 k]).
//   A = w^T [16 columns, 16 k]: lane (g, tq) reads columns 4 tq .. 4 tq + 3
//   of rows g and g + 8 as two words and converts them to bf16 pairs (the
//   pair of columns 4 tq, + 1 and the pair 4 tq + 2, + 3). Those are four
//   8 x 8 matrices, k by column; transposed, each is one register of the
//   A fragment. So mma row r < 8 is column 4 (r / 2) + r % 2 of the warp's
//   16, and row 8 + r is column 4 (r / 2) + 2 + r % 2.
//   B = x^T [16 k, 8 rows]: lane (g, tq) holds x[g][2 tq, + 1] and
//   x[g][8 + 2 tq, + 1], cut into three bf16 pieces b[q]; rows g >= M are 0.
__device__ __forceinline__ void gemv_operands(uint32_t (&a)[4],
                                              uint32_t (&b)[kPieces][2],
                                              const int8_t* ws, int strip,
                                              int row0, int col0,
                                              const float* xt, int M) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const unsigned lo = *reinterpret_cast<const unsigned*>(
      ws + wbyte(row0 + g, col0 + 4 * tq, strip));
  const unsigned hi = *reinterpret_cast<const unsigned*>(
      ws + wbyte(row0 + g + 8, col0 + 4 * tq, strip));
  float f[4];
  s8x4_to_f32(lo, f);                     // codes are exact in bf16
  a[0] = transpose8x8(fm::pack(f[0], f[1]));   // mma rows 0-7, k 0-7
  a[1] = transpose8x8(fm::pack(f[2], f[3]));   // rows 8-15, k 0-7
  s8x4_to_f32(hi, f);
  a[2] = transpose8x8(fm::pack(f[0], f[1]));   // rows 0-7, k 8-15
  a[3] = transpose8x8(fm::pack(f[2], f[3]));   // rows 8-15, k 8-15
  if (g < M) {
    const float2 x0 = *reinterpret_cast<const float2*>(xt + 16 * g + 2 * tq);
    const float2 x1 =
        *reinterpret_cast<const float2*>(xt + 16 * g + 8 + 2 * tq);
    float p0[kPieces], p1[kPieces], p2[kPieces], p3[kPieces];
    split3(x0.x, p0);
    split3(x0.y, p1);
    split3(x1.x, p2);
    split3(x1.y, p3);
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      b[q][0] = fm::pack(p0[q], p1[q]);     // the pieces are bf16 values:
      b[q][1] = fm::pack(p2[q], p3[q]);     // packing them is exact
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPieces; ++q) b[q][0] = b[q][1] = 0u;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one 2-D box of a tensor map at (c0, c1) into `dst`, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one 3-D box at (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

constexpr int kGemvBatch = 4;     // k steps whose operands a warp holds at once
constexpr int kGemvOuts = 4;      // neighbouring outputs a thread sums
static_assert(kGemvThreads * kGemvOuts == kGemvM * kGemvMaxStrip,
              "the threads cover a strip's outputs");

// out[M, N] for M <= 8. Grid (split, strips) in clusters of (split, 1, 1):
// CTA (r, s) takes K steps [r chunk, (r + 1) chunk) of columns [s strip,
// (s + 1) strip).
// Staging, a pass at a time: with `vec` (K % 16 == 0, N % 16 == 0, x and w
// 16-byte aligned) one thread issues TMA boxes of up to 256 rows of the
// strip's codes (`wmap`: the [K, N] codes, swizzled as `wbyte` reads them)
// and one box of x (`xmap`: [M, K] fp32 seen as [K / 16][M][16], a box of
// [pass][8][16]); rows past M, K or N read as zeros, and all of it is
// counted on one mbarrier. Else every thread copies bytes and floats into
// the same layout, bounds-checked.
// The sum across the cluster: CTA 0 sets up an mbarrier expecting one
// arrival from each CTA, and every CTA arrives at the cluster barrier
// (relaxed) once its copies are in flight. With its products done, a CTA
// adds its warps' partials in k-part order into its own [M, strip]
// partial, waits at the cluster barrier (CTA 0's mbarrier is set up),
// stores the partial into CTA 0's `gather` slot of its rank (distributed
// shared memory, 16 bytes a store), and one thread arrives at CTA 0's
// mbarrier with release semantics at cluster scope, after the CTA's
// barrier has ordered every thread's store before it; every CTA but 0 then
// exits. CTA 0 waits for all the arrivals, sums the partials in rank order,
// scales (scale read on entry) and writes.
__global__ void __launch_bounds__(kGemvThreads, 4)
int8_gemv_mma_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     float* __restrict__ out, int M, int N, int K,
                     const GemvPlan p, bool vec,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  __shared__ __align__(16) float red[kGemvWarps][kGemvM][16];  // by warp
  // CTA 0: every CTA's partial [M][strip], by rank
  __shared__ __align__(16) float gather[kGemvMaxSplit][kGemvM * kGemvMaxStrip];
  __shared__ __align__(8) uint64_t arrived;    // CTA 0: one arrival a CTA
  __shared__ __align__(8) uint64_t staged;     // a pass's boxes are in
  // the boxes: codes [wrows][strip], then x [pass][8][16]
  unsigned char* base =
      gemv_smem + ((kBoxAlign - (smem_u32(gemv_smem) & (kBoxAlign - 1))) &
                   (kBoxAlign - 1));
  int8_t* ws = reinterpret_cast<int8_t*>(base);
  float* xs = reinterpret_cast<float*>(base + p.wrows * p.strip);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int across = p.strip / 16;        // warps across the strip
  const int parts = kGemvWarps / across;  // k parts of each step range
  const int wcol = warp % across;         // the warp's 16 columns
  const int wk = warp / across;           // and its k part
  const int n0 = blockIdx.y * p.strip;
  const int steps = (K + kStep - 1) / kStep;
  const int s_end = min(steps, (rank + 1) * p.chunk);
  // this thread's outputs: kGemvOuts neighbouring columns of one row
  const int i0 = kGemvOuts * threadIdx.x;
  const bool mine = i0 < M * p.strip;
  const int om = i0 / p.strip;
  const int oc = i0 % p.strip;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&staged)) : "memory");
    // visible to the TMA unit (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float sc[kGemvOuts];                    // CTA 0: its outputs' scales,
  if (rank == 0 && mine) {                // read while the boxes load
#pragma unroll
    for (int e = 0; e < kGemvOuts; ++e) {
      sc[e] = n0 + oc + e < N ? scale[n0 + oc + e] : 0.f;
    }
  }

  // one accumulator per piece of x: three independent chains of products
  float acc[kPieces][4] = {};
  int phase = 0;
  bool joined = false;                    // arrived at the cluster barrier
  for (int ps = rank * p.chunk; ps < s_end; ps += p.pass) {
    const int pn = min(p.pass, s_end - ps);     // k steps this pass
    const int k0 = ps * kStep;
    if (vec) {
      if (threadIdx.x == 0) {
        // whole boxes land (rows past the pass belong to the next range,
        // or lie past K and read as zeros)
        const int boxes = (pn * kStep + p.box_rows - 1) / p.box_rows;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(smem_u32(&staged)),
               "r"(boxes * p.box_rows * p.strip + p.pass * kXStepBytes)
            : "memory");
        for (int b = 0; b < boxes; ++b) {
          tma_load_2d(ws + b * p.box_rows * p.strip, &wmap, &staged, n0,
                      k0 + b * p.box_rows);
        }
        tma_load_3d(xs, &xmap, &staged, 0, 0, ps);
      }
    } else {
      for (int i = threadIdx.x; i < pn * kStep * p.strip; i += kGemvThreads) {
        const int r = i / p.strip;
        const int c = i % p.strip;
        ws[wbyte(r, c, p.strip)] =
            k0 + r < K && n0 + c < N
                ? w[static_cast<long long>(k0 + r) * N + n0 + c]
                : static_cast<int8_t>(0);
      }
      for (int i = threadIdx.x; i < kGemvM * pn * kStep; i += kGemvThreads) {
        const int m = i / (pn * kStep);
        const int c = i % (pn * kStep);
        xs[(c / kStep) * (kXStepBytes / 4) + m * kStep + c % kStep] =
            m < M && k0 + c < K ? x[static_cast<long long>(m) * K + k0 + c]
                                : 0.f;
      }
    }
    if (!joined) {
      // CTA 0's arrival barrier, set up while the first pass loads (by the
      // last warp: thread 0 issues the copies); then this CTA has started,
      // as far as the cluster's barrier is concerned
      if (rank == 0 && threadIdx.x == kGemvThreads - 32) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     :: "r"(smem_u32(&arrived)), "r"(p.split) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      joined = true;
    }
    if (vec) {
      uint32_t done;
      do {
        asm volatile(
            "{\n.reg .pred ok;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 ok, [%1], %2;\n"
            "selp.u32 %0, 1, 0, ok;\n}\n"
            : "=r"(done) : "r"(smem_u32(&staged)), "r"(phase) : "memory");
      } while (!done);
      phase ^= 1;
    } else {
      __syncthreads();                    // the pass is staged
    }
    // this warp's k part of the pass, kGemvBatch steps' operands at a time
    const int per = (pn + parts - 1) / parts;
    const int a1 = min(pn, (wk + 1) * per);
    for (int st = wk * per; st < a1; st += kGemvBatch) {
      uint32_t a[kGemvBatch][4];
      uint32_t b[kGemvBatch][kPieces][2];
#pragma unroll
      for (int j = 0; j < kGemvBatch; ++j) {
        if (st + j < a1) {
          gemv_operands(a[j], b[j], ws, p.strip, (st + j) * kStep, 16 * wcol,
                        xs + (st + j) * (kXStepBytes / 4), M);
        }
      }
#pragma unroll
      for (int j = 0; j < kGemvBatch; ++j) {
        if (st + j < a1) {
#pragma unroll
          for (int q = 0; q < kPieces; ++q) {
            fm::mma(acc[q], a[j], b[j][q][0], b[j][q][1]);
          }
        }
      }
    }
    __syncthreads();                      // the pass's boxes are free
  }
  if (!joined) {                          // no k step: still arrive
    if (rank == 0 && threadIdx.x == kGemvThreads - 32) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&arrived)), "r"(p.split) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // the warp's partial, b2 . q + b1 . q + b0 . q, by [row of x][column]
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int col = 4 * (g >> 1) + (g & 1);     // of mma rows g and g + 8
  red[warp][2 * tq][col] = (acc[2][0] + acc[1][0]) + acc[0][0];
  red[warp][2 * tq + 1][col] = (acc[2][1] + acc[1][1]) + acc[0][1];
  red[warp][2 * tq][col + 2] = (acc[2][2] + acc[1][2]) + acc[0][2];
  red[warp][2 * tq + 1][col + 2] = (acc[2][3] + acc[1][3]) + acc[0][3];
  __syncthreads();
  // the CTA's partial of this thread's outputs: the k parts in order
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mine) {
    for (int q = 0; q < parts; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          &red[q * across + oc / 16][om][oc % 16]);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (mine) {                             // into CTA 0's gather[rank]
    *reinterpret_cast<float4*>(
        cluster.map_shared_rank(&gather[rank][i0], 0)) = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(remote) : "r"(smem_u32(&arrived)));
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
        :: "r"(remote) : "memory");
  }
  if (rank != 0) return;

  if (threadIdx.x == 0) {                 // every CTA's partial is in
    uint32_t done;
    do {
      asm volatile(
          "{\n.reg .pred ok;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 ok, "
          "[%1], 0;\n"
          "selp.u32 %0, 1, 0, ok;\n}\n"
          : "=r"(done) : "r"(smem_u32(&arrived)) : "memory");
    } while (!done);
  }
  __syncthreads();
  if (!mine) return;
  float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < p.split; ++r) {     // rank order
    const float4 v = *reinterpret_cast<const float4*>(&gather[r][i0]);
    total.x += v.x;
    total.y += v.y;
    total.z += v.z;
    total.w += v.w;
  }
  const float t[kGemvOuts] = {total.x, total.y, total.z, total.w};
  float* o = out + static_cast<long long>(om) * N + n0 + oc;
#pragma unroll
  for (int e = 0; e < kGemvOuts; ++e) {
    if (n0 + oc + e < N) o[e] = t[e] * sc[e];
  }
}

// The GEMV's tensor maps, encoded at a pointer's first use and kept: a map
// holds only the pointer, the shape and the box, so it stays right for
// any tensor later found at the same address with the same shape.
struct MapCache {
  struct Entry {
    const void* ptr;
    int M, N, K;
    bool is_x;
    int box0, box1;
    CUtensorMap map;
  };
  static constexpr int kSize = 256;
  Entry e[kSize];
  int used = 0;
  int next = 0;
  std::mutex mu;
};

// The maps of an [M, K] x [K, N] GEMV under plan p: w [K, N] int8 in boxes
// of box_rows rows by `strip` columns, swizzled as `wbyte` reads them; x
// [M, K] fp32 as the 3-D [K / 16][M][16] (steps, rows, k in a step) in
// boxes of [pass][8][16]. What lies outside reads as zeros.
bool gemv_map(CUtensorMap* map, const void* ptr, int M, int N, int K,
              bool is_x, const GemvPlan& p) {
  static MapCache cache;
  const int box0 = is_x ? p.pass : p.strip;
  const int box1 = is_x ? 0 : p.box_rows;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.used; ++i) {
    const MapCache::Entry& c = cache.e[i];
    if (c.ptr == ptr && c.M == M && c.N == N && c.K == K &&
        c.is_x == is_x && c.box0 == box0 && c.box1 == box1) {
      *map = c.map;
      return true;
    }
  }
  tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return false;
  CUresult rc;
  if (is_x) {
    const cuuint64_t dims[3] = {16, static_cast<cuuint64_t>(M),
                                static_cast<cuuint64_t>(K / 16)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * 4, 64};
    const cuuint32_t boxes[3] = {16, kGemvM, static_cast<cuuint32_t>(box0)};
    const cuuint32_t unit[3] = {1, 1, 1};
    rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, boxes, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box0),
                                 static_cast<cuuint32_t>(box1)};
    const cuuint32_t unit[2] = {1, 1};
    rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box0 == 64   ? CU_TENSOR_MAP_SWIZZLE_64B
                : box0 == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (rc != CUDA_SUCCESS) return false;
  MapCache::Entry& c = cache.e[cache.next];
  c = {ptr, M, N, K, is_x, box0, box1, *map};
  cache.next = (cache.next + 1) % MapCache::kSize;
  if (cache.used < MapCache::kSize) ++cache.used;
  return true;
}

int launch_gemv(const float* x, const int8_t* w, const float* scale,
                float* out, int M, int N, int K, bool vec,
                cudaStream_t stream) {
  const GemvPlan p = gemv_plan(N, K);
  if (p.strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap = {}, xmap = {};
  if (vec && !(gemv_map(&wmap, w, M, N, K, false, p) &&
               gemv_map(&xmap, x, M, N, K, true, p))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, p.strips, 1);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, int8_gemv_mma_kernel, x, w, scale, out, M, N,
                         K, p, vec, wmap, xmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ M > 8: tensor cores

constexpr int kBM = 64;                   // rows of out per CTA
constexpr int kBN = 64;                   // columns of out per CTA
constexpr int kBK = 32;                   // k per step
constexpr int kWarpsN = kBN / 32;         // warps across; 2 down, 32 x 32 each
constexpr int kMmaThreads = 64 * kWarpsN;
constexpr int kXLoads = kBM * kBK / 4 / kMmaThreads;   // float4s a thread
constexpr int kLDA = fm::Tile<kBK>::LD;   // 40: padded bf16 row of a piece
constexpr int kLDB = fm::Tile<kBN>::LD;   // 72: padded bf16 row of w's tile
constexpr int kSplitMinK = 256;           // least K range of a split
static_assert(kBK * kBN / 16 == kMmaThreads, "one 16-byte w load a thread");

// One k step's operands in registers: x rows (e / 8), columns 4 (e % 8) ..
// + 4 of the step for e = tid + i threads; w row tid / (kBN / 16),
// columns 16 (tid % (kBN / 16)) .. + 16 of the tile, as 16 int8 codes.
// Zeros outside [M, K] and [K, N].
template <bool VEC>
__device__ __forceinline__ void load_step(float (&xr)[kXLoads][4], uint4& wr,
                                          const float* x, const int8_t* w,
                                          int M, int N, int K, int m0,
                                          int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int gm = m0 + (e >> 3);
    const int gk = k0 + (e & 7) * 4;
    const float* p = x + static_cast<long long>(gm) * K + gk;
    if (VEC) {                           // K % 4 == 0: all 4 in range
      const float4 v = gm < M && gk < K
                           ? __ldg(reinterpret_cast<const float4*>(p))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xr[i][0] = v.x;
      xr[i][1] = v.y;
      xr[i][2] = v.z;
      xr[i][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xr[i][e] = gm < M && gk + e < K ? p[e] : 0.f;
      }
    }
  }
  const int gk = k0 + tid / (kBN / 16);
  const int gn = n0 + tid % (kBN / 16) * 16;
  const int8_t* p = w + static_cast<long long>(gk) * N + gn;
  if (VEC) {                             // N % 16 == 0: all 16 in range
    wr = gk < K && gn < N ? __ldg(reinterpret_cast<const uint4*>(p))
                          : make_uint4(0u, 0u, 0u, 0u);
  } else {
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const unsigned b = gk < K && gn + e < N
                             ? static_cast<unsigned char>(p[e]) : 0u;
      word[e / 4] |= b << (8 * (e % 4));
    }
    wr = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// The staged step into shared memory: x split into its three bf16 pieces,
// w's codes as bf16 (exact).
__device__ __forceinline__ void store_step(bf16 (&sA)[kPieces][kBM * kLDA],
                                           bf16 (&sB)[kBK * kLDB],
                                           const float (&xr)[kXLoads][4],
                                           const uint4& wr) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXLoads; ++i) {
    float b[4][kPieces];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(xr[i][e], b[e]);
    const int t = tid + i * kMmaThreads;
    const int off = (t >> 3) * kLDA + (t & 7) * 4;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      *reinterpret_cast<uint2*>(&sA[q][off]) =
          make_uint2(fm::pack(b[0][q], b[1][q]), fm::pack(b[2][q], b[3][q]));
    }
  }
  const unsigned words[4] = {wr.x, wr.y, wr.z, wr.w};
  uint32_t packed[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
    s8x4_to_f32(words[j], f);
    packed[2 * j] = fm::pack(f[0], f[1]);
    packed[2 * j + 1] = fm::pack(f[2], f[3]);
  }
  uint4* dst = reinterpret_cast<uint4*>(
      &sB[tid / (kBN / 16) * kLDB + tid % (kBN / 16) * 16]);
  dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// acc += x . w over one k step of the staged tiles: every fragment of the
// step is loaded first (the loads and products are ordered asm), then per
// 16-deep slice the pieces b2, b1, b0 (smallest first) against the same B
// fragments
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4],
                                         const bf16 (&sA)[kPieces][kBM * kLDA],
                                         const bf16 (&sB)[kBK * kLDB],
                                         int wm, int wn) {
  constexpr int KK = kBK / 16;
  uint32_t b[KK][2][4];
  uint32_t a[KK][kPieces][2][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    fm::load_b_kn<kBN>(b[kk][0], sB, 16 * kk, wn);
    fm::load_b_kn<kBN>(b[kk][1], sB, 16 * kk, wn + 16);
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      fm::load_a<kBK>(a[kk][q][0], sA[q], wm, 16 * kk);
      fm::load_a<kBK>(a[kk][q][1], sA[q], wm + 16, 16 * kk);
    }
  }
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int q = kPieces - 1; q >= 0; --q) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          fm::mma(acc[mt][2 * nb], a[kk][q][mt], b[kk][nb][0], b[kk][nb][1]);
          fm::mma(acc[mt][2 * nb + 1], a[kk][q][mt], b[kk][nb][2],
                  b[kk][nb][3]);
        }
      }
    }
  }
}

// out (part == nullptr) or the partial of K range blockIdx.z (part [S, M,
// N], unscaled) of one 64 x 64 tile; K range z is [z kchunk, (z + 1)
// kchunk).
template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
int8_mma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ part, int M, int N, int K, int kchunk) {
  __shared__ __align__(16) bf16 sA[2][kPieces][kBM * kLDA];
  __shared__ __align__(16) bf16 sB[2][kBK * kLDB];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN * 32;      // the warp's rows of the tile
  const int wn = warp % kWarpsN * 32;      // and columns
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int nk = (min(K, kbeg + kchunk) - kbeg + kBK - 1) / kBK;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // step kt + 1 is loaded into registers while step kt's products run
  float xr[kXLoads][4];
  uint4 wr;
  if (nk > 0) {
    load_step<VEC>(xr, wr, x, w, M, N, K, m0, n0, kbeg);
    store_step(sA[0], sB[0], xr, wr);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_step<VEC>(xr, wr, x, w, M, N, K, m0, n0, kbeg + (kt + 1) * kBK);
    }
    mma_step(acc, sA[buf], sB[buf], wm, wn);
    if (kt + 1 < nk) store_step(sA[buf ^ 1], sB[buf ^ 1], xr, wr);
    __syncthreads();        // buffer buf is free; buf ^ 1 holds step kt + 1
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  float* dst = part ? part + static_cast<long long>(blockIdx.z) * M * N
                    : out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * tq;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float s0 = part ? 1.f : scale[col];
      const float s1 = part || !two ? 1.f : scale[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mt + g + 8 * h;
        if (row >= M) continue;
        float* o = dst + static_cast<long long>(row) * N + col;
        const float v0 = acc[mt][nt][2 * h] * s0;
        const float v1 = acc[mt][nt][2 * h + 1] * s1;
        if (VEC) {                         // N % 16 == 0: col + 1 < N
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

// out = (part[0] + part[1] + ... + part[S - 1]) * scale, in range order
__global__ void int8_splitk_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out,
                                          long long MN, int N, int S) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int z = 1; z < S; ++z) sum += part[z * MN + i];
    out[i] = sum * scale[i % N];
  }
}

// K ranges for an [M, N] out: 1 when the 64 x 64 tiles are at least two
// per SM, else enough to reach two CTAs per SM, each range at least
// kSplitMinK deep.
int split_k(int M, int N, int K) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + kBN - 1) / kBN);
  const long long want = 2LL * sms;
  if (tiles >= want) return 1;
  const long long most = K / kSplitMinK > 1 ? K / kSplitMinK : 1;
  const long long s = (want + tiles - 1) / tiles;
  return static_cast<int>(s < most ? s : most);
}

int launch_mma(const float* x, const int8_t* w, const float* scale,
               float* out, float* workspace, int M, int N, int K, bool vec,
               cudaStream_t stream) {
  const int S = split_k(M, N, K);
  if (S > 1 && workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int steps = (K + kBK - 1) / kBK;
  const int kchunk = (steps + S - 1) / S * kBK;
  float* part = S > 1 ? workspace : nullptr;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
  if (vec) {
    int8_mma_kernel<true><<<grid, kMmaThreads, 0, stream>>>(
        x, w, scale, out, part, M, N, K, kchunk);
  } else {
    int8_mma_kernel<false><<<grid, kMmaThreads, 0, stream>>>(
        x, w, scale, out, part, M, N, K, kchunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long blocks = (MN + 255) / 256;
  int8_splitk_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks
                                                              : 4096),
                              256, 0, stream>>>(workspace, scale, out, MN, N,
                                                S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace `int8_weight_matmul_f32` needs for an [M, K] x [K, N]
// product on the current device: S M N when the M > 8 kernel splits K into
// S ranges, else 0.
extern "C" long long int8_weight_matmul_workspace(int M, int N, int K) {
  if (M <= kGemvM || N <= 0 || K <= 0) return 0;
  const int S = split_k(M, N, K);
  return S > 1 ? static_cast<long long>(S) * M * N : 0;
}

// The GEMV's launch for an [M <= 8, K] x [K, N] product into out[0..7]:
// grid x (the split of K), grid y (the strips), cluster x, threads,
// dynamic shared memory bytes, columns of a strip, 16-deep k steps of a K
// range, k steps of a pass; for the checks of chip_smoke.py against
// quant_matmul.py `gemv_geometry`. 0, or cudaErrorInvalidValue for shapes
// the GEMV does not take.
extern "C" int int8_gemv_geometry(int M, int N, int K, int* out) {
  if (M <= 0 || M > kGemvM || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemvPlan p = gemv_plan(N, K);
  if (p.strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int v[8] = {p.split, p.strips, p.split, kGemvThreads, p.smem,
                    p.strip, p.chunk, p.pass};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// C entry point, bound with ctypes. x fp32 [M, K], w int8 [K, N], scale
// fp32 [N], out fp32 [M, N], all contiguous; workspace fp32 of
// `int8_weight_matmul_workspace(M, N, K)` floats (null when that is 0).
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int int8_weight_matmul_f32(const void* x, const void* w,
                                      const void* scale, void* out,
                                      void* workspace, int M, int N, int K,
                                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kGemvM) {
    const bool vec16 = (K % 16 == 0) && (N % 16 == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w)) % 16 == 0);
    return launch_gemv(xf, wq, sf, of, M, N, K, vec16, s);
  }
  const bool vec = (K % 4 == 0) && (N % 16 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(workspace)) % 16 == 0);
  return launch_mma(xf, wq, sf, of, static_cast<float*>(workspace), M, N, K,
                    vec, s);
}

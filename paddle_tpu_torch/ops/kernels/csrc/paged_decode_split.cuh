// Split-KV ("flash-decoding") decode attention for Hopper (sm_90a): the
// device template behind paged_decode_attention.cu (fp32 pages),
// paged_decode_attention_int8.cu (int8 codes with one fp32 scale per
// (page, row, head)) and decode_attention.cu (a contiguous fp32 cache).
// All compute softmax(q.k / sqrt(D)) . v over the rows [0, len) of
// sequence b. Two things vary, each a template parameter:
//   * the row type R (F32Rows, I8Rows): how a row's pair of elements
//     becomes floats, and whether scales ride beside the rows;
//   * the row address A (PagedRows, ContiguousRows): where row t of
//     sequence b lives. Paged: at page tables[b, t / pt], offset t % pt,
//     the CTA's table entries staged in shared memory first. Contiguous:
//     row t of the [B, cap, H, D] cache, index (b cap + t) H + h, with no
//     table and no dynamic shared memory.
//
// Why split. One CTA per (b, h) leaves the time to the longest sequence:
// at B = 8, H = 12 that is 96 CTAs on 132 SMs, and the CTA of the longest
// sequence walks its rows alone long after the others have finished. Here
// each (b, h) is a thread-block cluster of kSplit CTAs, grid (kSplit, H,
// B), and CTA r of the cluster takes rows [r len / kSplit, (r + 1) len /
// kSplit).
//
// Per CTA:
//   1. (paged) its range's block-table entries (at most as many as
//      launch_shape sizes the dynamic shared memory for) go to shared
//      memory once, so no row copy waits on a table load;
//   2. its kWarps warps take the range's chunks of kRows rows in turn
//      (chunk c to warp c mod kWarps); each warp streams its chunks through
//      its own ring of kStages stages by cp.async, kStages - 1 chunks in
//      flight while it computes one. Every row's address is known without
//      a load, so every copy issues at once; the warp reads back only what
//      it copied, so the rings need no block barrier, only
//      cp.async.wait_group and __syncwarp;
//   3. each warp keeps its own online softmax (max, denominator,
//      accumulator) in fp32 registers, lane p holding the pairs p and
//      p + 32 of the head dim. A chunk's kRows dot products are summed
//      across the lanes together (sum_rows: a shuffle a row, not five), so
//      each row's score and weight end in the lanes of one row group and
//      the exponent runs once a row; the weights reach every lane by one
//      shuffle a row. The warps merge in shared memory into the CTA's
//      partial state (m, l, acc[D]).
// Then a cluster barrier, and CTA 0 reads the kSplit partial states through
// distributed shared memory in rank order and writes
// o = sum_r acc_r e^(m_r - M) / sum_r l_r e^(m_r - M), M = max_r m_r. A CTA
// whose range is empty (len < kSplit) arrives with m = -1e30 and l = 0 and
// drops out through e^(-1e30 - M) = 0. Nothing is atomic and every sum runs
// in a fixed order, so two calls give the same bits. A second cluster
// barrier keeps every CTA's shared memory alive until CTA 0 has read it.
//
// Lengths. Paged: clamped to [1, W pt]. Contiguous: clamped to [0, cap],
// and a length of 0 makes every one of the cap rows live with the same
// score -1e30 (the plain version masks them all, so its softmax is
// uniform): p = e^0 = 1 a row, every warp and CTA arrives with m = -1e30,
// the merge weighs them all e^0 = 1, and o is the mean of v's cap rows.
//
// Measured on the H100 (PERF.md): per-row instructions, not bytes, set
// the time of the first version (one shuffle chain and one exponent a row
// in every lane, a copy loop of a dozen instructions a row); shared memory
// sets how many CTAs an SM holds, and three stages of 2 KB beat four.
//
// The launch depends on the static shapes alone (launch_shape: B, H, D
// and the row address's pt, W or cap): the lengths are read and clamped on
// the device, so a CUDA graph captured once stays right when the lengths
// (and tables) change in place. ops/kernels/decode_attention.py
// `split_geometry` and `contig_split_geometry` mirror launch_shape and
// stage_rows, and its tests emulate this arithmetic on the CPU.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_split {

namespace cg = cooperative_groups;

constexpr int kSplit = 8;           // CTAs per (b, h): the portable cluster
constexpr int kWarps = 4;           // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;          // one warp's cp.async ring
constexpr int kStageBytes = 2048;   // one warp's stage of K and V rows
constexpr int kMaxD = 128;          // two pairs a lane
constexpr int kMaxTableBytes = 8192;   // dynamic shared memory for the table
constexpr float kNegInf = -1e30f;   // paddle_tpu/ops/pallas/_common.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads >= kMaxD, "the merges take one thread a column");

// rows of one warp's stage: K and V rows of the longest head dim the
// instantiation takes (64 * pairs elements of `elem` bytes)
__host__ __device__ constexpr int stage_rows(int elem, int pairs) {
  return kStageBytes / (2 * 64 * pairs * elem);
}

// int8 code -> float, exactly: 2^23 + (c + 128) has c + 128 in the
// mantissa, so subtracting 2^23 + 128 leaves c. An integer add and an fp32
// subtract, cheaper than the integer-to-float conversion instruction.
__device__ __forceinline__ float s8_to_f32(signed char c) {
  return __int_as_float(0x4B000000 + (static_cast<int>(c) + 128)) -
         8388736.f;
}

// fp32 pages: a row of one head is D floats
struct F32Rows {
  using T = float;
  static constexpr bool kScaled = false;
  __device__ static float2 pair(const T* row, int p) {
    return reinterpret_cast<const float2*>(row)[p];
  }
};

// int8 pages: D codes a row, one fp32 scale per (page, row, head) beside
struct I8Rows {
  using T = signed char;
  static constexpr bool kScaled = true;
  __device__ static float2 pair(const T* row, int p) {
    const char2 c = reinterpret_cast<const char2*>(row)[p];
    return make_float2(s8_to_f32(c.x), s8_to_f32(c.y));
  }
};

// Row t of sequence b in a paged pool [P, pt, H, D]: page tables[b, t /
// pt], offset t % pt. A CTA stages the table entries of its rows in
// dynamic shared memory first. Lengths clamp to [1, W pt].
struct PagedRows {
  static constexpr bool kEmptyIsUniform = false;
  const int* tables;              // [B, W]
  int pt, W;

  __host__ __device__ int capacity() const { return W * pt; }

  // the dynamic shared memory for the most table entries a CTA stages;
  // false when they do not fit
  bool smem_bytes(int* bytes) const {
    if (pt <= 0 || W <= 0 || static_cast<long long>(W) * pt > (1LL << 30)) {
      return false;
    }
    const long long rows = (static_cast<long long>(W) * pt + kSplit - 1) /
                           kSplit;             // most rows a CTA takes
    const long long slots = (rows + pt - 1) / pt + 1;
    if (4 * slots > kMaxTableBytes) return false;
    *bytes = static_cast<int>(4 * slots);
    return true;
  }

  // one CTA's rows: row t's index in the pool's [P pt] rows of one head
  struct Cta {
    const int* tbl;
    int pg0, pt;
    __device__ long long operator()(int t) const {
      return static_cast<long long>(tbl[t / pt - pg0]) * pt + t % pt;
    }
  };

  // stage the table entries of rows [r0, r1) of sequence b into `smem`
  // (all threads call it; the caller's __syncthreads completes it)
  __device__ Cta stage(int b, int r0, int r1, int* smem) const {
    const int pg0 = r0 / pt;
    if (r1 > r0) {
      const int* src = tables + static_cast<long long>(b) * W + pg0;
      const int npg = (r1 - 1) / pt - pg0 + 1;
      for (int i = threadIdx.x; i < npg; i += kThreads) smem[i] = src[i];
    }
    return Cta{smem, pg0, pt};
  }
};

// Row t of sequence b in a contiguous cache [B, cap, H, D]: row b cap + t
// of one head. Nothing to stage. Lengths clamp to [0, cap], and 0 makes
// every row live with the same score (the plain version's uniform
// softmax over a fully masked sequence).
struct ContiguousRows {
  static constexpr bool kEmptyIsUniform = true;
  int cap;

  __host__ __device__ int capacity() const { return cap; }

  bool smem_bytes(int* bytes) const {
    if (cap <= 0 || cap > (1 << 30)) return false;
    *bytes = 0;
    return true;
  }

  struct Cta {
    long long base;                 // b cap
    __device__ long long operator()(int t) const { return base + t; }
  };

  __device__ Cta stage(int b, int, int, int*) const {
    return Cta{static_cast<long long>(b) * cap};
  }
};

template <class R, class A>
struct Args {
  const float* q;                 // [B, H, D]
  const typename R::T* k;         // [P, pt, H, D] or [B, cap, H, D]
  const typename R::T* v;
  const float* k_scale;           // [P, pt, H]; int8 only
  const float* v_scale;
  const int* lengths;             // [B]
  float* out;                     // [B, H, D]
  A rows;                         // where row t of sequence b lives
  int H, D;
  int vec;                        // bytes per copy: 16, 8, 4 (cp.async), 2, 1
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `vec` bytes global -> shared; 16, 8 and 4 by cp.async, 2 and 1 (int8 rows
// of D = 2 mod 4, or a pool at an odd offset) by a plain load and store,
// which the warp's __syncwarp orders like a finished cp.async
__device__ __forceinline__ void copy_unit(void* dst, const void* src,
                                          int vec) {
  switch (vec) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(dst)), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(smem_addr(dst)), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(dst)), "l"(src) : "memory");
      break;
    case 2:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
      break;
    default:
      *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// How one warp copies a row of one head: its K and V bytes are `units`
// copies of `vec` bytes. With units <= 32 the warp copies rows_per_pass =
// 32 / units rows at a time, lane l taking unit l % units of row
// l / units; with more, one row at a time, lane l taking units l, l + 32,
// ... The same in every stage, so the kernel works it out once.
struct CopyPlan {
  int row_bytes;   // D * sizeof(T)
  int vec;         // bytes a copy
  int nv;          // copies of K (and of V) a row
  int units;       // 2 nv
  int rows_per_pass;
  int sub;         // this lane's row within a pass (idle when >= the above)
  int u0;          // this lane's first unit
};

__device__ __forceinline__ CopyPlan copy_plan(int row_bytes, int vec) {
  const int lane = threadIdx.x & 31;
  CopyPlan c;
  c.row_bytes = row_bytes;
  c.vec = vec;
  c.nv = row_bytes / vec;
  c.units = 2 * c.nv;
  const bool packed = c.units <= 32;
  c.rows_per_pass = packed ? 32 / c.units : 1;
  c.sub = packed ? lane / c.units : 0;
  c.u0 = packed ? lane % c.units : lane;
  return c;
}

// One warp: copy rows [t0, t0 + n) of the sequence (n <= kRows), head h,
// into a stage: K rows to kb, V rows to vb (row i at i * kElems), and for
// int8 their scales to sb[i] and sb[kRows + i]. Lane i < n finds row
// t0 + i through the CTA's row address `at` (paged: the staged table),
// and the warp's lanes then copy the rows' bytes as the plan says.
template <class R, class A, int kRows, int kElems>
__device__ __forceinline__ void issue(const Args<R, A>& a, const CopyPlan& c,
                                      const typename A::Cta& at, int h,
                                      int t0, int n, typename R::T* kb,
                                      typename R::T* vb, float* sb) {
  const int lane = threadIdx.x & 31;
  long long row = 0;                // (row, head) index of row t
  if (lane < n) {
    row = at(t0 + lane) * a.H + h;
    if (R::kScaled) {
      copy_unit(sb + lane, a.k_scale + row, 4);
      copy_unit(sb + kRows + lane, a.v_scale + row, 4);
    }
  }
  constexpr int kRowBytes = kElems * static_cast<int>(sizeof(typename R::T));
  for (int i0 = 0; i0 < n; i0 += c.rows_per_pass) {   // the same in every
    const int i = i0 + c.sub;                          // lane
    const long long ri = __shfl_sync(kFull, row, i & 31);
    if (i < n && c.sub < c.rows_per_pass) {
      for (int u = c.u0; u < c.units; u += 32) {
        const bool is_v = u >= c.nv;
        const int off = (is_v ? u - c.nv : u) * c.vec;
        copy_unit(reinterpret_cast<char*>(is_v ? vb : kb) + i * kRowBytes +
                      off,
                  reinterpret_cast<const char*>(is_v ? a.v : a.k) +
                      ri * c.row_bytes + off,
                  c.vec);
      }
    }
  }
}

// The warp's sums of kRows rows at once: s[i] holds this lane's part of row
// i's sum; on return, every lane holds the whole sum of row
// lane / (32 / kRows). The first log2(kRows) levels halve the rows a lane
// keeps (one shuffle a row in all), the rest sum within each row's lanes.
template <int kRows>
__device__ __forceinline__ float sum_rows(float (&s)[kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int level = 1; level < kRows; level *= 2) {
    const int half = kRows / (2 * level);
    const int off = 16 / level;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? s[i + half] : s[i];
      const float send = upper ? s[i] : s[i + half];
      s[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float x = s[0];
#pragma unroll
  for (int off = 16 / kRows; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

// One warp: fold the n rows of a stage into its online softmax (m, l, acc).
// The lanes of row r = lane / (32 / kRows) hold its score; int8: the score
// is (q . k_code) * k_scale / sqrt(D), and a row's weight p is scaled by
// v_scale before it multiplies v_code; the denominator sums p. With
// `uniform` every row scores -1e30 (a contiguous sequence of length 0).
template <class R, int kPairs, int kRows, int kElems>
__device__ __forceinline__ void consume(const typename R::T* kb,
                                        const typename R::T* vb,
                                        const float* sb, int n, int pairs,
                                        float scale, bool uniform,
                                        const float2 (&qv)[kPairs],
                                        float& m, float& l,
                                        float2 (&acc)[kPairs]) {
  constexpr int kGroup = 32 / kRows;        // lanes that hold one row
  const int lane = threadIdx.x & 31;
  float s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int p = lane + 32 * j;
      if (i < n && p < pairs) {
        const float2 kk = R::pair(kb + i * kElems, p);
        s[i] += kk.x * qv[j].x + kk.y * qv[j].y;
      }
    }
  }
  const int r = lane / kGroup;
  const bool live = r < n;                  // a row past the chunk adds
  float x = sum_rows<kRows>(s);             // nothing
  x = live && !uniform ? (R::kScaled ? x * sb[r] * scale : x * scale)
                       : kNegInf;
  float mx = x;
#pragma unroll
  for (int off = 16; off >= kGroup; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  const float m_new = fmaxf(m, mx);
  const float p = live ? expf(x - m_new) : 0.f;     // uniform: e^0 = 1
  float ps = p;
#pragma unroll
  for (int off = 16; off >= kGroup; off >>= 1) {
    ps += __shfl_xor_sync(kFull, ps, off);
  }
  const float corr = expf(m - m_new);
  l = l * corr + ps;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    acc[j].x *= corr;
    acc[j].y *= corr;
  }
  const float pv = live && R::kScaled ? p * sb[kRows + r] : p;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < n) {
      const float w = __shfl_sync(kFull, pv, i * kGroup);
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int pp = lane + 32 * j;
        if (pp < pairs) {
          const float2 vv = R::pair(vb + i * kElems, pp);
          acc[j].x += w * vv.x;
          acc[j].y += w * vv.y;
        }
      }
    }
  }
  m = m_new;
}

// kPairs pairs of the head dim a lane: D <= 64 * kPairs
template <class R, class A, int kPairs>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args<R, A> a) {
  using T = typename R::T;
  constexpr int kElems = 64 * kPairs;   // a ring row, longest D
  constexpr int kRows = stage_rows(sizeof(T), kPairs);
  constexpr int kScales = R::kScaled ? 2 * kRows : 1;
  __shared__ __align__(16) T ring_k[kWarps][kStages][kRows * kElems];
  __shared__ __align__(16) T ring_v[kWarps][kStages][kRows * kElems];
  __shared__ float ring_s[kWarps][kStages][kScales];
  __shared__ float warp_m[kWarps];
  __shared__ float warp_l[kWarps];
  __shared__ float warp_acc[kWarps][kElems];
  __shared__ float part_m;              // the CTA's partial state, read by
  __shared__ float part_l;              // CTA 0 of the cluster
  __shared__ float part_acc[kElems];
  extern __shared__ int tbl[];          // paged: the range's table entries

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int D = a.D;
  const int pairs = D / 2;
  const int cap = a.rows.capacity();
  int len = min(max(a.lengths[b], 0), cap);
  const bool uniform = A::kEmptyIsUniform && len == 0;
  if (len == 0) len = A::kEmptyIsUniform ? cap : 1;
  const int r0 = static_cast<int>(static_cast<long long>(rank) * len / kSplit);
  const int r1 =
      static_cast<int>(static_cast<long long>(rank + 1) * len / kSplit);
  const typename A::Cta at = a.rows.stage(b, r0, r1, tbl);
  const long long bh = static_cast<long long>(b) * a.H + h;
  float2 qv[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = lane + 32 * j;
    qv[j] = p < pairs ? make_float2(a.q[bh * D + 2 * p],
                                    a.q[bh * D + 2 * p + 1])
                      : make_float2(0.f, 0.f);
  }
  __syncthreads();                      // (paged) the table is staged

  float m = kNegInf;                    // this warp's running max,
  float l = 0.f;                        // denominator
  float2 acc[kPairs];                   // and sum of p * v
#pragma unroll
  for (int j = 0; j < kPairs; ++j) acc[j] = make_float2(0.f, 0.f);

  const CopyPlan plan =
      copy_plan(D * static_cast<int>(sizeof(T)), a.vec);
  // chunk c of this warp: rows [first + c * kStride, + kRows) below r1
  constexpr int kStride = kWarps * kRows;
  const int first = r0 + warp * kRows;
  const int chunks = first < r1 ? (r1 - first + kStride - 1) / kStride : 0;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      const int t0 = first + c * kStride;
      issue<R, A, kRows, kElems>(a, plan, at, h, t0, min(kRows, r1 - t0),
                                 ring_k[warp][c], ring_v[warp][c],
                                 ring_s[warp][c]);
    }
    cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int next = c + kStages - 1;
    if (next < chunks) {
      const int t0 = first + next * kStride;
      const int st = next % kStages;
      issue<R, A, kRows, kElems>(a, plan, at, h, t0, min(kRows, r1 - t0),
                                 ring_k[warp][st], ring_v[warp][st],
                                 ring_s[warp][st]);
    }
    cp_commit();
    cp_wait<kStages - 1>();             // chunk c's group is complete
    __syncwarp();                       // ... in every lane
    const int st = c % kStages;
    const int t0 = first + c * kStride;
    consume<R, kPairs, kRows, kElems>(ring_k[warp][st], ring_v[warp][st],
                                      ring_s[warp][st], min(kRows, r1 - t0),
                                      pairs, a.scale, uniform, qv, m, l,
                                      acc);
    __syncwarp();                       // read before the stage is reused
  }
  cp_wait<0>();

  // the CTA's partial state from its warps'; a warp that saw no row keeps
  // m = -1e30, l = 0 and drops out through exp(-1e30 - M) = 0
  if (lane == 0) {
    warp_m[warp] = m;
    warp_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = lane + 32 * j;
    if (p < pairs) {
      warp_acc[warp][2 * p] = acc[j].x;
      warp_acc[warp][2 * p + 1] = acc[j].y;
    }
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w]);
  const int d = threadIdx.x;
  if (d < D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += warp_acc[w][d] * expf(warp_m[w] - mx);
    }
    part_acc[d] = sum;
  }
  if (d == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_l[w] * expf(warp_m[w] - mx);
    part_m = mx;
    part_l = sum;
  }
  cluster.sync();                       // every CTA's partial state is in

  if (rank == 0 && d < D) {
    float pm[kSplit], pl[kSplit], pa[kSplit];
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {  // every load in flight at once
      pm[r] = *cluster.map_shared_rank(&part_m, r);
      pl[r] = *cluster.map_shared_rank(&part_l, r);
      pa[r] = cluster.map_shared_rank(part_acc, r)[d];
    }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) M = fmaxf(M, pm[r]);
    float num = 0.f;
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float f = expf(pm[r] - M);
      num += pa[r] * f;
      den += pl[r] * f;
    }
    a.out[bh * D + d] = num / den;
  }
  cluster.sync();                       // CTA 0 is done reading
}

// The launch for (B, H, D) and the row address `rows` (pt and W, or cap):
// grid (kSplit, H, B) in clusters of (kSplit, 1, 1), kThreads threads,
// `smem_bytes` of dynamic shared memory (paged: the most table entries a
// CTA stages; contiguous: none). False for shapes the kernels do not take.
template <class A>
bool launch_shape(int B, int H, int D, const A& rows, int* smem_bytes) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || (D & 1) || B > 65535 ||
      H > 65535) {
    return false;
  }
  return rows.smem_bytes(smem_bytes);
}

// bytes per copy: the widest of 16, 8, 4, 2, 1 that divides the pools'
// addresses and the row's bytes
inline int copy_bytes(const void* k, const void* v, int row_bytes) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      static_cast<uintptr_t>(row_bytes);
  int vec = 16;
  while (vec > 1 && x % vec) vec /= 2;
  return vec;
}

// out[0..6] = grid x, y, z, cluster x, threads, dynamic shared memory
// bytes, rows of a warp's stage; for the checks of chip_smoke.py against
// decode_attention.py `split_geometry` and `contig_split_geometry`
template <class R, class A>
int geometry(int B, int H, int D, const A& rows, int* out) {
  int smem_bytes = 0;
  if (!launch_shape(B, H, D, rows, &smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pairs = D <= 64 ? 1 : 2;
  const int v[7] = {kSplit, H, B, kSplit, kThreads, smem_bytes,
                    stage_rows(static_cast<int>(sizeof(typename R::T)),
                               pairs)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue for shapes the kernels do
// not take.
template <class R, class A>
int launch(Args<R, A> a, int B, cudaStream_t stream) {
  int smem_bytes = 0;
  if (!launch_shape(B, a.H, a.D, a.rows, &smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.vec = copy_bytes(a.k, a.v,
                     a.D * static_cast<int>(sizeof(typename R::T)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, a.H, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*kernel)(const Args<R, A>) =
      a.D <= 64 ? &split_kernel<R, A, 1> : &split_kernel<R, A, 2>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged_split

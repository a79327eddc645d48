// Hopper's Tensor Memory Accelerator (TMA), mbarriers and warp
// specialization, as the bf16 flash-attention kernels use them
// (flash_attention_fwd.cu, flash_attention_bwd.cu). sm_90a only.
//
// A CTA of these kernels is a producer warpgroup (warpgroup 0), whose first
// thread issues every TMA copy, and consumer warpgroups that run wgmma on
// what arrived. `setmaxnreg` moves registers from the producer (24 a
// thread) to the consumers. A copy is one instruction naming a box of a
// tensor map; the hardware computes the addresses, zero-fills what lies
// outside the tensor, writes the box into shared memory in wgmma's
// 128-byte swizzle (wgmma.cuh) and counts its bytes down on an mbarrier.
// Ring stages have a "full" barrier (the producer's expected bytes) and an
// "empty" one (one arrival per consumer warp once its products have read
// the stage).
//
// Tensor maps are encoded on the host at each launch by libcuda's
// cuTensorMapEncodeTiled and passed as __grid_constant__ kernel
// parameters, so a CUDA graph that captures a launch keeps its maps with
// its pointers. The libraries are loaded by ctypes and link no libcuda:
// that function is reached through the runtime's
// cudaGetDriverEntryPoint (cudaGetDriverEntryPointByVersion from CUDA
// 12.5 on).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace tma {

using flash_mma::smem_addr;

// ---------------------------------------------------------------- device

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival: the phase also waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into `dst`,
// counted on `bar`
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// barrier `id` (1..15) over `threads` threads, e.g. one warpgroup
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// the first 1024-byte aligned address at or after p (the swizzle atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, n, H, D] bf16 tensor with element strides (sb, st, sh) and a unit
// last stride, as a 4-D map over (D, H, n, B) whose box is 64 columns of
// `rows` consecutive tokens of one (b, h): 128-byte swizzle, zeros past D
// and past n. Needs a 16-byte aligned base and strides that are multiples
// of 8 elements. Returns false when the encoding is refused.
inline bool rows_map(CUtensorMap* map, const void* base, int B, int n, int H,
                     int D, long long sb, long long st, long long sh,
                     int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma

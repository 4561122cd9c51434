// Helpers of the hand kernels (biquad_exact.cu, polyphase_exact.cu,
// dotprod_exact.cu; the mbarrier hand-offs also flac_frame.cu): separately
// rounded f32 ops, Hopper bulk and tensor copies (the TMA engine), 4-byte
// cp.async and mbarrier hand-offs, as inline PTX. tools/cuda_cpu_shim.h has
// CPU stand-ins of those that dotprod_exact.cu uses.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Every product, sum and difference is its own PTX instruction with an
// explicit rounding modifier, which the compiler never contracts into an
// FMA; .ftz flushes subnormal operands and results to a zero of their sign.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Hopper bulk copies (the TMA engine) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned): global -> shared, completing `bytes` of the
// transaction count of `bar`; shared -> global in a bulk group.
__device__ __forceinline__ void bulk_load(const float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// A box of a 2-D tensor map (tensor_map_2d) at column x, row y, global ->
// shared, completing the box's bytes (all of them, the out-of-bounds part
// zero-filled) of the transaction count of `bar`.
__device__ __forceinline__ void tensor_load_2d(const float* dst, const CUtensorMap* map, int x,
                                               int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes) : "memory");
}
// A 4-byte copy, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(const float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the mbarrier inits visible to the async proxy (the bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits until this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// Arrives on bar and expects `bytes` more of bulk copies in its phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// The block's dynamic shared memory, 16-byte aligned.
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ __align__(16) float eal_dynamic_smem[];
  return eal_dynamic_smem;
}

// A 2-D tensor map of f32 rows for tensor_load_2d: `rows` rows of `cols`
// elements, row r at base + r * pitch (base 16-byte aligned, pitch a
// multiple of 4), read in boxes of 32 columns (128 bytes) x box_rows rows.
// A box lands in shared memory (1024-byte aligned) as box_rows rows of 128
// bytes with the 128-byte swizzle: the 16-byte chunk c of row r at chunk
// c ^ (r % 8), so that eight threads reading chunk c of eight consecutive
// rows hit 32 distinct banks. False if the CUDA driver refuses.
inline bool tensor_map_2d(CUtensorMap* map, const float* base, long long cols, long long rows,
                          long long pitch, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(pitch) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dim, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The SM count of the current device (0 if it cannot be read).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// Block-banded polyphase contraction, FP32 results, for sm_90a.
//
//   out[m, t] = sum_k x[m, starts[t / 128] + k] * Wt[t / 128, k, t % 128],  t < T
//
// Replaces the TPU kernel esp_audio_libs_tpu/ops/polyphase_pallas.py::
// polyphase_banded_pallas (_kernel + _slab_pipeline): there each grid step
// DMAs a K-wide slab window into VMEM and contracts it on the MXU. Here
// band_ranges.cu first finds each 32-column group's nonzero K-rows, then one
// block computes 128 rows x one 128-column tile with the shared main loop
// (banded_tile.cuh: band skipping, 3xTF32 mma.sync, a 3-stage cp.async +
// mbarrier ring), and stages the tile through shared memory so that each
// warp stores 128 contiguous bytes of a row.
//
// What bounds it, at the main shape (M = 4096 rows, L = 8576, 24 tiles,
// K = 768, about 205 nonzero weights per column): its 199 MB of unique bytes
// (x 140.5, out 48.8, Wt 9.4 MB) take 0.059 ms at 3.35 TB/s. The products
// the inputs need, 2 * nnz(Wt) * M = 5.2 GFLOP, run as three TF32 products
// each, 15.5 GFLOP: 0.031 ms at the 495 TFLOP/s TF32 peak, so bytes bound
// it. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.226 ms,
// 26 % of that bound, against 0.881 ms for the FFMA loop that walked all
// 768 rows. The instruction stream sets the
// pace: without its copies the kernel takes 0.218 ms, without its mma steps
// 0.131 ms, and the three mma.sync passes (10.8 M m16n8k8) account for about
// 0.11 ms of it (tools/kernel_variants.py).
//
// The post-filter conv (in Resampler._fast_chunk) uses this kernel with one
// shared weight tile: wt_tile_stride = 0 (one set of band ranges).

#include <cuda_runtime.h>

#include "banded_tile.cuh"

namespace {

__global__ void __launch_bounds__(eal::THREADS, eal::MIN_BLOCKS)
polyphase_banded_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                        const int* __restrict__ starts, const int* __restrict__ parts,
                        float* __restrict__ out, int M, int L, int K,
                        long long wt_tile_stride, int nparts, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = blockIdx.y;
  const int m0 = blockIdx.x * eal::BM;
  const int* tile_parts = parts + (size_t)(wt_tile_stride == 0 ? 0 : i) * nparts * eal::NGROUPS * 2;
  eal::Acc acc;
  eal::banded_tile(x, wt + (size_t)i * wt_tile_stride, tile_parts, nparts, starts[i], M, L, K,
                   m0, smem, acc);

  __syncthreads();                           // the ring is free: stage the tile
  float* Cs = reinterpret_cast<float*>(smem);
  eal::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(Cs + r * eal::C_PITCH + c) = make_float2(v0, v1);
  });
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < eal::BM && m0 + r < M; r += eal::THREADS / 32) {
    float* row = out + (size_t)(m0 + r) * T + i * eal::BN;
#pragma unroll
    for (int q = 0; q < eal::BN / 32; ++q) {
      const int c = lane + 32 * q;
      if (i * eal::BN + c < T) row[c] = Cs[r * eal::C_PITCH + c];
    }
  }
}

}  // namespace

// x f32 [M, L] (L % 4 == 0, 16-byte aligned), wt f32 [nt, K, 128] (tile
// stride wt_tile_stride elements, 16-byte aligned), starts int32 [nt], parts
// int32 scratch [ntw, eal_band_parts_len(K)] with ntw = 1 when the stride is
// 0 and nt otherwise, out f32 [M, T] with T <= nt * 128. Launches the band
// ranges and the contraction on `stream` and returns cudaGetLastError().
extern "C" int eal_polyphase_banded(const void* x, const void* wt, const void* starts,
                                    void* out, void* parts, int M, int L, int nt, int K,
                                    long long wt_tile_stride, int T, void* stream) {
  using R = eal::Ring<float>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntw = wt_tile_stride == 0 ? 1 : nt;
  eal::launch_band_ranges(static_cast<const float*>(wt), wt_tile_stride, ntw, K,
                          static_cast<int*>(parts), s);
  cudaError_t err = cudaFuncSetAttribute(polyphase_banded_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         R::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + eal::BM - 1) / eal::BM, nt);
  polyphase_banded_kernel<<<grid, eal::THREADS, R::SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const int*>(starts), static_cast<const int*>(parts), static_cast<float*>(out),
      M, L, K, wt_tile_stride, eal::band_parts(K), T);
  return static_cast<int>(cudaGetLastError());
}

// Block-banded polyphase contraction, FP32, for sm_90a.
//
//   out[m, t] = sum_k x[m, starts[t / 128] + k] * Wt[t / 128, k, t % 128],  t < T
//
// Replaces the TPU kernel esp_audio_libs_tpu/ops/polyphase_pallas.py::
// polyphase_banded_pallas (_kernel + _slab_pipeline): there each grid step
// DMAs a K-wide slab window into VMEM and contracts it on the MXU. Here one
// block computes 64 rows x one 128-column tile with the shared register-tiled
// SGEMM main loop (banded_tile.cuh); the slab is read straight from device
// memory at its unaligned start, so starts need no 128-alignment.
//
// What bounds it: at the main shape (M = 4096 rows, K = 768, 24 tiles) a
// chunk is about 19 GFLOP over about 200 MB of unique slab, weight and
// output bytes: roughly 100 flop per unique byte, above the H100's FP32
// ridge (67 TFLOP/s over 3.35 TB/s is about 20), so the kernel is bound by
// FFMA issue and shared-memory bandwidth, not by device memory.
//
// Left for later work: only taps_p / K (about 318 of 768) of each weight
// column's band is nonzero, so more than half the FFMAs multiply zeros;
// skipping the empty K-steps per column group, 3xTF32 wgmma, TMA slab loads
// and a multi-stage pipeline are the known levers.
//
// The post-filter conv (Resampler._conv_post) uses this kernel with one
// shared weight tile: wt_tile_stride = 0.

#include <cuda_runtime.h>

#include "banded_tile.cuh"

namespace {

__global__ void __launch_bounds__(eal::THREADS)
polyphase_banded_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                        const int* __restrict__ starts, float* __restrict__ out,
                        int M, int L, int K, long long wt_tile_stride, int T) {
  const int i = blockIdx.y;
  const int m0 = blockIdx.x * eal::BM;
  float acc[eal::TM][eal::TN];
  eal::banded_tile(x, wt + (size_t)i * wt_tile_stride, starts[i], M, L, K, m0, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < eal::TM; ++r) {
    const int m = m0 + ty * eal::TM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < eal::TN; ++c) {
      const int t = i * eal::BN + tx + 16 * c;
      if (t < T) out[(size_t)m * T + t] = acc[r][c];
    }
  }
}

}  // namespace

// x f32 [M, L], wt f32 [nt, K, 128] (tile stride wt_tile_stride elements),
// starts int32 [nt], out f32 [M, T] with T <= nt * 128. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int eal_polyphase_banded(const void* x, const void* wt, const void* starts,
                                    void* out, int M, int L, int nt, int K,
                                    long long wt_tile_stride, int T, void* stream) {
  const dim3 grid((M + eal::BM - 1) / eal::BM, nt);
  polyphase_banded_kernel<<<grid, eal::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const int*>(starts), static_cast<float*>(out), M, L, K,
      wt_tile_stride, T);
  return static_cast<int>(cudaGetLastError());
}

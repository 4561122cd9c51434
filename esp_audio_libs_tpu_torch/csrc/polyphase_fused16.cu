// Fused int16 banded polyphase contraction + 16-bit quantize, for sm_90a.
//
//   y[m, t]   = sum_k float(x[m, starts[t / 128] + k]) * Wt[t / 128, k, t % 128]
//   out[m, t] = clip_s16(x86_cast(floor(y * 32768 + 0.5))), clip[m, t] = clipped
//
// Replaces the TPU kernel esp_audio_libs_tpu/ops/polyphase_pallas.py::
// polyphase_fused16_pallas (_fused16_kernel): raw int16 slabs (half the slab
// bytes of the f32 path; the caller folds the PCM gain factor into Wt), the
// same FP32 contraction as polyphase_banded.cu (shared main loop,
// banded_tile.cuh), and the quantize epilogue in registers, so the f32
// output never reaches device memory: int16 samples and an int8 clip mask
// come out.
//
// Numerics of the epilogue match ops/quantization.py::float_to_int: the
// product y * 32768 and the + 0.5 are separately rounded (__fmul_rn,
// __fadd_rn: no FMA contraction), and the x86 cvttss2si cast is emulated
// explicitly before converting (NaN or |y| >= 2^31 becomes INT_MIN and so
// clips to NEGATIVE full scale, src/quantization_utils.cpp:61). CUDA's own
// float-to-int conversion saturates and maps NaN to 0, which would differ.
//
// What bounds it: the same contraction as polyphase_banded.cu, about 100
// flop per unique byte at the main shape, above the FP32 ridge: FFMA- and
// shared-memory-bound. The same waste (only about 318 of each column's 768
// band entries are nonzero) and the same levers (per-column K-step skipping,
// 3xTF32 wgmma, TMA slab loads) are left for later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "banded_tile.cuh"

namespace {

__global__ void __launch_bounds__(eal::THREADS)
polyphase_fused16_kernel(const int16_t* __restrict__ x, const float* __restrict__ wt,
                         const int* __restrict__ starts, int16_t* __restrict__ out,
                         int8_t* __restrict__ clip, int M, int L, int K,
                         long long wt_tile_stride, int width) {
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
      const float y = floorf(__fadd_rn(__fmul_rn(acc[r][c], 32768.0f), 0.5f));
      const bool bad = isnan(y) || y >= 2147483648.0f || y < -2147483648.0f;
      const float yc = bad ? -2147483648.0f : y;
      const bool clipped = yc > 32767.0f || yc < -32768.0f;
      const float v = fminf(fmaxf(yc, -32768.0f), 32767.0f);
      const size_t o = (size_t)m * width + t;
      out[o] = static_cast<int16_t>(static_cast<int>(v));
      clip[o] = clipped ? 1 : 0;
    }
  }
}

}  // namespace

// x int16 [M, L], wt f32 [nt, K, 128] (tile stride wt_tile_stride elements),
// starts int32 [nt]; out int16 and clip int8, both [M, nt * 128]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int eal_polyphase_fused16(const void* x, const void* wt, const void* starts,
                                     void* out, void* clip, int M, int L, int nt, int K,
                                     long long wt_tile_stride, void* stream) {
  const dim3 grid((M + eal::BM - 1) / eal::BM, nt);
  polyphase_fused16_kernel<<<grid, eal::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(wt),
      static_cast<const int*>(starts), static_cast<int16_t*>(out),
      static_cast<int8_t*>(clip), M, L, K, wt_tile_stride, nt * eal::BN);
  return static_cast<int>(cudaGetLastError());
}

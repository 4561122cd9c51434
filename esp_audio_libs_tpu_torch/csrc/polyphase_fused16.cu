// Fused int16 banded polyphase contraction + 16-bit quantize, for sm_90a.
//
//   y[m, t]   = sum_k float(x[m, starts[t / 128] + k]) * Wt[t / 128, k, t % 128]
//   out[m, t] = clip_s16(x86_cast(floor(y * 32768 + 0.5))), clip[m, t] = clipped
//
// Replaces the TPU kernel esp_audio_libs_tpu/ops/polyphase_pallas.py::
// polyphase_fused16_pallas (_fused16_kernel): raw int16 slabs (half the slab
// bytes of the f32 path; the caller folds the PCM gain factor into Wt), the
// same contraction as polyphase_banded.cu (band_ranges.cu, then the shared
// main loop of banded_tile.cuh with the slab staged as int16 and converted
// when the fragments are read; an int16 sample's 3xTF32 split is exact), and
// the quantize epilogue in registers, so the f32 output never reaches device
// memory. The int16 samples and the int8 clip mask are staged through shared
// memory and stored as 16-byte writes, 256 and 128 contiguous bytes per row.
//
// Numerics of the epilogue match ops/quantization.py::float_to_int: the
// product y * 32768 and the + 0.5 are separately rounded (__fmul_rn,
// __fadd_rn: no FMA contraction), and the x86 cvttss2si cast is emulated
// explicitly before converting (NaN or |y| >= 2^31 becomes INT_MIN and so
// clips to NEGATIVE full scale, src/quantization_utils.cpp:61). CUDA's own
// float-to-int conversion saturates and maps NaN to 0, which would differ.
//
// What bounds it, at the main shape: the band products of
// polyphase_banded.cu less the 7 % of weights (denormal tails of the folded
// pre-filter) that folding the gain into Wt flushes to zero: 4.8 GFLOP, as
// three TF32 products each 14.4 GFLOP, 0.029 ms at 495 TFLOP/s, below the
// 0.035 ms that 117 MB of unique bytes (x 70.3, samples 25.2, clip mask
// 12.6, Wt 9.4 MB) take at 3.35 TB/s. Measured on an H100 80GB HBM3 at
// 700 W (chip_smoke.py): 0.221 ms, 16 % of that bound, against 0.849 ms
// for the FFMA loop; as there, the instruction stream sets
// the pace (0.217 ms without copies, 0.086 ms without mma steps).

#include <cuda_runtime.h>

#include <cstdint>

#include "banded_tile.cuh"

namespace {

constexpr int S_PITCH = eal::BN + 8;    // int16 samples per staged row
constexpr int M_PITCH = eal::BN + 16;   // int8 clip flags per staged row

__device__ __forceinline__ void quantize16(float a, int16_t& s, int8_t& c) {
  const float y = floorf(__fadd_rn(__fmul_rn(a, 32768.0f), 0.5f));
  const bool bad = isnan(y) || y >= 2147483648.0f || y < -2147483648.0f;
  const float yc = bad ? -2147483648.0f : y;
  c = (yc > 32767.0f || yc < -32768.0f) ? 1 : 0;
  s = static_cast<int16_t>(static_cast<int>(fminf(fmaxf(yc, -32768.0f), 32767.0f)));
}

__global__ void __launch_bounds__(eal::THREADS, eal::MIN_BLOCKS)
polyphase_fused16_kernel(const int16_t* __restrict__ x, const float* __restrict__ wt,
                         const int* __restrict__ starts, const int* __restrict__ parts,
                         int16_t* __restrict__ out, int8_t* __restrict__ clip, int M, int L,
                         int K, long long wt_tile_stride, int nparts, int width) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = blockIdx.y;
  const int m0 = blockIdx.x * eal::BM;
  const int* tile_parts = parts + (size_t)(wt_tile_stride == 0 ? 0 : i) * nparts * eal::NGROUPS * 2;
  eal::Acc acc;
  eal::banded_tile(x, wt + (size_t)i * wt_tile_stride, tile_parts, nparts, starts[i], M, L, K,
                   m0, smem, acc);

  __syncthreads();                           // the ring is free: stage the tile
  int16_t* Ss = reinterpret_cast<int16_t*>(smem);
  int8_t* Cm = reinterpret_cast<int8_t*>(smem + eal::BM * S_PITCH * 2);
  eal::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    int16_t s0, s1;
    int8_t c0, c1;
    quantize16(v0, s0, c0);
    quantize16(v1, s1, c1);
    *reinterpret_cast<short2*>(Ss + r * S_PITCH + c) = make_short2(s0, s1);
    *reinterpret_cast<char2*>(Cm + r * M_PITCH + c) = make_char2(c0, c1);
  });
  __syncthreads();
  const size_t col0 = (size_t)i * eal::BN;
  for (int idx = threadIdx.x; idx < eal::BM * (eal::BN / 8); idx += eal::THREADS) {
    const int r = idx / (eal::BN / 8), ch = idx % (eal::BN / 8);
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * width + col0 + ch * 8) =
          *reinterpret_cast<const uint4*>(Ss + r * S_PITCH + ch * 8);
  }
  for (int idx = threadIdx.x; idx < eal::BM * (eal::BN / 16); idx += eal::THREADS) {
    const int r = idx / (eal::BN / 16), ch = idx % (eal::BN / 16);
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(clip + (size_t)(m0 + r) * width + col0 + ch * 16) =
          *reinterpret_cast<const uint4*>(Cm + r * M_PITCH + ch * 16);
  }
}

}  // namespace

// x int16 [M, L] (L % 8 == 0, 16-byte aligned), wt f32 [nt, K, 128] (tile
// stride wt_tile_stride elements, 16-byte aligned), starts int32 [nt], parts
// int32 scratch as for eal_polyphase_banded; out int16 and clip int8, both
// [M, nt * 128]. Launches the band ranges and the contraction on `stream` and
// returns cudaGetLastError().
extern "C" int eal_polyphase_fused16(const void* x, const void* wt, const void* starts,
                                     void* out, void* clip, void* parts, int M, int L, int nt,
                                     int K, long long wt_tile_stride, void* stream) {
  using R = eal::Ring<int16_t>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntw = wt_tile_stride == 0 ? 1 : nt;
  eal::launch_band_ranges(static_cast<const float*>(wt), wt_tile_stride, ntw, K,
                          static_cast<int*>(parts), s);
  cudaError_t err = cudaFuncSetAttribute(polyphase_fused16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         R::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + eal::BM - 1) / eal::BM, nt);
  polyphase_fused16_kernel<<<grid, eal::THREADS, R::SMEM_BYTES, s>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(wt),
      static_cast<const int*>(starts), static_cast<const int*>(parts),
      static_cast<int16_t*>(out), static_cast<int8_t*>(clip), M, L, K, wt_tile_stride,
      eal::band_parts(K), nt * eal::BN);
  return static_cast<int>(cudaGetLastError());
}

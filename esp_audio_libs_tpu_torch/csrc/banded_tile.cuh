// Shared main loop of the two banded polyphase kernels (polyphase_banded.cu,
// polyphase_fused16.cu): a register-tiled FP32 SGEMM over one output tile.
//
//   out[m, 128 i + j] = sum_k x[m, starts[i] + k] * Wt[i, k, j]
//
// One block of 256 threads computes a BM x BN = 64 x 128 block of outputs for
// weight tile i (blockIdx.y) and rows m0 = 64 * blockIdx.x. It walks K in
// steps of BK = 16: the slab x[m0:m0+64, start+k0 : start+k0+16] and the
// weight rows Wt[i, k0:k0+16, :] are staged in shared memory (about 12 KB),
// and each thread accumulates a 4 x 8 sub-tile in registers with FFMA.
// Accumulation is plain IEEE f32 (FFMA rounds once per product-add); there is
// no TF32 anywhere, which would break the 1-LSB output contract.
//
// The block masks its own ragged edges: rows past M, slab columns past L and
// k past K read as zero.
#pragma once

#include <cstdint>

namespace eal {

constexpr int BM = 64;        // rows of the output block
constexpr int BN = 128;       // columns: one weight tile
constexpr int BK = 16;        // K step staged in shared memory
constexpr int THREADS = 256;
constexpr int TM = 4;         // rows per thread
constexpr int TN = 8;         // columns per thread, strided by 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }

// Accumulates acc[r][c] = out[m0 + 4*ty + r, 16*c + tx] (tile-local columns),
// with tx = threadIdx.x % 16, ty = threadIdx.x / 16.
template <typename Tin>
__device__ __forceinline__ void banded_tile(const Tin* __restrict__ x,
                                            const float* __restrict__ wt,
                                            int start, int M, int L, int K, int m0,
                                            float (&acc)[TM][TN]) {
  __shared__ float As[BK][BM + 1];   // slab, k-major; +1 breaks bank conflicts
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // slab: 64 rows x 16 columns, 4 elements per thread; 16 neighbouring
    // threads read 16 neighbouring samples of one row
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int m = m0 + r;
      const int k = k0 + kk;
      const int col = start + k;
      float v = 0.0f;
      if (m < M && k < K && col >= 0 && col < L) v = to_f32(x[(size_t)m * L + col]);
      As[kk][r] = v;
    }
    // weights: 16 rows x 128 columns, 8 elements per thread, coalesced
#pragma unroll
    for (int e = 0; e < (BK * BN) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN;
      const int j = idx % BN;
      const int k = k0 + kk;
      Bs[kk][j] = (k < K) ? wt[(size_t)k * BN + j] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][ty * TM + r];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace eal

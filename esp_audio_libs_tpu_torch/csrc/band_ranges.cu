// Band ranges of the weight tiles, for sm_90a: the first and last K-row of
// each column group (GROUP = 32 columns, the unit over which the banded main
// loop skips weight copies and mma) that holds a nonzero weight.
//
// A helper of the two banded polyphase kernels, which launch it on their own
// stream right before the contraction (no host sync) and count its time as
// theirs; it replaces nothing of the TPU package, whose Pallas kernels walk
// every K-row. The ranges come from Wt itself, not from how the caller built
// it. A weight is "nonzero" when it compares unequal to 0.0f, so a NaN weight
// counts and -0.0 does not.
//
// Block (i, p) reads rows [BAND_ROWS * p, BAND_ROWS * (p + 1)) of tile i, one
// thread per column, coalesced; each warp reduces its 32 columns and writes
// one partial (first, last), or (K, -1) for an empty piece. The banded kernel
// reduces the ceil(K / BAND_ROWS) partials of its tile. What bounds it: the
// bytes of Wt (9.4 MB at the main shape, a few microseconds at 3.35 TB/s).

#include <cuda_runtime.h>

#include "banded_tile.cuh"

namespace {

__global__ void __launch_bounds__(eal::BN)
band_ranges_kernel(const float* __restrict__ wt, long long wt_tile_stride, int K,
                   int* __restrict__ parts) {
  const int i = blockIdx.x, p = blockIdx.y;
  const int j = threadIdx.x;
  const float* col = wt + (size_t)i * wt_tile_stride + j;
  const int k0 = p * eal::BAND_ROWS;
  const int k1 = min(K, k0 + eal::BAND_ROWS);
  int lo = K, hi = -1;
#pragma unroll 8
  for (int k = k0; k < k1; ++k) {
    const bool nz = col[(size_t)k * eal::BN] != 0.0f;
    lo = nz ? min(lo, k) : lo;
    hi = nz ? k : hi;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (j % 32 == 0) {
    int* o = parts + ((size_t)(i * gridDim.y + p) * eal::NGROUPS + j / 32) * 2;
    o[0] = lo;
    o[1] = hi;
  }
}

}  // namespace

void eal::launch_band_ranges(const float* wt, long long wt_tile_stride, int ntw, int K,
                             int* parts, cudaStream_t stream) {
  const dim3 grid(ntw, band_parts(K));
  band_ranges_kernel<<<grid, BN, 0, stream>>>(wt, wt_tile_stride, K, parts);
}

// int32 elements of the band-range scratch per weight tile: the one place
// that sizes it ([band_parts(K), NGROUPS, 2]), so callers allocate
// [ntw, eal_band_parts_len(K)].
extern "C" long long eal_band_parts_len(int K) {
  return static_cast<long long>(eal::band_parts(K)) * eal::NGROUPS * 2;
}

// wt f32 [ntw, K, 128] (tile stride wt_tile_stride elements), parts int32
// [ntw, eal_band_parts_len(K)]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int eal_band_ranges(const void* wt, void* parts, int ntw, int K,
                               long long wt_tile_stride, void* stream) {
  eal::launch_band_ranges(static_cast<const float*>(wt), wt_tile_stride, ntw, K,
                          static_cast<int*>(parts), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

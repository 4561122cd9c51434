// The exact f32 dot product of ops/dsp.py::dotprod_f32(exact=True) for
// sm_90a, bit-exact against the JAX package.
//
// Replaces the lax.scan of esp_audio_libs_tpu/ops/dsp.py:32-51 (XLA there,
// not Pallas; eager PyTorch would launch one add per column), the batched
// form of the reference's dsps_dotprod_f32_ansi.c:17-25:
//   out[r] = (((+0 + a[r,0]*b[r,0]) + a[r,1]*b[r,1]) + ...) + a[r,n-1]*b[r,n-1]
// Every product and sum is its own PTX instruction (mul.rn.ftz / add.rn.ftz,
// exact_async.cuh), which the compiler never contracts into an FMA, in that
// order; .ftz flushes subnormal operands and results to a zero of their own
// sign, the JAX package's rule (ops/scan.py).
//
// What bounds it: the bytes of a and b, each read once (268 MB at [4096,
// 8192], 0.080 ms at 3.35 TB/s). Each row is a chain of n dependent adds
// (8192 adds at about 4 cycles: 0.017 ms at 1.98 GHz), far below that, so
// the design keeps loads in flight while the chains run:
// - A block owns ROWS = 32 rows: one chain per lane of warp 0.
// - Columns go in tiles of COLS = 128. All four warps load a tile of a and b
//   into registers with coalesced loads (one warp reads 128 columns of one
//   row: 16-byte loads where every row and base is 16-byte aligned and n a
//   multiple of 4, else 4-byte loads), multiply, and store the products in a
//   shared-memory tile [ROWS][COLS + 1]: the padding puts lane r's column c
//   on bank (r + c) % 32, so the chain's reads are conflict-free.
// - Two product tiles alternate: after the barrier of tile k every warp
//   issues its loads of tile k + 1, then warp 0 adds tile k's products in
//   order while those loads are in flight.
// Rows past R and columns past n are never read; n = 0 gives +0.

#include <cuda_runtime.h>

#include <cstdint>

#include "exact_async.cuh"

namespace {

constexpr int ROWS = 32;          // rows of a block: lane r of warp 0 chains row r
constexpr int COLS = 128;         // columns of a tile
constexpr int THREADS = 128;      // four warps load and multiply
constexpr int PITCH = COLS + 1;   // a product row in shared memory, padded

// W floats per load: 4 (16-byte loads) or 1. A thread's k-th load of a
// tile is item t + k * THREADS of the tile's ROWS * COLS / W items, row by row.
template <int W>
__global__ void __launch_bounds__(THREADS)
dotprod_exact_kernel(const float* __restrict__ a, long long lda, const float* __restrict__ b,
                     long long ldb, float* __restrict__ out, long long R, int n) {
  constexpr int PER_ROW = COLS / W;                  // items of one tile row
  constexpr int PER = ROWS * PER_ROW / THREADS;      // items of one thread
  __shared__ float prod[2][ROWS * PITCH];

  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = R - row0 < ROWS ? static_cast<int>(R - row0) : ROWS;
  const int ntiles = (n + COLS - 1) / COLS;
  float ra[PER][W], rb[PER][W];

  auto load = [&](int tile) {
    const int c0 = tile * COLS;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int item = t + k * THREADS;
      const int r = item / PER_ROW, c = c0 + (item % PER_ROW) * W;
      const bool valid = r < rows && c < n;    // n % W == 0 where W == 4
      const long long ia = (row0 + r) * lda + c, ib = (row0 + r) * ldb + c;
      if constexpr (W == 4) {
        const float4 va = valid ? *reinterpret_cast<const float4*>(a + ia) : float4{0, 0, 0, 0};
        const float4 vb = valid ? *reinterpret_cast<const float4*>(b + ib) : float4{0, 0, 0, 0};
        ra[k][0] = va.x, ra[k][1] = va.y, ra[k][2] = va.z, ra[k][3] = va.w;
        rb[k][0] = vb.x, rb[k][1] = vb.y, rb[k][2] = vb.z, rb[k][3] = vb.w;
      } else {
        ra[k][0] = valid ? a[ia] : 0.0f;
        rb[k][0] = valid ? b[ib] : 0.0f;
      }
    }
  };

  if (ntiles > 0) load(0);
  float acc = 0.0f;
  for (int tile = 0; tile < ntiles; ++tile) {
    float* p = prod[tile & 1];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int item = t + k * THREADS;
      const int r = item / PER_ROW, c = (item % PER_ROW) * W;
#pragma unroll
      for (int j = 0; j < W; ++j) p[r * PITCH + c + j] = mul_ftz(ra[k][j], rb[k][j]);
    }
    // the products of this tile are visible, and the chain of tile - 1 (the
    // last reader of the other buffer) has ended
    __syncthreads();
    if (tile + 1 < ntiles) load(tile + 1);
    if (t < rows) {
      const float* pr = p + t * PITCH;
      const int cols = n - tile * COLS < COLS ? n - tile * COLS : COLS;
#pragma unroll 8
      for (int c = 0; c < cols; ++c) acc = add_ftz(acc, pr[c]);
    }
  }
  if (t < rows) out[row0 + t] = acc;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a, b: f32 rows of n elements, row r at a + r * lda and b + r * ldb (pitches
// in elements); out: f32 [R]. R >= 1, n >= 0. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad shape).
extern "C" int eal_dotprod_exact(const void* a, long long lda, const void* b, long long ldb,
                                 void* out, long long R, int n, void* stream) {
  if (R < 1 || n < 0 || lda < n || ldb < n || (R + ROWS - 1) / ROWS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = n % 4 == 0 && lda % 4 == 0 && ldb % 4 == 0 && aligned16(a) && aligned16(b);
  auto kernel = wide ? dotprod_exact_kernel<4> : dotprod_exact_kernel<1>;
  const dim3 grid(static_cast<unsigned>((R + ROWS - 1) / ROWS));
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
      static_cast<float*>(out), R, n);
  return static_cast<int>(cudaGetLastError());
}

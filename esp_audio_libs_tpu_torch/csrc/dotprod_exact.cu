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
// 8192]: 0.080 ms at 3.35 TB/s; 33.8 MB at [65536, 64]: 0.010 ms). Each row
// is a chain of n dependent adds (8192 adds at about 4 cycles: 0.017 ms at
// 1.98 GHz), below that. The first design of this kernel kept one 32 KB
// tile in flight per SM and only while one 128-step chain ran, so each tile
// paid a full load round trip: 0.1618 ms and 0.0189 ms, 50 % and 53 % of
// the bound. This one keeps several tiles in flight on every SM all the
// time: 0.0935 ms and 0.0153 ms, 86 % and 66 % (H100 80GB HBM3, 700 W;
// tools/kernel_variants.py --dotprod, both in one process, [65536, 64] over
// operand sets that L2 cannot hold). At [65536, 64] a launch with no column
// ([65536, 0]) takes 0.0029 ms of those 0.0153: the rest reads at 2.7 TB/s,
// [4096, 8192] at 2.9 TB/s. With the adds dropped (a probe) the times are
// 0.0911 and 0.0146 ms: the copies set the pace, not the chain.
// - A block has a LOAD warp and a CHAIN warp. LOAD copies tiles of a and b
//   into an NST-stage ring in shared memory (3 stages of 32 KB: two blocks
//   an SM); CHAIN runs the chains, lane r on row r of a row group of ROWS
//   rows. A tile is the group's rows x COLS columns of both operands.
// - Blocks are persistent: the grid is min(row groups, resident blocks x
//   SMs), and block k walks groups k, k + grid, ... The ring runs on across
//   group boundaries, so the next group's tiles load while this one chains
//   (at [65536, 64], 2048 groups of one 64-column tile each).
// - Where both operands' rows start 16-byte aligned (the base aligned, the
//   pitch a multiple of 4 floats: every contiguous [R, n] with n % 4 == 0),
//   LOAD is one thread that copies a tile as Hopper tensor copies (the TMA
//   engine, cp.async.bulk.tensor.2d) of boxes of ROWS rows x 32 columns,
//   4 KB each: 8 copies a tile. Columns past n and rows past R come in as
//   zeros and are never added. A first version of this design issued one
//   bulk copy (cp.async.bulk) per row segment, 64 a tile, and ran at 58 %
//   and 25 % of the bound however deep its ring: a warp issues such copies
//   one lane after another, about 30 ns each, so the copies set the pace;
//   16-byte cp.async from the whole warp was slower still.
// - Otherwise the LOAD warp copies the tile with 4-byte cp.async,
//   coalesced, one row after another, into the same layout: a path of this
//   kernel.
// - A box lands with the 128-byte swizzle: the 16-byte chunk c of a
//   128-byte box row r sits at chunk c ^ (r % 8) (the 4-byte path writes the
//   same layout). CHAIN lane r reads 4 columns of a and of b with one 16-byte
//   shared load each; eight consecutive lanes on eight consecutive rows hit
//   32 distinct banks. It forms the products (they depend on no sum) of a
//   batch of 32 columns, issues the next batch's loads, then runs the
//   batch's ordered adds: the chain is one add per column.
//
// Hand-off: two mbarriers per stage. FULL expects LOAD's one thread (with
// expect_tx of the tile's box bytes, which the tensor copies complete) or,
// on the 4-byte path, its 32 lanes through
// cp.async.mbarrier.arrive.noinc once their copies have landed. EMPTY
// expects CHAIN's 32 lanes, once they have read the stage. The i-th tile of
// a block (counted over all its groups) uses stage i % NST; CHAIN waits for
// FULL's phase parity (i / NST) & 1, LOAD for EMPTY's ((i / NST) - 1) & 1
// when i >= NST. Both roles walk the same groups and tiles (the shape
// decides them, never the data), so every stage completes each phase once
// per use, and a stage is refilled only after CHAIN has released it: no
// waiter can be two phases behind, and parity cannot alias. n = 0 gives
// each group no tile and +0 sums.

#include <cuda_runtime.h>

#include <cstdint>

#include "exact_async.cuh"

namespace {

constexpr int ROWS = 32;                 // rows of a group: one per CHAIN lane
constexpr int COLS = 128;                // columns of a tile
constexpr int NST = 3;                   // ring stages: two blocks an SM
constexpr int U = 8;                     // 16-byte chunks of a CHAIN batch
constexpr int BOX = ROWS * 32;           // floats of a 32-column box
constexpr int BOXES = COLS / 32;         // boxes of an operand's tile
constexpr int OPERAND = ROWS * COLS;     // floats of an operand's tile
constexpr int STAGE = 2 * OPERAND;       // a's tile, then b's
constexpr int SMEM_BYTES = NST * STAGE * 4 + 1024;   // and the swizzle's alignment
constexpr int THREADS = 64;              // LOAD (warp 0), CHAIN (warp 1)
static_assert(COLS % (4 * U) == 0, "a tile is whole CHAIN batches");

struct DotArgs {
  CUtensorMap map_a, map_b;   // tensor path only
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  float* out;
  long long R;
  int n;
};

// The ring's position: stage s of use `round` (the i-th tile of the block
// is stage i % NST of round i / NST).
struct Slot {
  int s = 0;
  uint32_t round = 0;
  __device__ void next() {
    if (++s == NST) {
      s = 0;
      ++round;
    }
  }
};

// Where column c of row r of an operand's tile lies in a stage: box c / 32,
// its row r, the 16-byte chunk (c % 32) / 4 swizzled with r % 8.
__device__ __forceinline__ int ring_at(int r, int c) {
  return (c >> 5) * BOX + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// LOAD, tensor path: one thread copies each tile as 2 x BOXES boxes (fewer
// in a tail tile).
__device__ void load_tensor(const DotArgs& d, float* ring, uint64_t* full, uint64_t* empty) {
  const long long groups = (d.R + ROWS - 1) / ROWS;
  const int ntiles = (d.n + COLS - 1) / COLS;
  Slot at;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    for (int t = 0; t < ntiles; ++t) {
      if (at.round > 0) mbar_wait(&empty[at.s], (at.round - 1) & 1);
      const int c0 = t * COLS;
      const int boxes = min(BOXES, (d.n - c0 + 31) / 32);
      float* st = ring + at.s * STAGE;
      mbar_arrive_expect_tx(&full[at.s], 2u * boxes * BOX * 4);
      for (int x = 0; x < boxes; ++x) {
        const int y = static_cast<int>(g * ROWS);
        tensor_load_2d(st + x * BOX, &d.map_a, c0 + 32 * x, y, &full[at.s]);
        tensor_load_2d(st + OPERAND + x * BOX, &d.map_b, c0 + 32 * x, y, &full[at.s]);
      }
      at.next();
    }
  }
}

// LOAD, 4-byte path: the warp copies each tile row by row, 32 columns a
// step; only rows < R and columns < n.
__device__ void load_words(const DotArgs& d, float* ring, uint64_t* full, uint64_t* empty) {
  const int j = threadIdx.x % 32;
  const long long groups = (d.R + ROWS - 1) / ROWS;
  const int ntiles = (d.n + COLS - 1) / COLS;
  Slot at;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row0 = g * ROWS;
    const int rows = static_cast<int>(min(static_cast<long long>(ROWS), d.R - row0));
    for (int t = 0; t < ntiles; ++t) {
      if (at.round > 0) mbar_wait(&empty[at.s], (at.round - 1) & 1);
      const int c0 = t * COLS;
      const int cols = min(COLS, d.n - c0);
      float* st = ring + at.s * STAGE;
      for (int r = 0; r < rows; ++r) {
        const float* ra = d.a + (row0 + r) * d.lda + c0;
        const float* rb = d.b + (row0 + r) * d.ldb + c0;
        for (int c = j; c < cols; c += 32) {
          cp_async4(st + ring_at(r, c), ra + c, true);
          cp_async4(st + OPERAND + ring_at(r, c), rb + c, true);
        }
      }
      cp_async_arrive(&full[at.s]);
      at.next();
    }
  }
  cp_async_wait_all();
}

// The adds of one tile row r: `cols` columns of a * b in order onto acc, in
// batches of U chunks (4 columns each). The shared loads of a batch are
// issued before the adds of the one before it, so that the chain does not
// wait for them. Only a batch that ends past cols (the tail of n) tests its
// columns: a tested add would lengthen every step of the chain. Entries
// past cols are read and multiplied but never added.
__device__ __forceinline__ float chain_tile(const float* st, int r, int cols, float acc) {
  constexpr int W = 4 * U;   // columns of a batch
  float4 va[U], vb[U];
  auto load = [&](int batch) {   // every batch of the tile lies inside the stage
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int at = ring_at(r, W * batch + 4 * u);
      va[u] = *reinterpret_cast<const float4*>(st + at);
      vb[u] = *reinterpret_cast<const float4*>(st + OPERAND + at);
    }
  };
  const int batches = (cols + W - 1) / W;
  load(0);
  for (int batch = 0; batch < batches; ++batch) {
    float p[W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[4 * u] = mul_ftz(va[u].x, vb[u].x);
      p[4 * u + 1] = mul_ftz(va[u].y, vb[u].y);
      p[4 * u + 2] = mul_ftz(va[u].z, vb[u].z);
      p[4 * u + 3] = mul_ftz(va[u].w, vb[u].w);
    }
    if (batch + 1 < batches) load(batch + 1);
    const int valid = cols - W * batch;
    if (valid >= W) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc = add_ftz(acc, p[i]);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i < valid) acc = add_ftz(acc, p[i]);
    }
  }
  return acc;
}

// CHAIN: lane j sums row j of each group over the group's tiles and stores it.
__device__ void chain_role(const DotArgs& d, const float* ring, uint64_t* full, uint64_t* empty) {
  const int j = threadIdx.x % 32;
  const long long groups = (d.R + ROWS - 1) / ROWS;
  const int ntiles = (d.n + COLS - 1) / COLS;
  Slot at;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row0 = g * ROWS;
    const bool mine = j < ROWS && row0 + j < d.R;
    float acc = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(&full[at.s], at.round & 1);
      if (mine) {
        const float* st = ring + at.s * STAGE;
        acc = chain_tile(st, j, min(COLS, d.n - t * COLS), acc);
      }
      mbar_arrive(&empty[at.s]);
      at.next();
    }
    if (mine) d.out[row0 + j] = acc;
  }
}

template <bool TENSOR>
__global__ void __launch_bounds__(THREADS) dotprod_exact_kernel(const __grid_constant__ DotArgs d) {
  __shared__ uint64_t full[NST], empty[NST];
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], TENSOR ? 1 : 32);
      mbar_init(&empty[s], 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the swizzle repeats every 8 box rows of 128 bytes: 1024-byte aligned
  // boxes (an offset from the shared array, so that its loads stay LDS)
  float* smem = dynamic_smem();
  float* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023) / 4;
  if (threadIdx.x >= 32)
    chain_role(d, ring, full, empty);
  else if (!TENSOR)
    load_words(d, ring, full, empty);
  else if (threadIdx.x == 0)
    load_tensor(d, ring, full, empty);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a, b: f32 rows of n elements, row r at a + r * lda and b + r * ldb (pitches
// in elements); out: f32 [R]. R >= 1, n >= 0. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad shape,
// cudaErrorNotSupported if the CUDA driver builds no tensor map).
extern "C" int eal_dotprod_exact(const void* a, long long lda, const void* b, long long ldb,
                                 void* out, long long R, int n, void* stream) {
  if (R < 1 || n < 0 || lda < n || ldb < n || (R + ROWS - 1) / ROWS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  DotArgs d{{}, {}, static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
            static_cast<float*>(out), R, n};
  // tensor copies: 16-byte aligned rows, row coordinates that fit int32
  const bool tensor = n > 0 && lda % 4 == 0 && ldb % 4 == 0 && aligned16(a) && aligned16(b) &&
                      R <= 0x7fffffffLL;
  if (tensor && !(tensor_map_2d(&d.map_a, d.a, n, R, lda, ROWS) &&
                  tensor_map_2d(&d.map_b, d.b, n, R, ldb, ROWS)))
    return static_cast<int>(cudaErrorNotSupported);
  auto kernel = tensor ? dotprod_exact_kernel<true> : dotprod_exact_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as fit on the card at once, at most one per group
  const long long groups = (R + ROWS - 1) / ROWS;
  const int sms = sm_count();
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  const dim3 grid(static_cast<unsigned>(groups < resident ? groups : resident));
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(d);
  return static_cast<int>(cudaGetLastError());
}

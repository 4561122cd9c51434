// Exact sequential f32 recurrences for sm_90a: the DF-I biquad of the
// resampler's exact mode and the second-order recurrence of ops/scan.py,
// bit-exact against the JAX package.
//
// Replaces the lax.scan of biquad_apply(exact=True)
// (esp_audio_libs_tpu/ops/biquad.py:197-223) and iir2_sequential
// (esp_audio_libs_tpu/ops/scan.py:41-61). There they are XLA, not Pallas;
// eager PyTorch would launch a dozen ops per sample step.
//
// Numerics: every product, sum and difference is its own PTX instruction
// with an explicit rounding modifier (mul.rn / add.rn / sub.rn), which the
// compiler never contracts into an FMA, in the C reference's order:
//   DF-I, second order: y = ((((x*a0) + i1*a1) + i2*a2) - b1*o1) - b2*o2
//   DF-I, first order:  y = ((x*a0) + i1*a1) - b1*o1
//   iir2:               y = (f - p1*y1) - p2*y2
// The .ftz forms flush subnormal operands and results to a zero of their
// own sign: the JAX package's rule (XLA on the CPU runs with flush-to-zero
// and denormals-are-zero; ops/scan.py). The carry copies inputs and outputs
// with their bits unchanged. With valid_len, steps t >= valid_len leave the
// carry frozen and still emit an output computed from it.
//
// What bounds it: each lane (one row of [N, T], t contiguous) is a chain of
// T dependent steps, and the resampler has only 512-4096 lanes. Only b1*o1
// and two subtractions carry from step to step, about 12 cycles; the input
// side acc = ((x*a0) + i1*a1) + i2*a2 depends on no output, and b2*o2 is
// known a step early. So the chain thread does nothing but the chain, and
// then (H100 80GB HBM3, 700 W; tools/kernel_variants.py --biquad):
// - at [4096, 8192] (the main pre-filter chunk) a launch moves x and y once,
//   268 MB: 0.080 ms at 3.35 TB/s. It took 0.108 ms; with its copies
//   dropped (a probe) 0.063 ms, the chain's 8192 steps at about 15
//   cycles. The bulk copies of 128 SMs bound it: bytes;
// - at 512 lanes (the upsampling post-filter, [256, 2, 22588]) and for one
//   lane, the chain's latency bounds it, which no SM count shortens:
//   0.170 ms, 7.5 ns a step, against 0.028 ms of bytes.
//
// The design:
// - A block serves `rows` lanes (at most 32) with four warps. The chain
//   warp (warp 0) runs lane j's recurrence on thread j; three helper warps
//   do the rest: LOAD (warp 1) copies x tiles into a shared-memory ring,
//   INPUT (warp 2) computes each step's acc in place, STORE (warp 3) writes
//   the y tiles out and, at the end, the new state.
// - `rows` is the fewest lanes per block (a power of two) that give every
//   SM at most one block: 32 at [4096, T], 4 at the upsampling
//   post-filter's 512 lanes. A block's copies then stay far below what one
//   SM can move while its chain runs (32 rows of 22588 steps on 16 SMs
//   took 2.2 times as long as 4 rows on 128 SMs), and many lanes still fill
//   the chain warp.
// - Time is cut into tiles of S = 128 steps (64 took 25 % longer at the
//   main shape: shorter copies, twice the hand-offs). A ring stage holds
//   one tile of the block's rows ([32][S + 4] f32: 16-byte rows, so a
//   16-byte access by eight consecutive threads to eight consecutive rows
//   hits 32 distinct banks). A tile passes through its stage in place:
//   x (LOAD) -> acc (INPUT) -> y (CHAIN) -> global (STORE), then the stage
//   is free for tile k + NST.
// - When T is a multiple of 4 and x, y are 16-byte aligned (the resampler's
//   shapes: T = 8192, and 22588 in the upsampling post-filter), LOAD and
//   STORE move each row's segment of a tile with one Hopper bulk copy (the
//   TMA engine: cp.async.bulk, S * 4 bytes or the ragged tail), thread r
//   for row r; STORE frees the stage once its copy has read it. Otherwise
//   every element is a 4-byte cp.async in and a 4-byte store out, coalesced
//   along t. Ring rows past the block's lanes, and a tail tile's positions
//   past T, are not copied: their stale values reach only outputs that are
//   never stored (the carry does not advance past valid_len <= T).
// - CHAIN, per tile: wait for the stage's acc, move the tile's S acc values
//   into registers (16-byte shared loads, so no load sits behind the chain's
//   own stores; with loads inside the chain a step took about 44 ns), run
//   the S steps, write y in place with 16-byte shared stores, fence them
//   for the bulk copy (fence.proxy.async) and signal STORE. Its step loop
//   holds no global-memory instruction and no address arithmetic.
//
// Hand-off: one mbarrier per stage and edge (x full, acc full, y full,
// stage empty), each expecting the 32 threads of its producing warp, except
// "x full" with bulk copies: one arrival (LOAD's thread 0, with
// expect_tx of the tile's bytes) and the copies' completed bytes; with
// 4-byte copies LOAD's 32 threads arrive through
// cp.async.mbarrier.arrive.noinc, once their copies have landed. Tile k
// uses stage k % NST and waits for phase parity (k / NST) & 1; LOAD waits
// on "empty" for tile k - NST (none for k < NST). Why nothing can hang or
// read a stale phase:
// - every role runs the same ntiles = ceil(T / S) iterations and arrives
//   exactly once per tile on its outgoing barrier, whatever T, valid_len,
//   rows or the number of valid lanes: ragged ends (T not a tile multiple,
//   lanes past n, valid_len 0, 1 or T) change only how many bytes are
//   copied (and expected), which outputs are stored and which steps advance
//   the carry, never the control flow of a role;
// - a barrier can complete phase m + 1 only after its waiter consumed phase
//   m (refilling a stage needs its "empty" arrival, which comes after every
//   role finished the stage's previous tile), so no waiter is ever two
//   phases behind and parity cannot alias;
// - after the loops one __syncthreads hands the final carry to STORE; no
//   load is then in flight (INPUT has consumed every tile), and STORE waits
//   for its last bulk copies before it leaves its loop.

#include <cuda_runtime.h>

#include <cstdint>

#include "exact_async.cuh"

namespace {

constexpr int LANES = 32;             // lanes per block: one per chain thread
constexpr int S = 128;                // steps per tile
constexpr int NST = 8;                // ring stages
constexpr int PITCH = S + 4;          // floats per ring row (16-byte rows)
constexpr int STAGE = LANES * PITCH;  // floats per ring stage
constexpr int THREADS = 4 * LANES;    // chain, load, input, store warps
constexpr int SMEM_BYTES = NST * STAGE * 4;
constexpr int CHUNKS = S / 4;         // 16-byte chunks per tile row

enum Mode { DF1_SECOND = 0, DF1_FIRST = 1, IIR2 = 2 };
enum Warp { CHAIN = 0, LOAD = 1, INPUT = 2, STORE = 3 };
enum Edge { X_FULL = 0, ACC_FULL = 1, Y_FULL = 2, EMPTY = 3 };

struct RecArgs {
  const float* x;          // [n, T] input (f for iir2)
  float* y;                // [n, T]
  const float* coef;       // DF-I: [5] (stride 0) or [n, 5]; iir2: p1 [n], p2 [n]
  int coef_stride;
  const float* state_in;   // DF-I: [4, n] (i1, i2, o1, o2); iir2: [2, n] (y1, y2)
  float* state_out;
  long long n;
  int T;
  int valid_len;           // DF-I only, in [0, T]
  int rows;                // lanes per block: a power of two, at most LANES
};

struct Ring {
  float* buf;                  // [NST][LANES][PITCH]
  uint64_t (*bar)[NST];        // [edge][stage]
  __device__ float* stage(int k) const { return buf + (k % NST) * STAGE; }
  __device__ void wait(Edge e, int k) const { mbar_wait(&bar[e][k % NST], (k / NST) & 1); }
  __device__ void arrive(Edge e, int k) const { mbar_arrive(&bar[e][k % NST]); }
};

// The block's lanes that exist: rows, or fewer in the last block.
__device__ __forceinline__ int block_lanes(const RecArgs& a, long long lane0) {
  return static_cast<int>(min(static_cast<long long>(a.rows), a.n - lane0));
}

// LOAD: x tiles of the block's rows into the ring, k = 0 .. ntiles - 1.
// BULK: thread r copies row r's segment of the tile with one bulk copy
// (X_FULL expects one arrival and the segments' bytes); otherwise every
// element is a 4-byte cp.async, zero-filled past T (X_FULL expects the 32
// threads' cp.async arrivals).
template <bool BULK>
__device__ void load_role(const RecArgs& a, long long lane0, int ntiles, const Ring& ring) {
  const int j = threadIdx.x % 32;
  const int lanes = block_lanes(a, lane0);
  for (int k = 0; k < ntiles; ++k) {
    if (k >= NST) mbar_wait(&ring.bar[EMPTY][k % NST], ((k / NST) - 1) & 1);
    float* st = ring.stage(k);
    const int t0 = k * S;
    if (BULK) {
      const uint32_t bytes = 4u * min(S, a.T - t0);   // T % 4 == 0: a multiple of 16
      if (j == 0) mbar_arrive_expect_tx(&ring.bar[X_FULL][k % NST], lanes * bytes);
      __syncwarp();
      if (j < lanes)
        bulk_load(st + j * PITCH, a.x + (lane0 + j) * a.T + t0, bytes, &ring.bar[X_FULL][k % NST]);
    } else {
#pragma unroll 4
      for (int r = 0; r < lanes; ++r) {
        const long long row = lane0 + r;
#pragma unroll
        for (int h = 0; h < S; h += 32) {
          const int t = t0 + h + j;
          cp_async4(st + r * PITCH + h + j, t < a.T ? a.x + row * a.T + t : a.x, t < a.T);
        }
      }
      cp_async_arrive(&ring.bar[X_FULL][k % NST]);
    }
  }
  if (!BULK) asm volatile("cp.async.wait_all;" ::: "memory");
}

// The input side of one tile row in place, x -> acc; (i1, i2) the carry.
// FREEZE: the tile reaches valid_len, and steps t >= vl keep the carry.
template <int MODE, bool FREEZE>
__device__ __forceinline__ void input_tile(float* rp, int t0, int vl, float a0, float a1,
                                           float a2, float& i1, float& i2) {
#pragma unroll 4
  for (int q = 0; q < CHUNKS; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(rp + 4 * q);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u] = add_ftz(mul_ftz(xs[u], a0), mul_ftz(i1, a1));
      if (MODE == DF1_SECOND) acc[u] = add_ftz(acc[u], mul_ftz(i2, a2));
      if (!FREEZE || t0 + 4 * q + u < vl) {
        i2 = i1;
        i1 = xs[u];
      }
    }
    *reinterpret_cast<float4*>(rp + 4 * q) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// INPUT: thread j turns ring row j (lane `row`, real when `mine`) from x
// into acc in place; (i1, i2) is its carry.
template <int MODE>
__device__ void input_role(const RecArgs& a, long long row, bool mine, int ntiles, int vl,
                           const Ring& ring, float& i1, float& i2) {
  const int j = threadIdx.x % 32;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (MODE != IIR2 && mine) {
    const float* c = a.coef + row * a.coef_stride;
    a0 = c[0];
    a1 = c[1];
    a2 = c[2];
  }
  for (int k = 0; k < ntiles; ++k) {
    ring.wait(X_FULL, k);
    if (MODE != IIR2) {          // iir2: acc is f itself (sub.ftz flushes it)
      float* rp = ring.stage(k) + j * PITCH;
      const int t0 = k * S;
      if (t0 + S <= vl)
        input_tile<MODE, false>(rp, t0, vl, a0, a1, a2, i1, i2);
      else
        input_tile<MODE, true>(rp, t0, vl, a0, a1, a2, i1, i2);
    }
    ring.arrive(ACC_FULL, k);
  }
}

// The S steps of one tile row: acc in registers, y written in place over
// it; (o1, o2) the carry. FREEZE as in input_tile.
template <int MODE, bool FREEZE>
__device__ __forceinline__ void chain_tile(float* rp, const float (&acc)[S], int t0, int vl,
                                           float b1, float b2, float& o1, float& o2) {
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    float out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float y = sub_ftz(acc[4 * q + u], mul_ftz(b1, o1));
      if (MODE != DF1_FIRST) y = sub_ftz(y, mul_ftz(b2, o2));
      out[u] = y;
      if (!FREEZE || t0 + 4 * q + u < vl) {
        o2 = o1;
        o1 = y;
      }
    }
    *reinterpret_cast<float4*>(rp + 4 * q) = make_float4(out[0], out[1], out[2], out[3]);
  }
}

// CHAIN: thread j runs ring row j's recurrence (lane `row`, real when
// `mine`) over the acc ring; (o1, o2) is its carry. {b1, b2} are {p1, p2}
// for iir2.
template <int MODE>
__device__ void chain_role(const RecArgs& a, long long row, bool mine, int ntiles, int vl,
                           const Ring& ring, float& o1, float& o2) {
  const int j = threadIdx.x % 32;
  float b1 = 0.f, b2 = 0.f;
  if (mine) {
    if (MODE == IIR2) {
      b1 = a.coef[row];
      b2 = a.coef[a.n + row];
    } else {
      const float* c = a.coef + row * a.coef_stride;
      b1 = c[3];
      b2 = c[4];
    }
  }
  for (int k = 0; k < ntiles; ++k) {
    ring.wait(ACC_FULL, k);
    float* rp = ring.stage(k) + j * PITCH;
    float acc[S];
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(rp + 4 * q);
      acc[4 * q] = v.x;
      acc[4 * q + 1] = v.y;
      acc[4 * q + 2] = v.z;
      acc[4 * q + 3] = v.w;
    }
    const int t0 = k * S;
    if (t0 + S <= vl)
      chain_tile<MODE, false>(rp, acc, t0, vl, b1, b2, o1, o2);
    else
      chain_tile<MODE, true>(rp, acc, t0, vl, b1, b2, o1, o2);
    // y is in the stage; order these writes before STORE's bulk copy reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    ring.arrive(Y_FULL, k);
  }
}

// STORE: the y tiles of the block's rows out of the ring. BULK: thread r
// writes row r's segment with one bulk copy and frees the stage once the
// copy has read it; otherwise 4-byte stores, coalesced along t.
template <bool BULK>
__device__ void store_role(const RecArgs& a, long long lane0, int ntiles, const Ring& ring) {
  const int j = threadIdx.x % 32;
  const int lanes = block_lanes(a, lane0);
  for (int k = 0; k < ntiles; ++k) {
    ring.wait(Y_FULL, k);
    const float* st = ring.stage(k);
    const int t0 = k * S;
    if (BULK) {
      if (j < lanes) {
        bulk_store(a.y + (lane0 + j) * a.T + t0, st + j * PITCH, 4u * min(S, a.T - t0));
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < lanes; ++r) {
        const long long row = lane0 + r;
#pragma unroll
        for (int h = 0; h < S; h += 32) {
          const int t = t0 + h + j;
          if (t < a.T) a.y[row * a.T + t] = st[r * PITCH + h + j];
        }
      }
    }
    ring.arrive(EMPTY, k);
  }
  if (BULK) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int MODE, bool BULK>
__global__ void __launch_bounds__(THREADS) recurrence_kernel(RecArgs a) {
  extern __shared__ __align__(16) float ring_buf[];
  __shared__ uint64_t bars[4][NST];
  __shared__ float carry[4][LANES];   // i1, i2, o1, o2 (iir2: -, -, y1, y2)
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const long long lane0 = static_cast<long long>(blockIdx.x) * a.rows;
  const long long row = lane0 + j;
  const bool mine = j < a.rows && row < a.n;     // thread j's lane exists
  const int ntiles = (a.T + S - 1) / S;
  const int vl = MODE == IIR2 ? a.T : a.valid_len;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int s = 0; s < NST; ++s) mbar_init(&bars[e][s], BULK && e == X_FULL ? 1 : LANES);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const Ring ring{ring_buf, bars};

  if (warp == LOAD) {
    load_role<BULK>(a, lane0, ntiles, ring);
  } else if (warp == INPUT) {
    float i1 = 0.f, i2 = 0.f;
    if (MODE != IIR2 && mine) {
      i1 = a.state_in[row];
      i2 = a.state_in[a.n + row];
    }
    input_role<MODE>(a, row, mine, ntiles, vl, ring, i1, i2);
    carry[0][j] = i1;
    carry[1][j] = i2;
  } else if (warp == CHAIN) {
    float o1 = 0.f, o2 = 0.f;
    if (mine) {
      const long long base = MODE == IIR2 ? 0 : 2 * a.n;
      o1 = a.state_in[base + row];
      o2 = a.state_in[base + a.n + row];
    }
    chain_role<MODE>(a, row, mine, ntiles, vl, ring, o1, o2);
    carry[2][j] = o1;
    carry[3][j] = o2;
  } else {
    store_role<BULK>(a, lane0, ntiles, ring);
  }
  __syncthreads();
  if (warp == STORE && mine) {
    if (MODE == IIR2) {
      a.state_out[row] = carry[2][j];
      a.state_out[a.n + row] = carry[3][j];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) a.state_out[q * a.n + row] = carry[q][j];
    }
  }
}

template <int MODE, bool BULK>
cudaError_t launch_as(const RecArgs& a, unsigned blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      recurrence_kernel<MODE, BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  recurrence_kernel<MODE, BULK><<<blocks, THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(RecArgs a, cudaStream_t stream) {
  // Lanes per block: the fewest (a power of two) that still give every SM
  // at most one block, so that few lanes spread their copies over many SMs
  // (512 lanes: 4 per block on 128 SMs) and many fill the chain warp.
  const long long sms = sm_count();
  a.rows = 1;
  while (a.rows < LANES && a.rows * sms < a.n) a.rows *= 2;
  const long long blocks = (a.n + a.rows - 1) / a.rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // bulk copies need 16-byte rows: T a multiple of 4, x and y aligned
  const bool bulk = a.T % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.y)) & 15) == 0;
  return bulk ? launch_as<MODE, true>(a, static_cast<unsigned>(blocks), stream)
              : launch_as<MODE, false>(a, static_cast<unsigned>(blocks), stream);
}

}  // namespace

// x, y f32 [n, T]; coef f32 [5] (coef_stride 0) or [n, 5] (coef_stride 5),
// {a0, a1, a2, b1, b2}; state_in, state_out f32 [4, n] (in_d1, in_d2,
// out_d1, out_d2). valid_len in [0, T]. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int eal_biquad_df1(const void* x, void* y, const void* coef, int coef_stride,
                              const void* state_in, void* state_out, long long n, int T,
                              int valid_len, int first_order, void* stream) {
  if (n < 1 || T < 1 || valid_len < 0 || valid_len > T || (coef_stride != 0 && coef_stride != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  RecArgs a{static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<const float*>(coef), coef_stride,
            static_cast<const float*>(state_in), static_cast<float*>(state_out), n, T,
            valid_len, LANES};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(first_order ? launch<DF1_FIRST>(a, s) : launch<DF1_SECOND>(a, s));
}

// f, y f32 [n, T]; p f32 [2, n] (p1, p2); state_in, state_out f32 [2, n]
// (y[-1], y[-2] in; y[T-1], y[T-2] out). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int eal_iir2_sequential(const void* f, void* y, const void* p, const void* state_in,
                                   void* state_out, long long n, int T, void* stream) {
  if (n < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  RecArgs a{static_cast<const float*>(f), static_cast<float*>(y), static_cast<const float*>(p),
            0, static_cast<const float*>(state_in), static_cast<float*>(state_out), n, T, T,
            LANES};
  return static_cast<int>(launch<IIR2>(a, static_cast<cudaStream_t>(stream)));
}

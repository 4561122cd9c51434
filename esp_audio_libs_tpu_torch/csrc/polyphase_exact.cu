// Exact polyphase kernel for sm_90a: the resampler's bit-exact contraction,
// ordered dot products per output, bit-exact against the JAX package.
//
// Replaces the per-tap lax.scan of polyphase_apply(exact=True)
// (esp_audio_libs_tpu/ops/polyphase.py:236-260). There it is XLA, not
// Pallas: taps passes over the whole [rows, T] output, each a gather and a
// multiply-add. In one pass this kernel gathers the windows, computes both
// ordered dots, the lerp and the mode select:
//   acc1 = ((+0 + x[w0]*f1[0]) + x[w0+1]*f1[1]) + ...   (k = 0 .. taps-1)
//   acc2 likewise with f2 (only with compute_second)
//   mode 0: x[w0 + half - 1] (a copy); mode 1: acc1;
//   otherwise: acc2*w + acc1*(1 - w) with (1 - w) rounded first
//   (acc1 when compute_second is off).
// Every product and sum is its own mul.rn / add.rn instruction (never
// contracted into an FMA), in the C reference's order; the .ftz forms flush
// subnormal operands and results to a zero of their own sign, the JAX
// package's rule (ops/scan.py). Window samples outside [0, L) read NaN, as
// the JAX package's jnp.take fills them past the end.
//
// What bounds it, at the resampler's main shape (4096 rows of 8264
// samples, 2981 outputs, 64 taps, two dots; NVIDIA H100 80GB HBM3, 700 W):
// - bytes: x once, the outputs once, 184,306,148 B: 0.0550 ms at 3.35 TB/s;
// - operations: 4 separately rounded FP32 ops per tap, output and row,
//   3.15 G. Exact mode forbids the FMA, so each op takes a whole FP32 issue
//   slot: at 132 SMs x 128 lanes x 1980 MHz that is 0.094 ms, the FMA-free
//   issue floor (an estimate that counts no load, address or loop
//   instruction). Half the bytes bound (0.110 ms) lies only 17 % above it:
//   no FMA-free kernel reaches that share.
// - shared memory: each x sample a thread loads feeds only its 4 ops, so
//   the x loads alone ask as many shared-memory cycles as the FP32 ops ask
//   issue cycles (32 lanes x 4 bytes a cycle against 128 FP32 lanes), and a
//   bank conflict doubles them.
// Measured (tools/kernel_variants.py --polyphase-exact): 0.270 ms a launch
// here and 0.171 ms at the upsampling shape (512 rows, 22588 outputs),
// against 0.325 / 0.227 ms for the first design, which restaged the bank
// and its window in each of 12,288 blocks (0.184 ms of fixed work with its
// dots cut to one tap). Loading two outputs' shared window samples once
// (one thread per output pair) did not pay: 0.280 / 0.219 ms.
//
// The design:
// - Persistent blocks: as many as are resident (occupancy query), each
//   walking work items of R rows x TT = 128 outputs in a fixed order. The
//   filterbank is staged once per block (row pitch taps + 4: 16-byte rows,
//   rows 4 banks apart), not once per item.
// - Warp roles. Warp 0 is the producer: per item it reads the tile's grid
//   (4 outputs a lane) into the fill's slot in shared memory, finds the
//   span of the windows still to do by warp shuffles, and fills a ring
//   stage with the R rows' span: one Hopper bulk copy (cp.async.bulk) per
//   row, its base rounded down to 16 bytes (the rounding is folded into
//   each consumer's offset) and its bytes counted on the stage's mbarrier;
//   samples outside [0, L) it writes as NaN. Rows whose pitch or base is
//   not 16-byte aligned take 4-byte cp.async instead. Warps 1-4 are
//   consumers, one thread per output: they wait for the stage, run both
//   dots from shared memory with their 2R accumulators in registers,
//   release the stage and store. The producer fills the next stage
//   meanwhile, so copies and grid reads overlap the dots.
// - Spread: consumer lanes take outputs 1, 2 or 4 positions apart, the
//   warps filling the gaps. The producer picks, per item, the spread whose
//   windows meet the fewest bank conflicts. On an earlier version with 8
//   rows a fixed spread of 4 took the main shape, where neighbouring
//   windows lie 2.76 samples apart, from 0.319 to 0.233 ms; at upsampling
//   neighbouring windows often coincide and broadcast, and 1 wins.
// - R = 16 rows on the fast path: each coefficient load serves 16 rows
//   (that earlier version: 0.269 ms against 0.319 ms with 8 rows).
// - A tile whose windows span more than a stage (very low ratios) takes
//   several fills, each from the lowest window still to do; every window
//   fits one fill (the stage holds at least taps + 189 samples past a
//   16-byte base). The producer marks an item's last fill, so both roles
//   run the same fills.
// - The fast path (taps a multiple of 4 and at most 256, filterbank within
//   64 KB: the resampler's configurations) has a compile-time stage pitch,
//   so every shared load takes an immediate offset from one register, and
//   loads 4 coefficients of a row at once. Other shapes keep a runtime
//   pitch and 8 rows; a filterbank over 64 KB is read through the
//   read-only cache.
//
// Hand-off: stage s of fill f has a "full" mbarrier (the producer's 32
// lanes arrive, lane 0 with expect_tx of the fill's bulk bytes) and an
// "empty" one (one arrival per consumer warp). Fill f waits for parity
// (f / NST) & 1; the producer refills a stage only after its "empty" phase
// for fill f - NST. Both roles walk the same items and the same fills (the
// fill's last flag ends an item), so every phase is filled and consumed
// once and parity cannot alias.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "exact_async.cuh"

namespace {

constexpr int TT = 128;                // outputs per work item, one consumer thread each
constexpr int CONSUMERS = TT / 32;     // consumer warps
constexpr int THREADS = 32 + TT;       // the producer warp and the consumers
constexpr int NST = 2;                 // ring stages
constexpr int R = 16;                  // rows per work item on the fast path
constexpr int R_GENERAL = 8;           // rows per work item otherwise
constexpr int FAST_PITCH = 448;        // floats per staged row on the fast path
constexpr int FAST_TAPS_MAX = 256;
constexpr int SLACK = 448;             // a general stage row holds taps + SLACK samples
constexpr int BANK_SMEM_MAX = 64 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

enum Kind { FAST = 0, SMEM_BANK = 1, GLOBAL_BANK = 2 };

struct PolyArgs {
  const float* x;          // [M, L] history + chunk
  const float* filters;    // [nf, taps]
  const int32_t* win0;     // [T] window starts in x coordinates
  const int32_t* idx1;     // [T] filterbank rows
  const int32_t* idx2;     // [T]
  const float* weight;     // [T] lerp weights
  const int32_t* mode;     // [T] 0 copy, 1 one dot, else lerp
  float* out;              // [M, T]
  long long M;
  int L, T, nf, taps, half;
  int pitch;               // floats per staged row (the stage holds pitch - 3 past a window start)
  int fpitch;              // floats per staged filterbank row
  int bank_floats;         // floats of the staged filterbank (0: read from global)
  int nst;                 // ring stages in use (general kinds: 1 when two do not fit)
  long long tiles, items;
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether a window starting at w0 fits the fill whose stage starts at gbase.
__device__ __forceinline__ bool fits(int w0, int taps, int gbase, int cap) {
  return static_cast<long long>(w0) + taps <= static_cast<long long>(gbase) + cap;
}

// What the producer tells the consumers about one fill of a ring stage; an
// item's first fill also carries the tile's grid, by tile position.
struct Fill {
  int gbase;               // the stage's first sample, in x coordinates
  int last;                // the item's last fill
  int spread;              // consumer lane j of warp q takes position j*spread + ...
  int win0[TT], idx1[TT], idx2[TT], mode[TT];   // mode 0 past T
  float weight[TT];
};

// The tile position of consumer thread j (warp q = j / 32, lane j % 32)
// under spread s (1, 2 or 4): lanes s positions apart, the warps filling
// the gaps, so every position has one thread.
__device__ __forceinline__ int tile_position(int j, int s) {
  const int q = j / 32;
  return (j % 32) * s + q % s + 32 * s * (q / s);
}

// The spread (1, 2 or 4) under which consumer warp 0's lanes read their
// windows with the fewest shared-memory wavefronts: distinct windows on
// one bank serialise, equal ones broadcast. w/pend: the producer lane's
// four outputs (tile positions 32q + lane). Speed only: any spread is exact.
__device__ __forceinline__ int pick_spread(const int (&w)[TT / 32], const bool (&pend)[TT / 32]) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  int best = 1, best_cost = 33;
#pragma unroll
  for (int s = 1; s <= 4; s *= 2) {
    const int p = tile_position(lane, s);
    int v = 0;
    bool ok = false;
#pragma unroll
    for (int q = 0; q < TT / 32; ++q) {
      const int vq = __shfl_sync(all, w[q], p % 32);
      const bool oq = __shfl_sync(all, static_cast<int>(pend[q]), p % 32) != 0;
      if (p / 32 == q) {
        v = vq;
        ok = oq;
      }
    }
    const unsigned same = __match_any_sync(all, ok ? v : -1 - lane);
    const bool leader = ok && __ffs(same) - 1 == lane;
    const unsigned bank = __match_any_sync(all, leader ? (v & 31) : 32 + lane);
    const int cost = warp_max(leader ? __popc(bank) : 0);
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// PRODUCER (warp 0): for each of the block's items, the fills of its
// windows' span, rows m0 .. m0 + rows - 1, into the ring.
template <bool BULK, int KIND, int RR>
__device__ __forceinline__ void producer(const PolyArgs& a, float* ring, uint64_t* full,
                                         uint64_t* empty, Fill* fills) {
  const int lane = threadIdx.x % 32;
  const int pitch = KIND == FAST ? FAST_PITCH : a.pitch;
  const int cap = pitch - 3;           // a 16-byte rounded base still leaves cap samples
  const int nst = KIND == FAST ? NST : a.nst;
  uint32_t fill = 0;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int t0 = static_cast<int>(item % a.tiles) * TT;
    const long long m0 = item / a.tiles * RR;
    const int rows = static_cast<int>(min(static_cast<long long>(RR), a.M - m0));
    int w[TT / 32], i1[TT / 32], i2[TT / 32], md[TT / 32];
    float wt[TT / 32];
    bool pend[TT / 32];
#pragma unroll
    for (int q = 0; q < TT / 32; ++q) {
      const int t = t0 + 32 * q + lane;
      const bool in = t < a.T;
      md[q] = in ? a.mode[t] : 0;
      w[q] = in ? a.win0[t] : 0;
      i1[q] = in ? a.idx1[t] : 0;
      i2[q] = in ? a.idx2[t] : 0;
      wt[q] = in ? a.weight[t] : 0.0f;
      pend[q] = md[q] != 0;
    }
    const int spread = pick_spread(w, pend);
    bool left = true, first = true;
    while (left) {
      int base = INT_MAX;
#pragma unroll
      for (int q = 0; q < TT / 32; ++q)
        if (pend[q]) base = min(base, w[q]);
      base = warp_min(base);
      const int gbase = base & ~3;     // rounded down to 16 bytes
      int hi = INT_MIN;
      left = false;
      if (base != INT_MAX) {
#pragma unroll
        for (int q = 0; q < TT / 32; ++q) {
          if (pend[q] && fits(w[q], a.taps, gbase, cap)) {
            hi = max(hi, w[q] + a.taps);
            pend[q] = false;
          }
          left |= pend[q];
        }
      }
      hi = warp_max(hi);
      left = __any_sync(0xffffffffu, left);

      const int s = fill % nst;
      if (fill >= static_cast<uint32_t>(nst)) mbar_wait(&empty[s], ((fill / nst) - 1) & 1);
      Fill& f = fills[s];
      if (first) {
#pragma unroll
        for (int q = 0; q < TT / 32; ++q) {
          f.win0[32 * q + lane] = w[q];
          f.idx1[32 * q + lane] = i1[q];
          f.idx2[32 * q + lane] = i2[q];
          f.mode[32 * q + lane] = md[q];
          f.weight[32 * q + lane] = wt[q];
        }
        first = false;
      }
      float* st = ring + static_cast<size_t>(s) * RR * pitch;
      uint32_t bytes = 0;
      int lo = 0, hc = 0;
      if (base != INT_MAX) {
        const int hie = BULK ? (hi + 3) & ~3 : hi;   // the fill's end, 16-byte rounded in bulk
        lo = min(max(gbase, 0), hie);  // [lo, hc): the part inside [0, L)
        hc = max(min(hie, a.L), lo);
        // samples outside [0, L) read NaN
        for (int r = 0; r < rows; ++r) {
          float* row = st + r * pitch - gbase;
          for (int c = gbase + lane; c < lo; c += 32) row[c] = NAN;
          for (int c = hc + lane; c < hie; c += 32) row[c] = NAN;
        }
        if (BULK) {
          bytes = static_cast<uint32_t>(rows) * (hc - lo) * 4u;
        } else {
          for (int r = 0; r < rows; ++r) {
            const float* src = a.x + (m0 + r) * a.L;
            float* row = st + r * pitch - gbase;
            for (int c = lo + lane; c < hc; c += 32) cp_async4(row + c, src + c, true);
          }
          asm volatile("cp.async.wait_all;" ::: "memory");
        }
      }
      if (lane == 0) {
        f.gbase = gbase;
        f.last = left ? 0 : 1;
        f.spread = spread;
        mbar_arrive_expect_tx(&full[s], bytes);
      } else {
        mbar_arrive(&full[s]);
      }
      if (BULK && bytes != 0 && lane < rows)
        bulk_load(st + lane * pitch + (lo - gbase), a.x + (m0 + lane) * a.L + lo,
                  (hc - lo) * 4u, &full[s]);
      ++fill;
    }
  }
}

// The two ordered dots of one output over RR rows; xw: the window's first
// sample in row 0 of the stage, f1/f2 its filterbank rows.
template <bool SECOND, int KIND, int RR>
__device__ __forceinline__ void dots(const float* xw, int pitch, const float* f1, const float* f2,
                                     int taps, float (&acc1)[RR], float (&acc2)[RR]) {
  if (KIND == FAST) {
#pragma unroll 2
    for (int k = 0; k < taps; k += 4) {
      const float4 v1 = *reinterpret_cast<const float4*>(f1 + k);
      const float4 v2 = SECOND ? *reinterpret_cast<const float4*>(f2 + k) : v1;
      const float c1[4] = {v1.x, v1.y, v1.z, v1.w};
      const float c2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float xv = xw[r * FAST_PITCH + k + u];
          acc1[r] = add_ftz(acc1[r], mul_ftz(xv, c1[u]));
          if (SECOND) acc2[r] = add_ftz(acc2[r], mul_ftz(xv, c2[u]));
        }
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < taps; ++k) {
      const float c1 = KIND == GLOBAL_BANK ? __ldg(f1 + k) : f1[k];
      const float c2 = SECOND ? (KIND == GLOBAL_BANK ? __ldg(f2 + k) : f2[k]) : 0.0f;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float xv = xw[r * pitch + k];
        acc1[r] = add_ftz(acc1[r], mul_ftz(xv, c1));
        if (SECOND) acc2[r] = add_ftz(acc2[r], mul_ftz(xv, c2));
      }
    }
  }
}

// CONSUMERS (warps 1 .. CONSUMERS): consumer thread j computes the output
// at its tile position (under the item's spread) over the item's rows and
// stores it.
template <bool SECOND, int KIND, int RR>
__device__ __forceinline__ void consumer(const PolyArgs& a, const float* fs, const float* ring,
                                         uint64_t* full, uint64_t* empty, const Fill* fills) {
  const int j = threadIdx.x - 32, lane = threadIdx.x % 32;
  const int pitch = KIND == FAST ? FAST_PITCH : a.pitch;
  const int cap = pitch - 3;
  const int nst = KIND == FAST ? NST : a.nst;
  const float* bank = KIND == GLOBAL_BANK ? a.filters : fs;
  const int fpitch = KIND == GLOBAL_BANK ? a.taps : a.fpitch;
  uint32_t fill = 0;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const long long m0 = item / a.tiles * RR;
    const int rows = static_cast<int>(min(static_cast<long long>(RR), a.M - m0));
    int t = 0, w0 = 0, i1 = 0, i2 = 0, md = 0;
    float w = 0.f;
    bool pending = false, first = true, last = false;
    float acc1[RR], acc2[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) acc1[r] = acc2[r] = 0.0f;
    while (!last) {
      const int s = fill % nst;
      mbar_wait(&full[s], (fill / nst) & 1);
      const Fill& f = fills[s];
      const int gbase = f.gbase;
      if (first) {
        const int pos = tile_position(j, f.spread);
        t = static_cast<int>(item % a.tiles) * TT + pos;
        w0 = f.win0[pos];
        i1 = f.idx1[pos];
        i2 = f.idx2[pos];
        md = f.mode[pos];
        w = f.weight[pos];
        pending = md != 0;
        first = false;
      }
      last = f.last != 0;
      if (pending && fits(w0, a.taps, gbase, cap)) {
        const float* xw = ring + static_cast<size_t>(s) * RR * pitch + (w0 - gbase);
        dots<SECOND, KIND, RR>(xw, pitch, bank + static_cast<size_t>(i1) * fpitch,
                               bank + static_cast<size_t>(i2) * fpitch, a.taps, acc1, acc2);
        pending = false;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++fill;
    }
    if (t >= a.T) continue;
    const float omw = sub_ftz(1.0f, w);
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      if (r >= rows) break;
      const long long m = m0 + r;
      float v;
      if (md == 0) {
        const long long col = static_cast<long long>(w0) + a.half - 1;
        v = col >= 0 && col < a.L ? a.x[m * a.L + col] : NAN;
      } else if (md == 1 || !SECOND) {
        v = acc1[r];
      } else {
        v = add_ftz(mul_ftz(acc2[r], w), mul_ftz(acc1[r], omw));
      }
      a.out[m * a.T + t] = v;
    }
  }
}

template <bool SECOND, bool BULK, int KIND, int RR>
__global__ void __launch_bounds__(THREADS) polyphase_exact_kernel(PolyArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[NST], empty[NST];
  __shared__ Fill fills[NST];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* fs = smem;                    // [nf][fpitch], staged once
  float* ring = smem + a.bank_floats;  // [nst][RR][pitch]
  if (KIND != GLOBAL_BANK) {
    for (int r = warp; r < a.nf; r += THREADS / 32)
      for (int k = lane; k < a.taps; k += 32)
        fs[r * a.fpitch + k] = a.filters[static_cast<size_t>(r) * a.taps + k];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    producer<BULK, KIND, RR>(a, ring, full, empty, fills);
  else
    consumer<SECOND, KIND, RR>(a, fs, ring, full, empty, fills);
}

template <bool SECOND, bool BULK, int KIND, int RR>
cudaError_t launch_as(PolyArgs a, cudaStream_t stream) {
  a.tiles = (a.T + TT - 1) / TT;
  a.items = a.tiles * ((a.M + RR - 1) / RR);
  const size_t bytes = sizeof(float) * (static_cast<size_t>(a.bank_floats) +
                                        static_cast<size_t>(a.nst) * RR * a.pitch);
  auto kernel = polyphase_exact_kernel<SECOND, BULK, KIND, RR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(max(per_sm, 1)) * max(sm_count(), 1);
  const long long blocks = min(a.items, resident);
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool SECOND, int KIND, int RR>
cudaError_t launch_kind(const PolyArgs& a, cudaStream_t stream) {
  // bulk copies need 16-byte rows: L a multiple of 4 and x aligned
  const bool bulk = a.L % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  return bulk ? launch_as<SECOND, true, KIND, RR>(a, stream)
              : launch_as<SECOND, false, KIND, RR>(a, stream);
}

template <bool SECOND>
cudaError_t launch(PolyArgs a, cudaStream_t stream) {
  const bool fast = a.taps % 4 == 0 && a.taps <= FAST_TAPS_MAX &&
                    static_cast<long long>(a.nf) * (a.taps + 4) * 4 <= BANK_SMEM_MAX;
  if (fast) {
    a.pitch = FAST_PITCH;
    a.fpitch = a.taps + 4;               // 16-byte rows; rows 4 banks apart
    a.bank_floats = a.nf * a.fpitch;
    a.nst = NST;
    return launch_kind<SECOND, FAST, R>(a, stream);
  }
  a.pitch = (a.taps + SLACK + 31) / 32 * 32;
  a.fpitch = a.taps + 1;                 // threads on different rows hit different banks
  const bool bank_smem = static_cast<long long>(a.nf) * a.fpitch * 4 <= BANK_SMEM_MAX;
  a.bank_floats = bank_smem ? (a.nf * a.fpitch + 3) / 4 * 4 : 0;
  const long long stage = static_cast<long long>(R_GENERAL) * a.pitch * 4;
  a.nst = a.bank_floats * 4LL + NST * stage <= SMEM_MAX ? NST : 1;
  if (a.bank_floats * 4LL + a.nst * stage > SMEM_MAX) return cudaErrorInvalidValue;
  return bank_smem ? launch_kind<SECOND, SMEM_BANK, R_GENERAL>(a, stream)
                   : launch_kind<SECOND, GLOBAL_BANK, R_GENERAL>(a, stream);
}

}  // namespace

// x f32 [M, L]; filters f32 [nf, taps]; win0, idx1, idx2, mode int32 [T];
// weight f32 [T]; out f32 [M, T]. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int eal_polyphase_exact(const void* x, const void* filters, const void* win0,
                                   const void* idx1, const void* idx2, const void* weight,
                                   const void* mode, void* out, long long M, int L, int T, int nf,
                                   int taps, int half, int compute_second, void* stream) {
  if (M < 1 || L < 1 || T < 1 || nf < 1 || taps < 1 || taps > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  PolyArgs a{};
  a.x = static_cast<const float*>(x);
  a.filters = static_cast<const float*>(filters);
  a.win0 = static_cast<const int32_t*>(win0);
  a.idx1 = static_cast<const int32_t*>(idx1);
  a.idx2 = static_cast<const int32_t*>(idx2);
  a.weight = static_cast<const float*>(weight);
  a.mode = static_cast<const int32_t*>(mode);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.L = L;
  a.T = T;
  a.nf = nf;
  a.taps = taps;
  a.half = half;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(compute_second ? launch<true>(a, s) : launch<false>(a, s));
}

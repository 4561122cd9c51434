// FLAC frame kernel for sm_90a: the device back-end of a bucket of FLAC
// frames, byte-exact against the JAX package.
//
// Replaces _frame_kernel_body and _frame_kernel_esc
// (esp_audio_libs_tpu/models/flac.py:40-94) and the lax.scan of
// esp_audio_libs_tpu/ops/lpc.py:43-156. There it is XLA, not Pallas: a scan
// over time whose step is a window dot per lane. In one launch this kernel
// does the int8 escape fixup, the LPC/fixed restoration, the wasted-bits
// shift, stereo decorrelation, the interleave and the byte packing.
//
// What bounds it: the recurrence y[t] = x[t] + (sum_k c[k] y[t-W+k]) >> shift
// is sequential in t, one chain of T = 4096 steps per (frame, channel)
// lane, and the lanes are few: 1024 in one launch of the composed chain's
// dispatch (512 frames x 2 channels), 8192 in its whole bucket. A block
// restores 32 lanes with one warp, so a launch of 1024 lanes runs 32 chain
// warps on 32 of the card's 132 SMs, and its time is the time of one lane's
// chain, not of its bytes (12.8 MB at the dispatch shape: 0.0038 ms at
// 3.35 TB/s). The design keeps each step of that chain short and everything
// else off the thread that runs it:
//
// (a) Transposed-form recurrence. Every lane keeps W running sums in
//     registers, one for each of its next W steps, on a circular index that
//     the unroll by W makes static. Once y[t] is known, c[k] y[t] goes into
//     step t + W - k's sum (the sum step t used starts again as c[0] y[t],
//     for step t + W). The sums wrap modulo 2^32 (use64 = false) or 2^64
//     (use64 = true) and the shift comes after the whole sum, so any order of
//     the products gives the reference's bits. With 32-bit sums step t + 1's
//     sum takes c[W-1] x[t] early and c[W-1] pred[t] last (c y = c x + c
//     pred modulo 2^32): the chain from one step's sum to the next is one
//     shift and one multiply-add, and the other products of a step are
//     independent of it. (64-bit sums keep the add of x on the chain: y
//     wraps to 32 bits.) The compiler already summed the first version's
//     dot in parallel, so the transposed form alone changed little; what
//     the chain warp waited on was its helpers.
// (b) Decoupled helpers. A block has four warps: the chain warp (REC) and
//     three helpers. LOAD brings residual tiles of S steps into shared
//     memory as int32 and puts back the escapes: 16-byte loads issued one
//     tile ahead where rows are 16-byte aligned (Hopper bulk copies of each
//     row's 64-byte segment, 32 per tile into a staging ring, were 32 %
//     slower at the dispatch shape), element loads otherwise. Two PACK warps
//     undo the stereo decorrelation, interleave and write the bytes (16-bit
//     stereo: 4 steps per thread, 16-byte loads and stores). A tile passes
//     through a ring of NST stages, LOAD -> REC -> PACK, paced by mbarriers,
//     so the chain warp waits on no helper while the ring is full. REC reads
//     and writes 4 samples per shared-memory access, loads each 4 while the
//     4 before them run, and applies the wasted bits on the ALU slots its
//     multiply-adds leave free. (The first version ended every tile with
//     one barrier of the whole block, so a tile took as long as its chain
//     and the helpers' load and pack in turn.)
// (c) Lane placement from the lane count (two or four 32-lane groups per
//     block where the lanes outnumber the SMs, the chain warps on warps 0 ..
//     groups - 1) was tried and dropped: the main path's 1024 lanes take one
//     group per block on 32 SMs whatever the rule, and at the 8192-lane
//     bucket it measured the same (PERF.md). Which scheduler a warp
//     lands on is not documented.
//
// Integer semantics (those of XLA, which the JAX package runs on):
// - use64 = false: the dot wraps in 32 bits (uint32 sums), then an
//   arithmetic >> of the int32; use64 = true: exact 32x32->64 products summed
//   in 64 bits, >> in 64 bits, then the low 32 bits.
// - A >> by an amount outside [0, bits) fills with the sign (the amount is
//   clamped to bits - 1); a << by 32 or more gives 0. Every add and left
//   shift runs on unsigned values, so nothing relies on signed overflow.
// - Lanes with t < order emit their warm-up samples verbatim; the warm-up
//   samples still feed later sums.
// - Escapes: int32 flat positions (f * C + c) * T + t into the int8 plane,
//   sorted ascending, padded with an out-of-range position. LOAD's thread r
//   finds row r's first escape by binary search and consumes the rest in
//   order, ESC at a time, tile by tile.
//
// Hand-off (stage s = k % NST of tile k, phase parity (k / NST) & 1): FULL
// (loaded and escaped: LOAD's 32 threads), DONE (restored: REC's 32), EMPTY
// (packed: PACK's 64). Every role runs the same ceil(T / S) tiles and
// arrives once per tile whatever the lanes or T, and a stage is refilled
// only after every role has finished its previous tile, so no waiter falls
// two phases behind. Rows past the block's lanes hold zeros and a tail
// tile's steps past T zeros; neither reaches a stored output.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "exact_async.cuh"

namespace {

constexpr int LANES = 32;        // lanes per block: one per REC thread
constexpr int NST = 4;           // ring stages
constexpr int PACKERS = 64;      // PACK threads per block
constexpr int THREADS = 4 * 32;  // REC, LOAD and two PACK warps
constexpr int ESC = 4;           // escapes LOAD's threads hold in registers

enum Warp { REC = 0, LOAD = 1, PACK = 2 };   // PACK: warps 2 and 3
enum Edge { FULL = 0, DONE = 1, EMPTY = 2 };

template <int W>
struct Tile {
  static constexpr int S = W == 12 ? 48 : 64;   // steps per tile: a multiple of W and of 16
  static constexpr int PITCH = S + 4;           // words per row: 16-byte rows, PITCH / 4 odd
};

// Shared memory of a block: the ring's int32 tiles, the barriers and the
// frames' channel assignments.
template <int W>
constexpr int SMEM = NST * LANES * Tile<W>::PITCH * 4 + 3 * NST * 8 + LANES * 4;

template <bool USE64>
struct Acc { using T = uint32_t; };
template <>
struct Acc<true> { using T = unsigned long long; };

struct FrameArgs {
  const void* data;           // [F, C, T] int8 / int16 / int32
  const int32_t* esc_pos;     // [n_esc] sorted flat positions (int8 plane only)
  const int32_t* esc_val;     // [n_esc]
  int n_esc;
  const int32_t* coeffs;      // [F, C, 32] oldest-first, zero-padded
  const int32_t* order;       // [F, C]
  const int32_t* shift;       // [F, C]
  const int32_t* wasted;      // [F, C]
  const int32_t* ca;          // [F] channel assignment
  uint8_t* out;               // [F, T * C * nbytes]
  int F, C, T;
  int nbytes, lshift, bias;   // packing: bytes per sample, left shift, unsigned bias
  bool vec;                   // rows 16-byte aligned: 16-byte loads
};

// A block's lanes, tiles and shared memory.
template <int W, typename R>
struct Block {
  int fpb, lanes, f0, ntiles;     // frames per block, existing lanes, first frame, tiles
  long long lane0;                // first lane
  int32_t* work;                  // [NST][LANES][PITCH] int32 tiles
  uint64_t* bar;                  // [3][NST]
  int32_t* ca;                    // [LANES] channel assignment of each frame

  __device__ int32_t* stage(int k) const { return work + (k % NST) * LANES * Tile<W>::PITCH; }
  __device__ uint64_t* edge(Edge e, int k) const { return bar + e * NST + k % NST; }
  __device__ void wait(Edge e, int k) const { mbar_wait(edge(e, k), (k / NST) & 1); }
  __device__ void arrive(Edge e, int k) const { mbar_arrive(edge(e, k)); }
};

// y << wasted: wshift = wasted & 31, wkeep = 0 for a wasted of 32 or more.
__device__ __forceinline__ int32_t unwaste(int32_t y, int wshift, uint32_t wkeep) {
  return static_cast<int32_t>((static_cast<uint32_t>(y) << wshift) & wkeep);
}

// a * b + c modulo 2^32, opaque to the compiler (which would otherwise fold
// c[W-1] x + c[W-1] pred back into c[W-1] y and lengthen the chain).
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One step of the transposed recurrence: acc[u] holds step t's whole sum;
// y[t] enters the sums of steps t + 1 .. t + W (step t + 1's first), and
// acc[u] starts again as step t + W's. With 32-bit sums, c y = c x + c pred
// modulo 2^32, so step t + 1's sum takes c[W-1] x early and c[W-1] pred
// last: the chain from one step's sum to the next is one shift and one
// multiply-add. (64-bit sums take c[W-1] y: y wraps to 32 bits.)
template <int W, bool USE64, bool WARM>
__device__ __forceinline__ int32_t step(typename Acc<USE64>::T (&acc)[W], const int32_t (&c)[W],
                                        int u, int32_t x, int sh, int t, int order) {
  int32_t pred;
  if constexpr (USE64)
    pred = static_cast<int32_t>(static_cast<uint32_t>(static_cast<long long>(acc[u]) >> sh));
  else
    pred = static_cast<int32_t>(acc[u]) >> sh;
  int32_t y = static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(pred));
  if (WARM && t < order) y = x;
  if constexpr (USE64) {
#pragma unroll
    for (int j = 1; j < W; ++j)
      acc[(u + j) % W] += static_cast<unsigned long long>(static_cast<long long>(y) * c[W - j]);
    acc[u] = static_cast<unsigned long long>(static_cast<long long>(y) * c[0]);
  } else {
    const uint32_t c1 = static_cast<uint32_t>(c[W - 1]);
    if (WARM)
      acc[(u + 1) % W] += static_cast<uint32_t>(y) * c1;
    else
      acc[(u + 1) % W] = mad_lo(c1, static_cast<uint32_t>(pred),
                                acc[(u + 1) % W] + static_cast<uint32_t>(x) * c1);
#pragma unroll
    for (int j = 2; j < W; ++j)
      acc[(u + j) % W] += static_cast<uint32_t>(y) * static_cast<uint32_t>(c[W - j]);
    acc[u] = static_cast<uint32_t>(y) * static_cast<uint32_t>(c[0]);
  }
  return y;
}

// Restore one tile row of S steps in place: x on entry, y << wasted on exit
// (wshift, wkeep: the wasted bits), four samples per 16-byte shared-memory
// access, each 4 samples loaded while the 4 before them run.
template <int W, bool USE64, bool WARM>
__device__ __forceinline__ void restore_tile(int32_t* row, typename Acc<USE64>::T (&acc)[W],
                                             const int32_t (&c)[W], int sh, int order, int t0,
                                             int wshift, uint32_t wkeep) {
  constexpr int S = Tile<W>::S;
  int4 next = *reinterpret_cast<const int4*>(row);
#pragma unroll 1
  for (int b = 0; b < S; b += W) {
#pragma unroll
    for (int u = 0; u < W; u += 4) {
      int4 v = next;
      // the next 4 samples (past the tile's end: the row's 4 padding words)
      next = *reinterpret_cast<const int4*>(row + b + u + 4);
      const int t = t0 + b + u;
      v.x = step<W, USE64, WARM>(acc, c, u, v.x, sh, t, order);
      v.y = step<W, USE64, WARM>(acc, c, u + 1, v.y, sh, t + 1, order);
      v.z = step<W, USE64, WARM>(acc, c, u + 2, v.z, sh, t + 2, order);
      v.w = step<W, USE64, WARM>(acc, c, u + 3, v.w, sh, t + 3, order);
      *reinterpret_cast<int4*>(row + b + u) =
          make_int4(unwaste(v.x, wshift, wkeep), unwaste(v.y, wshift, wkeep),
                    unwaste(v.z, wshift, wkeep), unwaste(v.w, wshift, wkeep));
    }
  }
}

// REC: thread j restores lane lane0 + j, tile by tile.
template <int W, bool USE64, typename R>
__device__ void rec_role(const FrameArgs& a, const Block<W, R>& g, int j) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH;
  const long long lane = g.lane0 + j;
  const bool live = j < g.lanes;
  int order = 0, sh = 0, wasted = 0;
  if (live) {
    order = a.order[lane];
    sh = a.shift[lane];
    wasted = a.wasted[lane];
  }
  constexpr unsigned BITS = USE64 ? 64u : 32u;
  if (static_cast<unsigned>(sh) >= BITS) sh = BITS - 1;
  const int wshift = wasted & 31;
  const uint32_t wkeep = static_cast<unsigned>(wasted) >= 32u ? 0u : 0xffffffffu;
  int32_t c[W];
  typename Acc<USE64>::T acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int i = k - (W - order);    // c[k] multiplies the sample at lag W - k
    c[k] = (live && i >= 0 && i < order) ? a.coeffs[lane * 32 + i] : 0;
    acc[k] = 0;
  }
  for (int k = 0; k < g.ntiles; ++k) {
    g.wait(FULL, k);
    int32_t* row = g.stage(k) + j * PITCH;
    if (k == 0)   // orders are at most 32 < S: warm-up lies in tile 0
      restore_tile<W, USE64, true>(row, acc, c, sh, order, 0, wshift, wkeep);
    else
      restore_tile<W, USE64, false>(row, acc, c, sh, order, k * S, wshift, wkeep);
    g.arrive(DONE, k);
  }
}

// Element e of a 16-byte chunk of R values, sign-extended.
template <typename R>
__device__ __forceinline__ int32_t chunk_elem(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[e * sizeof(R) / 4];
  const int bit = (e * sizeof(R) % 4) * 8;
  if constexpr (sizeof(R) == 1) return static_cast<int8_t>(word >> bit);
  else if constexpr (sizeof(R) == 2) return static_cast<int16_t>(word >> bit);
  else return static_cast<int32_t>(word);
}

// The ESC escapes from index cur on (independent loads, one latency);
// positions past the last are INT_MAX (a bucket holds fewer samples).
__device__ __forceinline__ void esc_window(const FrameArgs& a, int cur, int32_t (&pos)[ESC],
                                           int32_t (&val)[ESC]) {
#pragma unroll
  for (int i = 0; i < ESC; ++i) {
    const bool in = cur + i < a.n_esc;
    pos[i] = in ? a.esc_pos[cur + i] : INT_MAX;
    val[i] = in ? a.esc_val[cur + i] : 0;
  }
}

// Tile k's 16-byte chunks of the block's rows, CPR per thread (zero past
// the plane).
template <int W, typename R, int CPR>
__device__ __forceinline__ void load_chunks(const FrameArgs& a, const Block<W, R>& g, int k, int j,
                                            uint4 (&v)[CPR]) {
  constexpr int VEC = 16 / sizeof(R);
  const R* __restrict__ data = static_cast<const R*>(a.data);
#pragma unroll
  for (int i = 0; i < CPR; ++i) {
    const int q = j + i * LANES, r = q / CPR, t = k * Tile<W>::S + (q - r * CPR) * VEC;
    v[i] = make_uint4(0, 0, 0, 0);
    if (r < g.lanes && t < a.T)
      v[i] = __ldg(reinterpret_cast<const uint4*>(data + (g.lane0 + r) * a.T + t));
  }
}

// LOAD: tile k of the residual plane into stage k as int32, escapes put back.
template <int W, typename R>
__device__ void load_role(const FrameArgs& a, const Block<W, R>& g, int j) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH;
  constexpr int VEC = 16 / sizeof(R);   // elements per 16-byte chunk
  constexpr int CPR = S / VEC;          // 16-byte chunks per row and tile
  const R* __restrict__ data = static_cast<const R*>(a.data);
  uint4 ahead[CPR];                     // the next tile's 16-byte chunks
  if (a.vec) load_chunks(a, g, 0, j, ahead);
  // row j's escape cursor: the index of its next escape, and the window of
  // ESC escapes from there
  int cur = a.n_esc;
  if (a.n_esc > 0 && j < g.lanes) {
    const long long base = (g.lane0 + j) * a.T;
    int lo = 0, hi = a.n_esc;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.esc_pos[mid] < base) lo = mid + 1; else hi = mid;
    }
    cur = lo;
  }
  int32_t pos[ESC], val[ESC];
  esc_window(a, cur, pos, val);
  for (int k = 0; k < g.ntiles; ++k) {
    const int t0 = k * S;
    int32_t* tile = g.stage(k);
    if (k >= NST) mbar_wait(g.edge(EMPTY, k), ((k / NST) - 1) & 1);
    if (a.vec) {   // 16-byte loads, one tile ahead
      uint4 now[CPR];
#pragma unroll
      for (int i = 0; i < CPR; ++i) now[i] = ahead[i];
      if (k + 1 < g.ntiles) load_chunks(a, g, k + 1, j, ahead);
#pragma unroll
      for (int i = 0; i < CPR; ++i) {
        const int q = j + i * LANES, r = q / CPR, c0 = (q - r * CPR) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<int4*>(tile + r * PITCH + c0 + e) =
              make_int4(chunk_elem<R>(now[i], e), chunk_elem<R>(now[i], e + 1),
                        chunk_elem<R>(now[i], e + 2), chunk_elem<R>(now[i], e + 3));
      }
    } else {   // element loads, coalesced along t, BATCH in flight at a time
      constexpr int BATCH = 8;
#pragma unroll 1
      for (int i0 = 0; i0 < S; i0 += BATCH) {
        int32_t v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int q = j + (i0 + i) * LANES, r = q / S, t = t0 + q - r * S;
          v[i] = (r < g.lanes && t < a.T) ? static_cast<int32_t>(data[(g.lane0 + r) * a.T + t]) : 0;
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int q = j + (i0 + i) * LANES, r = q / S;
          tile[r * PITCH + q - r * S] = v[i];
        }
      }
    }
    __syncwarp();   // each row is whole before its escapes land
    if (j < g.lanes) {   // positions ascend: the window's escapes in this tile are a prefix
      const long long base = (g.lane0 + j) * a.T + t0;
      const long long end = (g.lane0 + j) * a.T + min(t0 + S, a.T);
      for (;;) {
        int used = 0;
#pragma unroll
        for (int i = 0; i < ESC; ++i)
          if (pos[i] < end) {
            tile[j * PITCH + static_cast<int>(pos[i] - base)] = val[i];
            used = i + 1;
          }
        if (used == 0) break;
        cur += used;
        esc_window(a, cur, pos, val);
        if (used < ESC) break;
      }
    }
    g.arrive(FULL, k);
  }
}

// Undo stereo decorrelation of one sample pair (reference
// flac_decoder.cpp:691-706): 8 left/side, 9 right/side, 10 mid/side.
__device__ __forceinline__ void decorrelate(int32_t& a, int32_t& b, int ca) {
  const uint32_t u0 = static_cast<uint32_t>(a), u1 = static_cast<uint32_t>(b);
  if (ca == 8) {
    b = static_cast<int32_t>(u0 - u1);
  } else if (ca == 9) {
    a = static_cast<int32_t>(u0 + u1);
  } else if (ca == 10) {
    const uint32_t r = u0 - static_cast<uint32_t>(b >> 1);
    a = static_cast<int32_t>(r + u1);
    b = static_cast<int32_t>(r);
  }
}

// One 16-bit stereo sample pair as the 4 bytes of its step.
__device__ __forceinline__ uint32_t pack16x2(int32_t v0, int32_t v1, int ca, const FrameArgs& a) {
  decorrelate(v0, v1, ca);
  const uint32_t s0 = (static_cast<uint32_t>(v0) + a.bias) << a.lshift;
  const uint32_t s1 = (static_cast<uint32_t>(v1) + a.bias) << a.lshift;
  return (s0 & 0xffffu) | (s1 << 16);
}

// PACK: decorrelation, interleave and bytes of each restored tile (thread p
// of PACKERS; coalesced along t). The main path's 16-bit stereo takes 4
// steps per thread: two 16-byte shared loads, one 16-byte store.
template <int W, typename R>
__device__ void pack_role(const FrameArgs& a, const Block<W, R>& g, int p) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH, Q = S / 4;
  const int C = a.C, T = a.T;
  const int step_bytes = C * a.nbytes;
  const int nf = min(g.fpb, a.F - g.f0);   // the block's existing frames
  const bool quads = C == 2 && a.nbytes == 2 && T % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  for (int k = 0; k < g.ntiles; ++k) {
    g.wait(DONE, k);
    const int32_t* __restrict__ tile = g.stage(k);
    const int t0 = k * S;
    if (quads) {
#pragma unroll 4
      for (int idx = p; idx < nf * Q; idx += PACKERS) {
        const int fl = idx / Q, q = idx - fl * Q, t = t0 + 4 * q;
        if (t >= T) continue;
        const int4 x0 = *reinterpret_cast<const int4*>(tile + 2 * fl * PITCH + 4 * q);
        const int4 x1 = *reinterpret_cast<const int4*>(tile + (2 * fl + 1) * PITCH + 4 * q);
        const int ca = g.ca[fl];
        const uint4 w = make_uint4(pack16x2(x0.x, x1.x, ca, a), pack16x2(x0.y, x1.y, ca, a),
                                   pack16x2(x0.z, x1.z, ca, a), pack16x2(x0.w, x1.w, ca, a));
        *reinterpret_cast<uint4*>(a.out + (static_cast<long long>(g.f0 + fl) * T + t) * 4) = w;
      }
      g.arrive(EMPTY, k);
      continue;
    }
    for (int idx = p; idx < nf * S; idx += PACKERS) {
      const int fl = idx / S, s = idx - fl * S;
      const int t = t0 + s;
      if (t >= T) continue;
      const int32_t* col = tile + fl * C * PITCH + s;
      uint8_t* dst = a.out + (static_cast<long long>(g.f0 + fl) * T + t) * step_bytes;
      int32_t v0 = col[0], v1 = 0;
      if (C == 2) {
        v1 = col[PITCH];
        decorrelate(v0, v1, g.ca[fl]);
      }
      for (int ch = 0; ch < C; ++ch) {
        const int32_t v = ch == 0 ? v0 : (C == 2 ? v1 : col[ch * PITCH]);
        const uint32_t smp = (static_cast<uint32_t>(v) + a.bias) << a.lshift;
        for (int bt = 0; bt < a.nbytes; ++bt)
          dst[ch * a.nbytes + bt] = static_cast<uint8_t>(smp >> (8 * bt));
      }
    }
    g.arrive(EMPTY, k);
  }
}

template <int W, bool USE64, typename R>
__global__ void __launch_bounds__(THREADS) flac_frame_kernel(const FrameArgs a) {
  constexpr int S = Tile<W>::S;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  Block<W, R> g;
  g.fpb = LANES / a.C;
  g.f0 = blockIdx.x * g.fpb;
  g.lane0 = static_cast<long long>(g.f0) * a.C;
  g.lanes = static_cast<int>(min(static_cast<long long>(g.fpb * a.C),
                                 static_cast<long long>(a.F) * a.C - g.lane0));
  g.ntiles = (a.T + S - 1) / S;
  g.work = reinterpret_cast<int32_t*>(smem);
  g.bar = reinterpret_cast<uint64_t*>(smem + NST * LANES * Tile<W>::PITCH * 4);
  g.ca = reinterpret_cast<int32_t*>(g.bar + 3 * NST);
  if (warp == REC) {   // thread j: frame j's channel assignment, read by PACK
    g.ca[j] = j < g.fpb && g.f0 + j < a.F ? a.ca[g.f0 + j] : 0;
    if (j == 0) {
      const int count[3] = {LANES, LANES, PACKERS};
      for (int e = 0; e < 3; ++e)
        for (int s = 0; s < NST; ++s) mbar_init(g.bar + e * NST + s, count[e]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if (warp == REC)
    rec_role<W, USE64, R>(a, g, j);
  else if (warp == LOAD)
    load_role<W, R>(a, g, j);
  else
    pack_role<W, R>(a, g, (warp - PACK) * 32 + j);
}

template <int W, bool USE64, typename R>
cudaError_t launch(FrameArgs a, cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(a.F) + LANES / a.C - 1) / (LANES / a.C);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 16-byte loads need 16-byte row segments: T * sizeof(R) and the base aligned
  a.vec = (static_cast<long long>(a.T) * sizeof(R)) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a.data) % 16 == 0;
  constexpr int smem = SMEM<W>;
  const cudaError_t err = cudaFuncSetAttribute(
      flac_frame_kernel<W, USE64, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flac_frame_kernel<W, USE64, R><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int W, bool USE64>
cudaError_t by_residual(int res_kind, const FrameArgs& a, cudaStream_t stream) {
  switch (res_kind) {
    case 0: return launch<W, USE64, int8_t>(a, stream);
    case 1: return launch<W, USE64, int16_t>(a, stream);
    case 2: return launch<W, USE64, int32_t>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int W>
cudaError_t by_accumulator(bool use64, int res_kind, const FrameArgs& a, cudaStream_t stream) {
  return use64 ? by_residual<W, true>(res_kind, a, stream)
               : by_residual<W, false>(res_kind, a, stream);
}

}  // namespace

// data [F, C, T] of int8 (res_kind 0), int16 (1) or int32 (2); esc_pos /
// esc_val int32 [n_esc] (n_esc = 0: none; int8 plane only); coeffs int32
// [F, C, 32]; order, shift, wasted int32 [F, C]; ca int32 [F]; out uint8
// [F, T * C * nbytes]. max_order is the order class (4, 8, 12, 16 or 32) and
// covers every order. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int eal_flac_frame(const void* data, int res_kind, const void* esc_pos,
                              const void* esc_val, int n_esc, const void* coeffs,
                              const void* order, const void* shift, const void* wasted,
                              const void* ca, void* out, int F, int C, int T, int nbytes,
                              int lshift, int bias, int use64, int max_order, void* stream) {
  if (C < 1 || C > LANES || F < 1 || T < 1 || nbytes < 1 || nbytes > 4 || lshift < 0 ||
      lshift > 31 || (n_esc > 0 && res_kind != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FrameArgs a;
  a.data = data;
  a.esc_pos = static_cast<const int32_t*>(esc_pos);
  a.esc_val = static_cast<const int32_t*>(esc_val);
  a.n_esc = n_esc;
  a.coeffs = static_cast<const int32_t*>(coeffs);
  a.order = static_cast<const int32_t*>(order);
  a.shift = static_cast<const int32_t*>(shift);
  a.wasted = static_cast<const int32_t*>(wasted);
  a.ca = static_cast<const int32_t*>(ca);
  a.out = static_cast<uint8_t*>(out);
  a.F = F;
  a.C = C;
  a.T = T;
  a.nbytes = nbytes;
  a.lshift = lshift;
  a.bias = bias;
  a.vec = false;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (max_order) {
    case 4: err = by_accumulator<4>(use64 != 0, res_kind, a, s); break;
    case 8: err = by_accumulator<8>(use64 != 0, res_kind, a, s); break;
    case 12: err = by_accumulator<12>(use64 != 0, res_kind, a, s); break;
    case 16: err = by_accumulator<16>(use64 != 0, res_kind, a, s); break;
    case 32: err = by_accumulator<32>(use64 != 0, res_kind, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
// is sequential in t, so one lane's T steps form a dependency chain: a
// multiply-add with the newest sample, the shift and the add of x
// (T x that latency is the serial floor). The data moved (residual plane at
// its width, packed PCM) is small beside it at the card's 3.35 TB/s, and
// the lanes (frames x channels of a bucket) are few: 8192 at the composed
// 256-stream shape, about two warps per SM. So the design keeps the chain
// short and keeps everything else off the thread that runs it:
//
// - One thread per (frame, channel) lane restores that lane's samples in
//   order. A block holds REC = 32 such threads (one warp, whole frames:
//   32 / C frames) and HELP = 96 helper threads (three warps).
// - Time is cut into tiles of S steps (64, or 96 for the 12 class). The
//   helpers load tile k of the residual plane into shared memory (16-byte
//   loads along t where rows are 16-byte aligned, all in flight at once,
//   widened to int32) and apply its escapes, while the recurrence
//   warp restores tile k-1 in place and the helpers pack tile k-2
//   (decorrelate, interleave, bytes; coalesced along t). Three buffers
//   rotate, one block-wide barrier per tile. The two roles run separate
//   loops, so neither holds the other's state in registers.
// - The recurrence is specialised on the order class W in {4, 8, 12, 16, 32},
//   on the accumulator width and on the residual width. The aligned
//   coefficients and the window of the last W samples live in registers; the
//   time loop is unrolled by W over a circular window, so every window index
//   is static (no local memory). The newest sample enters the dot last, so
//   only one multiply-add, the shift and the add sit on the chain.
//
// Integer semantics (those of XLA, which the JAX package runs on):
// - use64 = false: the dot wraps in 32 bits (uint32 sum), then an arithmetic
//   >> of the int32; use64 = true: exact 32x32->64 products summed in 64
//   bits, >> in 64 bits, then the low 32 bits.
// - A >> by an amount outside [0, bits) fills with the sign (the amount is
//   clamped to bits - 1); a << by 32 or more gives 0. Every add and left
//   shift runs on unsigned values, so nothing relies on signed overflow.
// - Lanes with t < order emit their warm-up samples verbatim.
// - Escapes: int32 flat positions (f * C + c) * T + t into the int8 plane,
//   sorted ascending, padded with an out-of-range position. Each row's
//   helper finds its first escape by binary search and consumes the rest in
//   order, tile by tile.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int REC = 32;     // recurrence threads: one warp, one lane each
constexpr int HELP = 96;    // helper threads: loads, escape fixup, packing
constexpr int NTHREADS = REC + HELP;
constexpr int NBUF = 3;     // tile buffers: loading, restoring, packing

template <int W>
struct Tile {
  static constexpr int S = W == 12 ? 96 : 64;   // steps per tile: a multiple of W and of 16
  static constexpr int PITCH = S + 1;           // words per row: conflict-free columns
};

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
};

// A barrier of the helper warps alone (named barrier 1; not the .aligned
// form, since the recurrence warp does not execute it).
__device__ __forceinline__ void helper_barrier() {
  asm volatile("barrier.sync 1, %0;" ::"n"(HELP) : "memory");
}

// Restore one tile of S steps of one lane in place: row[s] holds x on entry
// and y << wasted on exit. win holds the last W restored samples, sample
// t - W + k in slot (t + k) % W; c[k] multiplies slot k's sample at lag W - k.
template <int W, bool USE64, bool WARM>
__device__ __forceinline__ void restore_tile(int32_t* row, int32_t (&win)[W], const int32_t (&c)[W],
                                             int sh, int order, int t0, int wshift,
                                             uint32_t wkeep) {
  constexpr int S = Tile<W>::S;
#pragma unroll 1
  for (int b = 0; b < S; b += W) {
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int32_t x = row[b + u];
      int32_t pred;
      if constexpr (USE64) {
        unsigned long long acc = 0;
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc += static_cast<unsigned long long>(static_cast<long long>(win[(u + k) % W]) * c[k]);
        pred = static_cast<int32_t>(static_cast<uint32_t>(static_cast<long long>(acc) >> sh));
      } else {
        uint32_t acc = 0;
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc += static_cast<uint32_t>(win[(u + k) % W]) * static_cast<uint32_t>(c[k]);
        pred = static_cast<int32_t>(acc) >> sh;
      }
      int32_t y = static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(pred));
      if (WARM && t0 + b + u < order) y = x;
      win[u] = y;
      row[b + u] = static_cast<int32_t>((static_cast<uint32_t>(y) << wshift) & wkeep);
    }
  }
}

// Element e of a 16-byte chunk of R values, sign-extended (e is static
// after unrolling, so the chunk stays in registers).
template <typename R>
__device__ __forceinline__ int32_t chunk_elem(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[e * sizeof(R) / 4];
  const int bit = (e * sizeof(R) % 4) * 8;
  if constexpr (sizeof(R) == 1) return static_cast<int8_t>(word >> bit);
  else if constexpr (sizeof(R) == 2) return static_cast<int16_t>(word >> bit);
  else return static_cast<int32_t>(word);
}

// The helpers load tile [lanes_b x S] of the residual plane into shared
// memory, widened to int32, zero past the plane. vec: rows start on 16-byte
// boundaries (T * sizeof(R) and the base a multiple of 16), so every load is
// one 16-byte chunk, and all of a thread's loads are issued before any is
// used; otherwise element loads, eight at a time.
template <int W, typename R>
__device__ __forceinline__ void load_tile(int32_t* tile, const R* __restrict__ data, bool vec,
                                          int h, int lanes_b, long long lane0, long long nlanes,
                                          int t0, int T) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH;
  if (vec) {
    constexpr int VEC = 16 / sizeof(R);          // elements per chunk
    constexpr int CPR = S / VEC;                 // chunks per row
    constexpr int PER = (REC * CPR + HELP - 1) / HELP;
    uint4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = h + i * HELP, r = q / CPR, t = t0 + (q - r * CPR) * VEC;
      v[i] = make_uint4(0, 0, 0, 0);
      if (r < lanes_b && lane0 + r < nlanes && t < T)
        v[i] = __ldg(reinterpret_cast<const uint4*>(data + (lane0 + r) * T + t));
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = h + i * HELP, r = q / CPR, c0 = (q - r * CPR) * VEC;
      if (r < lanes_b) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tile[r * PITCH + c0 + e] = chunk_elem<R>(v[i], e);
      }
    }
  } else {   // element loads, BATCH in flight at a time (bounded registers)
    constexpr int PER = (REC * S + HELP - 1) / HELP, BATCH = 8;
#pragma unroll 1
    for (int i0 = 0; i0 < PER; i0 += BATCH) {
      int32_t v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int q = h + (i0 + j) * HELP, r = q / S, t = t0 + q - r * S;
        v[j] = 0;
        if (i0 + j < PER && r < lanes_b && lane0 + r < nlanes && t < T)
          v[j] = data[(lane0 + r) * T + t];
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int q = h + (i0 + j) * HELP, r = q / S;
        if (i0 + j < PER && r < lanes_b) tile[r * PITCH + q - r * S] = v[j];
      }
    }
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

// Where a block's lanes and tiles lie.
struct BlockShape {
  int fpb, lanes_b, f0, ntiles;   // frames, lanes, first frame, tiles
  long long lane0, nlanes;        // first lane, lanes of the bucket
};

// The barrier that ends each tile iteration, for all NTHREADS threads. The
// two roles run separate loops (so each keeps only its own state in
// registers) and reach it from different places: hence the non-.aligned
// form of barrier 0.
__device__ __forceinline__ void tile_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

// The recurrence warp: thread tid restores lane lane0 + tid, tile k - 1 in
// iteration k.
template <int W, bool USE64>
__device__ __forceinline__ void recurrence_role(const FrameArgs& a, const BlockShape& b,
                                                int32_t (*buf)[REC * Tile<W>::PITCH], int tid) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH;
  const long long lane = b.lane0 + tid;
  const bool live = tid < b.lanes_b && lane < b.nlanes;
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
  int32_t c[W], win[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = k - (W - order);
    c[k] = (live && j >= 0 && j < order) ? a.coeffs[lane * 32 + j] : 0;
    win[k] = 0;
  }
  for (int k = 0; k < b.ntiles + 2; ++k) {
    if (k >= 1 && k <= b.ntiles) {
      int32_t* row = buf[(k - 1) % NBUF] + tid * PITCH;
      if (k == 1)
        restore_tile<W, USE64, true>(row, win, c, sh, order, 0, wshift, wkeep);
      else
        restore_tile<W, USE64, false>(row, win, c, sh, order, (k - 1) * S, wshift, wkeep);
    }
    tile_barrier();
  }
}

// The helper warps: in iteration k, load tile k (and put back its escapes)
// and pack tile k - 2.
template <int W, typename R>
__device__ __forceinline__ void helper_role(const FrameArgs& a, const BlockShape& b,
                                            int32_t (*buf)[REC * Tile<W>::PITCH], int h) {
  constexpr int S = Tile<W>::S, PITCH = Tile<W>::PITCH;
  const int C = a.C, T = a.T;
  const R* __restrict__ data = static_cast<const R*>(a.data);
  const bool vec = (static_cast<long long>(T) * sizeof(R)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.data) % 16 == 0;
  // escape cursor of row h (helpers h < lanes_b) and the position it points at
  int cur = 0;
  long long next_pos = LLONG_MAX;
  if (a.n_esc > 0 && h < b.lanes_b) {
    const long long base = (b.lane0 + h) * T;
    int lo = 0, hi = a.n_esc;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.esc_pos[mid] < base) lo = mid + 1; else hi = mid;
    }
    cur = lo;
    if (cur < a.n_esc) next_pos = a.esc_pos[cur];
  }
  const int step_bytes = C * a.nbytes;
  for (int k = 0; k < b.ntiles + 2; ++k) {
    if (k < b.ntiles) {
      int32_t* tile = buf[k % NBUF];
      const int t0 = k * S;
      load_tile<W, R>(tile, data, vec, h, b.lanes_b, b.lane0, b.nlanes, t0, T);
      if (a.n_esc > 0) {
        helper_barrier();   // the row is whole before its escapes land
        if (h < b.lanes_b && b.lane0 + h < b.nlanes) {
          const long long base = (b.lane0 + h) * T + t0;
          const long long end = (b.lane0 + h) * T + min(t0 + S, T);
          while (next_pos < end) {
            tile[h * PITCH + static_cast<int>(next_pos - base)] = a.esc_val[cur];
            ++cur;
            next_pos = cur < a.n_esc ? a.esc_pos[cur] : LLONG_MAX;
          }
        }
      }
    }
    if (k >= 2) {
      const int32_t* tile = buf[(k - 2) % NBUF];
      const int t0 = (k - 2) * S;
      for (int idx = h; idx < b.fpb * S; idx += HELP) {
        const int fl = idx / S, s = idx - fl * S;
        const int f = b.f0 + fl, t = t0 + s;
        if (f >= a.F || t >= T) continue;
        const int32_t* col = tile + fl * C * PITCH + s;
        uint8_t* dst = a.out + (static_cast<long long>(f) * T + t) * step_bytes;
        int32_t v0 = col[0], v1 = 0;
        if (C == 2) {
          v1 = col[PITCH];
          decorrelate(v0, v1, __ldg(a.ca + f));
        }
        if (C == 2 && a.nbytes == 2) {   // the main path: one 4-byte word per step
          const uint32_t s0 = (static_cast<uint32_t>(v0) + a.bias) << a.lshift;
          const uint32_t s1 = (static_cast<uint32_t>(v1) + a.bias) << a.lshift;
          *reinterpret_cast<uint32_t*>(dst) = (s0 & 0xffffu) | (s1 << 16);
          continue;
        }
        for (int ch = 0; ch < C; ++ch) {
          const int32_t v = ch == 0 ? v0 : (C == 2 ? v1 : col[ch * PITCH]);
          const uint32_t smp = (static_cast<uint32_t>(v) + a.bias) << a.lshift;
          for (int bt = 0; bt < a.nbytes; ++bt)
            dst[ch * a.nbytes + bt] = static_cast<uint8_t>(smp >> (8 * bt));
        }
      }
    }
    tile_barrier();
  }
}

template <int W, bool USE64, typename R>
__global__ void __launch_bounds__(NTHREADS) flac_frame_kernel(const FrameArgs a) {
  constexpr int S = Tile<W>::S;
  __shared__ int32_t buf[NBUF][REC * Tile<W>::PITCH];
  BlockShape b;
  b.fpb = REC / a.C;                      // whole frames per block
  b.lanes_b = b.fpb * a.C;
  b.f0 = blockIdx.x * b.fpb;
  b.ntiles = (a.T + S - 1) / S;
  b.lane0 = static_cast<long long>(b.f0) * a.C;
  b.nlanes = static_cast<long long>(a.F) * a.C;
  if (threadIdx.x < REC)
    recurrence_role<W, USE64>(a, b, buf, threadIdx.x);
  else
    helper_role<W, R>(a, b, buf, threadIdx.x - REC);
}

template <int W, bool USE64, typename R>
cudaError_t launch(const FrameArgs& a, cudaStream_t stream) {
  const int fpb = REC / a.C;
  const int blocks = (a.F + fpb - 1) / fpb;
  flac_frame_kernel<W, USE64, R><<<blocks, NTHREADS, 0, stream>>>(a);
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
  if (C < 1 || C > REC || F < 1 || T < 1 || nbytes < 1 || nbytes > 4 || lshift < 0 ||
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

// MP3 granule kernel for sm_90a: every granule of a run, for B streams of
// one format, in one launch, byte-exact against the JAX package.
//
// Replaces _granules_scan_for and its body _granule_body
// (esp_audio_libs_tpu/models/mp3_pipeline.py:90-265, the escape form :438):
// there an XLA lax.scan over the granules of a run, whose step chains the
// dequantizer and joint stereo (ops/mp3dsp.py), the anti-alias butterflies,
// IMDCT36/12 and the overlap-add (ops/mp3imdct.py), and FDCT32 with the
// int64 PQMF polyphase over the vbuf FIFO (ops/mp3subband.py). The carried
// state (overlap, previous block type, window switch, IMDCT block count, the
// FIFO and its phase, the reference-UB flag) never leaves the card between
// granules.
//
// What the first design lost (one 576-thread block per stream, stages in
// turn; probes of tools/kernel_variants.py --mp3 on an NVIDIA H100 80GB HBM3
// at 700 W, PERF.md): 0.856 ms at B = 256 x G = 16, of which the 18 FIFO
// steps took 0.665 ms (2.3 us per step and granule; dropping their 36
// barriers saved nothing: their int64 PQMF read FIFO rows 64 words apart,
// one shared-memory bank for all 32 lanes, with 64 x 64-bit multiplies),
// IMDCT 0.031 ms (64 threads, arrays in local memory), FDCT 0.010 ms (36
// threads), the butterflies 0.007 ms, the dequantizer, parameter expansion
// and joint stereo nothing measurable; the rest, 0.15 ms, waits between
// stages with one block per SM (96 registers x 576 threads).
//
// This design: one block of 288 threads (9 warps) per stream, registers
// capped at 72 (MIN_BLOCKS = 3 blocks, i.e. streams, share an SM by
// registers; 5 would fit by shared memory), so that one stream's narrow
// stages overlap another's wide ones. The per-format tables and the carried
// state live in shared memory for the whole run (the four 576-entry band
// maps packed into one word per sample, the short-block band, window and
// reorder offset of every offset tabulated when the block starts). A
// granule takes four block barriers:
//   1. widen, expand and dequantize (thread = two samples, both channels: a
//      butterfly pair where it has one); guard bits and band ends by warp
//      reductions, one shared atomic per warp and quantity;
//   2. the short-block reorder, joint stereo and the butterflies on the same
//      samples in registers;
//   3. IMDCT36 / IMDCT12x3 / the window-previous-only branch with the
//      overlap, two threads per (channel, subband block), each running one
//      of the two 9-point IDCTs (or the short windows), then half the
//      outputs; beside it, on the other warps, the previous granule's PQMF;
//   4. FDCT32 of the 18 slots, eight threads per (slot, channel), warp
//      shuffles between the butterfly passes, the 33 stored values of each
//      slot written into the granule's linear FIFO history.
// The PQMF computes all 18 x 32 x nch outputs of a granule in one pass over
// that history (the 15 carried steps, then the 18 new ones; the index map
// is ops/mp3subband.py::subband_granule_onepass, held to the JAX FIFO by
// tests/test_torch_mp3.py); two histories alternate between granules. The
// side row and the spectra of granule g + 1 are loaded while granule g
// runs. The JAX-layout ring vbuf and its phase are read once into the
// history (both copies of the first granule's carried steps: a window reads
// the copy its column falls on) and rebuilt once from the last 16 steps.
// Both packages write every value to both copies, but the JAX package's
// MP3Decoder.set_state takes its vbuf from a caller's dict as it is, and the
// JAX FIFO then reads whichever copy a window column falls on; reading the
// same copy keeps such a state byte-exact once it crosses into the port.
// What bounds it: neither bytes (a stereo granule moves about 3.3 KB in and
// 2.3 KB out per stream) nor its integer operations (about 6.3 x 10^4 a
// stream-granule; chip_smoke.mp3_work: 0.015 ms at B = 256 x G = 16) but
// the instructions around them (table lookups, clamps, reductions,
// addressing) and, at B = 256, the chain of a granule's stages on two
// blocks an SM; no stage dominates (the probes of tools/kernel_variants.py). On an NVIDIA H100 80GB HBM3 at
// 700 W: 0.121 ms at B = 256 x G = 16 and 0.76 ms at B = 2048 (PERF.md).

// Integer semantics (those of XLA, which the JAX package runs on): int32
// adds, subtractions, negations and left shifts wrap, done here on uint32
// (the W type) so that no signed overflow is undefined; >> of a signed int
// is arithmetic; MULSHIFT32 is __mulhi; every variable shift count is in
// [0, 31] (clamped where the JAX package clamps it); clz(0) = 32 (__clz);
// the PQMF sums wrap modulo 2^64 (32 x 32 -> 64-bit multiply-adds) and their
// low 32 bits are kept.

#include <cuda_runtime.h>

#include <cstdint>

#include "mp3_common.cuh"

namespace {

constexpr int THREADS = 288;     // 9 warps: two samples a thread in stages 1-2
constexpr int MIN_BLOCKS = 3;    // blocks (streams) the registers must let share an SM
constexpr int HBUF = HN * HSTEP; // one granule's history; granules alternate two of them
constexpr int FD_STRIDE = 33;    // FDCT scratch words per (slot, channel)

constexpr int DEF_NFRACBITS = 6;
constexpr int CSHIFT = 12;
constexpr long long RND = 1LL << (DEF_NFRACBITS - 1 + (32 - CSHIFT));

// int32 with two's-complement wraparound
struct W {
  uint32_t u;
  __device__ W() : u(0) {}
  __device__ W(int v) : u(static_cast<uint32_t>(v)) {}
  __device__ int i() const { return static_cast<int>(u); }
};
__device__ __forceinline__ W wu(uint32_t u) { W w; w.u = u; return w; }
__device__ __forceinline__ W operator+(W a, W b) { return wu(a.u + b.u); }
__device__ __forceinline__ W operator-(W a, W b) { return wu(a.u - b.u); }
__device__ __forceinline__ W operator-(W a) { return wu(0u - a.u); }
__device__ __forceinline__ W operator<<(W a, int n) { return wu(a.u << n); }
__device__ __forceinline__ W operator>>(W a, int n) { return W(a.i() >> n); }
__device__ __forceinline__ W operator|(W a, W b) { return wu(a.u | b.u); }
__device__ __forceinline__ W ms(W a, W b) { return W(__mulhi(a.i(), b.i())); }   // MULSHIFT32
__device__ __forceinline__ W wabs(W a) { return a.i() < 0 ? -a : a; }
// reference CLIP_2N: clip to [-2^n, 2^n - 1], 0 <= n <= 31
__device__ __forceinline__ W clip2n(W y, int n) {
  const W sign = y >> 31;
  const W lim = wu((1u << n) - 1u);
  return (sign.i() != (y >> n).i()) ? wu(sign.u ^ lim.u) : y;
}
// the es epilogue of IMDCT and FDCT: clip to 31 - es bits, then shift up
__device__ __forceinline__ W rescale(W y, int es) { return es > 0 ? clip2n(y, 31 - es) << es : y; }

struct Args {
  const int16_t* huff;     // [G, B, nch, 576]
  const int32_t* side;     // [G, B, 3 nch + GPC]
  const int32_t* consts;   // [CONSTS_LEN]
  int32_t* over;           // [B, 2, 288]
  int32_t* prev_type;      // [B, 2]
  int32_t* prev_ws;        // [B, 2]
  int32_t* num_prev;       // [B, 2]
  int32_t* vbuf;           // [B, 2176]
  int16_t* pcm;            // [B, G, 576 nch]
  int32_t* undef;          // [B]
  int G, B, nch, vindex, cutoff;
};

// shared-memory reductions of one granule
enum Red {
  R_GBMASK = 0,       // [2] OR of dequantized magnitudes
  R_CBL = 2,          // [2] max long band with a nonzero sample
  R_CBS = 4,          // [2][3] max short band per window
  R_MOUT_MS = 10,     // [2] mid-side OR of |x|
  R_MOUT_IS = 12,     // [2] intensity OR of |x|
  R_ANYX = 14,        // [2] any post-stereo sample nonzero
  R_ANYOVER = 16,     // [2] any carried overlap value nonzero
  R_MOUT_IMDCT = 18,  // [2] OR of |y| over the blocks
  R_EXT = 20,         // [2] last nonzero window-previous-only block
  R_N = 22
};
__device__ __forceinline__ int red_init(int k) {
  return (k >= R_CBL && k < R_MOUT_MS) || k >= R_EXT ? -1 : 0;
}

// one warp's OR / max, added to a shared word by its first lane
__device__ __forceinline__ void warp_or(int* dst, int v) {
  const unsigned r = __reduce_or_sync(FULL, static_cast<unsigned>(v));
  if ((threadIdx.x & 31) == 0 && r) atomicOr(dst, static_cast<int>(r));
}
// DequantBlock (reference :550-634) of one sample: (signed value, magnitude)
__device__ __forceinline__ void dequant(int sx, int scale, const int* tb, int& out, int& mag) {
  const int x = sx & 0x7FFFFFFF;
  const int scale_low = scale & 3;
  const W scalef = tb[TB(POW14) + scale_low];
  const int scalei = min(scale >> 2, 31);
  const W tab16 = tb[TB(POW43_14) + ((scale_low << 4) | clampi(x, 0, 15))];
  W y;
  if (x < 4) {
    y = x == 0 ? W(0) : tab16 >> clampi(scalei + 3, 0, 31);
  } else if (x < 16) {
    y = scalei < 0 ? tab16 << clampi((-W(scalei)).i(), 0, 31) : tab16 >> clampi(scalei, 0, 31);
  } else {
    W yb;
    W shb;
    if (x < 64) {
      yb = ms(W(tb[TB(POW43) + clampi(x - 16, 0, 47)]), scalef);
      shb = W(scalei) - W(3);
    } else {
      W xn = W(x) << 17;
      int sh = 0;
      if (xn.i() < 0x08000000) { xn = xn << 4; sh += 4; }
      if (xn.i() < 0x20000000) { xn = xn << 2; sh += 2; }
      if (xn.i() < 0x40000000) { xn = xn << 1; sh += 1; }
      const int* poly = tb + (xn.i() < 0x5A82799A ? TB(POLY43LO) : TB(POLY43HI));
      W yp = poly[0];
#pragma unroll
      for (int k = 1; k < 5; ++k) yp = ms(yp, xn) + W(poly[k]);
      yp = ms(yp, W(tb[TB(POW2FRAC) + sh])) << 3;
      yb = ms(yp, scalef);
      shb = W(scalei) - W(tb[TB(POW2EXP) + sh]);
    }
    if (shb.i() < 0) {
      const int shn = clampi((-shb).i(), 0, 31);
      const int lim = 0x7FFFFFFF >> shn;
      yb = yb.i() > lim ? W(0x7FFFFFFF) : yb << shn;
    } else {
      yb = yb >> clampi(shb.i(), 0, 31);
    }
    y = yb;
  }
  out = sx < 0 ? (-y).i() : y.i();
  mag = y.i();
}

// guard bits of channel ch after joint stereo (reference :7694-7701)
__device__ __forceinline__ int gb_post(const int* red, const int* cb, int nch, int ch) {
  const int mode_ext = nch == 2 ? cb[GB_SCALARS] : 0;
  const int k = mode_ext == 0 ? R_GBMASK : (mode_ext & 1) ? R_MOUT_IS : R_MOUT_MS;
  return __clz(red[k + ch]) - 1;
}

// --------------------------------------------------------------- IMDCT

__device__ __forceinline__ void idct9(const W* x, W* o, const int* c9) {
  const W x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3], x4 = x[4], x5 = x[5], x6 = x[6],
          x7 = x[7], x8 = x[8];
  const W a1 = x0 - x6, a2 = x1 - x5, a3 = x1 + x5, a4 = x2 - x4, a5 = x2 + x4, a6 = x2 + x8,
          a7 = x1 + x7;
  const W a8 = a6 - a5, a9 = a3 - a7, a10 = a2 - x7, a11 = a4 - x8;
  const W m1 = ms(c9[0], x3), m3 = ms(c9[0], a10), m5 = ms(c9[1], a5), m6 = ms(c9[2], a6),
          m7 = ms(c9[1], a8), m8 = ms(c9[2], a5), m9 = ms(c9[3], a9), m10 = ms(c9[4], a7),
          m11 = ms(c9[3], a3), m12 = ms(c9[4], a9);
  const W a12 = x0 + (x6 >> 1);
  const W a13 = a12 + (m1 << 1), a14 = a12 - (m1 << 1);
  const W a15 = a1 + (a11 >> 1);
  const W a16 = (m5 << 1) + (m6 << 1), a17 = (m7 << 1) - (m8 << 1);
  const W a18 = a16 + a17;
  const W a19 = (m9 << 1) + (m10 << 1), a20 = (m11 << 1) - (m12 << 1);
  const W a21 = a20 - a19, a22 = a13 + a16, a23 = a14 + a16, a24 = a14 + a17, a25 = a13 + a17,
          a26 = a14 - a18, a27 = a13 - a18;
  o[0] = a22 + a19;
  o[1] = a15 + (m3 << 1);
  o[2] = a24 + a20;
  o[3] = a26 - a21;
  o[4] = a1 - a11;
  o[5] = a27 + a21;
  o[6] = a25 - a20;
  o[7] = a15 - (m3 << 1);
  o[8] = a23 - a19;
}

// imdct12 (:2291-2340): 6 strided inputs -> 6 outputs
__device__ __forceinline__ void imdct12(W x0, W x1, W x2, W x3, W x4, W x5, W c3, W* o) {
  x4 = x4 - x5;
  x3 = x3 - x4;
  x2 = x2 - x3;
  x3 = x3 - x5;
  x1 = x1 - x2;
  x0 = x0 - x1;
  x1 = x1 - x3;
  x0 = x0 >> 1;
  x1 = x1 >> 1;
  W a0 = ms(c3, x2) << 1, a1 = x0 + (x4 >> 1), a2 = x0 - x4;
  const W o0 = a1 + a0, o2 = a2, o4 = a1 - a0;
  a0 = ms(c3, x3) << 1;
  a1 = x1 + (x5 >> 1);
  a2 = x1 - x5;
  const W o1 = ms(W(0x7BA3751D), a1 + a0) << 2;
  const W o3 = ms(W(0x5A82799A), a2) << 2;
  const W o5 = ms(W(0x2120FB83), a1 - a0) << 2;
  o[0] = o0 + o1;
  o[1] = o2 + o3;
  o[2] = o4 + o5;
  o[3] = o4 - o5;
  o[4] = o2 - o3;
  o[5] = o0 - o1;
}

// WinPrevious (:1883-1935), entry k (0..17) of wp, from the carried overlap
// xprev[9] shifted right by es
__device__ __forceinline__ W win_prev_at(const int* xprev, int es, int bt, const int* win, int k) {
  if (bt == 2) {
    const int* w2 = win + 2 * 36;
    if (k < 6) {
      const int ia = k < 3 ? 2 - k : k - 3;
      return ms(w2[6 + k], W(xprev[ia]) >> es) + ms(w2[k], W(xprev[8 - ia]) >> es);
    }
    if (k < 12) return ms(w2[k], W(xprev[k < 9 ? 11 - k : k - 6]) >> es);
    return W(0);
  }
  return ms(win[36 * clampi(bt, 0, 3) + 18 + k], W(xprev[k < 9 ? k : 17 - k]) >> es);
}

// FreqInvertRescale (:1937-2044) of output k of block blk; m collects |y|
__device__ __forceinline__ W invert_rescale(W y, int k, int blk, int es, W& m) {
  if ((blk & 1) && (k & 1)) y = -y;
  if (es > 0) {
    y = clip2n(y, 31 - es) << es;
    m = m | wabs(y);
  }
  return y;
}

// ------------------------------------------------------------- kernel

struct Smem {
  int tab[CONSTS_LEN - OFF(SFB_L)];  // the per-format tables (TB offsets)
  int bandpack[NS];                  // long_band | band_out_l << 8 | band_out_s << 16 | win_out << 24
  uint32_t shtab[2 * NS];            // short_word of each offset, base sfb_s[0] then sfb_s[3]
  int hist[2 * HBUF];                // FIFO histories of granules g (g & 1) and g - 1, see pqmf
  int bufA[2 * 18 * FD_STRIDE];      // x (2 x 576), then the FDCT scratch (36 x 33)
  int bufB[2 * NS];                  // dequantized samples, then the IMDCT output
  int over[2 * 288];
  int xpc[2 * 288];                  // the overlap as the granule found it (IMDCT reads it)
  int4 pq[8 * 16];                   // PQMF taps [k][r]: (c1, -c2, P, Q), see pqmf
  int sd[2][SW_MAX];                 // side rows of granules g and g + 1
  int red[2][R_N];                   // reductions of granules g and g + 1
  int st[7];                         // prev_type[2], prev_ws[2], num_prev[2], undef
  uint32_t recipes[V33];
};

// The PQMF of all 18 x 32 x nch outputs of a granule over its history,
// after its stage 4. Item (s, ch, r), r = 0..15: row r gives outputs r (lo)
// and 32 - r (hi); row 0 gives output 0 and, in hi's place, output 16 (row
// 16). With A[k] = value 1 + r of step s - 2k (row 16: value 0 of step
// s - 2k - 1) and Bv[k] = value 17 + r of step s - 15 + 2k:
//   lo = sum c1 A - c2 Bv,  hi = sum c2 A + c1 Bv  (row 16: poly[256+k] A)
// (the int64 sums of ops/mp3subband.py polyphase_window, in any order).
// In the first granule (FIRST) a carried value is read from the ring copy
// the step-by-step FIFO's window column falls on: column vs + k of the rows
// block, vs + 23 - k of the qrows block, the second copy from 8 on.
// The history of granule g is hist[g & 1]: step s (-15..17) at HSTEP words
// from slot CARRY + s. The first granule's ring copy at +8 of its carried
// steps lies in the other history's slots 18..32 (HN + s), which the next
// granule writes only after this PQMF has run. Threads t0 .. t0 + nt - 1
// run it (nt a multiple of 16).
template <bool FIRST>
__device__ __forceinline__ void pqmf(const Smem& S, int buf, int16_t* out, int nch, int v,
                                     int t0, int nt) {
  const int r = (threadIdx.x - t0) & 15;
#pragma unroll 1
  for (int item = threadIdx.x - t0; item < 18 * nch * 16; item += nt) {
    const int hi_ = item >> 4;
    const int ch = nch == 2 ? hi_ & 1 : 0, s = nch == 2 ? hi_ >> 1 : hi_;
    const int* hc = S.hist + buf * HBUF + (CARRY + s) * HSTEP + ch;   // step s; earlier below
    const int* dc = S.hist + (buf ^ 1) * HBUF + (HN + s) * HSTEP + ch;
    const int vs = (v - (s >> 1)) & 7;
    unsigned long long lo = 0, hi = 0;
#pragma unroll 2
    for (int k = 0; k < 8; ++k) {
      const int4 c = S.pq[16 * k + r];
      const int sa = s - 2 * k, s2 = sa - 1, sb = s - 15 + 2 * k;
      int av = hc[-2 * k * HSTEP + 2 * (1 + r)];
      int a16 = hc[(-2 * k - 1) * HSTEP];
      int bv = hc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      if (FIRST) {
        const bool da = vs + k >= 8, db = vs + 7 - k >= 8;
        if (da && sa < 0) av = dc[-2 * k * HSTEP + 2 * (1 + r)];
        if (da && s2 < 0) a16 = dc[(-2 * k - 1) * HSTEP];
        if (db && sb < 0) bv = dc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      }
      const int a2 = r ? av : a16;
      lo += static_cast<unsigned long long>(c.x * static_cast<long long>(av));
      lo += static_cast<unsigned long long>(c.y * static_cast<long long>(bv));
      hi += static_cast<unsigned long long>(c.z * static_cast<long long>(a2));
      hi += static_cast<unsigned long long>(c.w * static_cast<long long>(bv));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned long long acc = (e ? hi : lo) + static_cast<unsigned long long>(RND);
      const int s32 = static_cast<int>(static_cast<uint32_t>(
          static_cast<unsigned long long>(static_cast<long long>(acc) >> (32 - CSHIFT))));
      int xo = s32 >> DEF_NFRACBITS;
      const int sign = xo >> 31;
      if (sign != (xo >> 15)) xo = sign ^ 0x7FFF;
      const int n = e ? (r ? 32 - r : 16) : r;
      out[s * 32 * nch + n * nch + ch] = static_cast<int16_t>(xo);
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mp3_granules_kernel(Args a) {
  __shared__ Smem S;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int nch = a.nch;
  const int B = a.B;
  const int G = a.G;
  const int SW = 3 * nch + GPC;
  const int* tb = S.tab;

  // ---- prologue: tables, carried state, the ring read into the history
  for (int k = tid; k < CONSTS_LEN - OFF(SFB_L); k += THREADS) S.tab[k] = a.consts[OFF(SFB_L) + k];
  for (int k = tid; k < NS; k += THREADS) {
    const int32_t* c = a.consts;
    S.bandpack[k] = (c[OFF(LONG_BAND) + k] & 0xFF) | (c[OFF(BAND_OUT_L) + k] & 0xFF) << 8 |
                    (c[OFF(BAND_OUT_S) + k] & 0xFF) << 16 |
                    static_cast<int>(static_cast<uint32_t>(c[OFF(WIN_OUT) + k]) << 24);
  }
  for (int k = tid; k < 2 * 288; k += THREADS) S.over[k] = a.over[(size_t)b * 576 + k];
  if (tid < 2) {
    S.st[tid] = a.prev_type[2 * b + tid];
    S.st[2 + tid] = a.prev_ws[2 * b + tid];
    S.st[4 + tid] = a.num_prev[2 * b + tid];
  }
  if (tid == 0) S.st[6] = 0;
  if (tid < V33) S.recipes[tid] = kRecipes[tid];
  if (tid < R_N) S.red[0][tid] = red_init(tid);
  if (tid < SW) S.sd[0][tid] = a.side[(size_t)b * SW + tid];
  {
    const int32_t* vb = a.vbuf + (size_t)b * 2176;
    for (int k = tid; k < CARRY * nch * V33; k += THREADS) {
      const int s = k / (nch * V33) - CARRY, ch = (k / V33) % nch, j = k % V33;
      const int cell = ring_cell(s, a.vindex, j, ch);
      S.hist[(CARRY + s) * HSTEP + 2 * j + ch] = vb[cell];
      S.hist[HBUF + (HN + s) * HSTEP + 2 * j + ch] = vb[cell + 8];
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * NS; k += THREADS) {
    const int* sfb_s = tb + TB(SFB_S);
    S.shtab[k] = short_word(sfb_s, k >= NS ? sfb_s[3] : sfb_s[0], k % NS);
  }
  if (tid < 8 * 16) {   // PQMF taps, see pqmf
    const int k = tid / 16, r = tid % 16;
    const int* poly = tb + TB(POLYCOEF);
    const int c1 = poly[16 * r + 2 * k], c2 = poly[16 * r + 2 * k + 1];
    S.pq[tid] = r ? make_int4(c1, -c2, c2, c1) : make_int4(c1, -c2, poly[256 + k], 0);
  }

  // the thread's samples in stages 1-2 and their spectra, loaded a granule ahead
  int ia, ib, bnd;
  samples_of(tid, ia, ib, bnd);
  int hx[2] = {};      // per channel: sample ia in the low half, ib in the high half
  int side_next = 0;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    if (ch >= nch) break;
    const int16_t* h = a.huff + ((size_t)b * nch + ch) * NS;
    hx[ch] = (h[ia] & 0xFFFF) | static_cast<int>(static_cast<uint32_t>(h[ib]) << 16);
  }
  __syncthreads();

  int v = a.vindex;
  for (int g = 0; g < G; ++g) {
    const int cur = g & 1;
    const int* sd = S.sd[cur];
    const int* cb = sd + 3 * nch;
    int* red = S.red[cur];

    // ---- 1. widen, expand, dequantize (both channels of two samples)
    int src[2][2] = {};      // where stage 2 reads each sample: the reorder's source
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      if (ch >= nch) break;
      const Chan c = chan_of(cb, ch);
      int gbm = 0, cbl = -1, cbs0 = -1, cbs1 = -1, cbs2 = -1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = e ? ib : ia;
        const int h = e ? hx[ch] >> 16 : static_cast<int16_t>(hx[ch]);   // sign-extended
        const int hm = h & 0x7FFF;
        const int hs = h < 0 ? static_cast<int>(static_cast<uint32_t>(hm) | 0x80000000u) : hm;
        const bool long_proc = i < c.pe_l;
        const int o = i - c.sbase;
        const bool short_proc = o >= 0 && i < c.pe_s && c.has_short;
        int d = hs, mag = 0;       // a zero dequantizes to zero: only its reorder matters
        src[ch][e] = i;
        if ((long_proc || short_proc) && (hs != 0 || short_proc)) {
          const uint32_t sw = S.shtab[c.tab + clampi(o, 0, NS - 1)];
          if (short_proc) src[ch][e] = c.sbase + static_cast<int>(sw >> 8);
          if (hs != 0) {
            const int sband = sw & 15, swin = (sw >> 4) & 3;
            const int lband = byte_of(S.bandpack[i], 0);
            const int gain = long_proc ? cb[GB_GAIN_L + 22 * ch + lband]
                                       : cb[GB_GAIN_S + 39 * ch + 3 * sband + min(swin, 2)];
            dequant(hs, gain, tb, d, mag);
            if (d != 0) {
              if (long_proc) cbl = max(cbl, lband);
              else if (swin == 0) cbs0 = max(cbs0, sband);
              else if (swin == 1) cbs1 = max(cbs1, sband);
              else if (swin == 2) cbs2 = max(cbs2, sband);
            }
          }
        }
        gbm |= mag;
        S.bufB[ch * NS + i] = d;
      }
      warp_or(&red[R_GBMASK + ch], gbm);
      warp_max(&red[R_CBL + ch], cbl);
      warp_max(&red[R_CBS + 3 * ch], cbs0);
      warp_max(&red[R_CBS + 3 * ch + 1], cbs1);
      warp_max(&red[R_CBS + 3 * ch + 2], cbs2);
      warp_or(&red[R_ANYOVER + ch], S.over[ch * 288 + tid] != 0);
    }
    if (g + 1 < G) {               // the next granule's spectra and side row
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        const int16_t* h = a.huff + (((size_t)(g + 1) * B + b) * nch + ch) * NS;
        hx[ch] = (h[ia] & 0xFFFF) | static_cast<int>(static_cast<uint32_t>(h[ib]) << 16);
      }
      if (tid < SW) side_next = a.side[((size_t)(g + 1) * B + b) * SW + tid];
    }
    __syncthreads();   // B1: the dequantized samples and their reductions

    // ---- 2. short-block reorder, joint stereo, butterflies (same samples);
    // the carried FIFO steps moved to the front of the history
    if (g > 0) {
      int* hd = S.hist + cur * HBUF;
      const int* hs = S.hist + (cur ^ 1) * HBUF + 18 * HSTEP;
      for (int k = tid; k < CARRY * HSTEP; k += THREADS) hd[k] = hs[k];
    }
    {
      W x[2][2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ch < nch) x[ch][e] = W(S.bufB[ch * NS + src[ch][e]]);
      const int mode_ext = nch == 2 ? cb[GB_SCALARS] : 0;
      if (mode_ext != 0) {
        const int* sfb_l = tb + TB(SFB_L);
        const int* sfb_s = tb + TB(SFB_S);
        const bool has_s0 = cb[GB_HAS_SHORT] != 0, has_s1 = cb[GB_HAS_SHORT + 1] != 0;
        const int cbl0 = max(red[R_CBL], 0), cbl1 = max(red[R_CBL + 1], 0);
        int cbs[2][3];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int w = 0; w < 3; ++w)
            cbs[ch][w] = (ch ? has_s1 : has_s0)
                             ? max(red[R_CBS + 3 * ch + w], cb[GB_CB_START_S + ch]) : 0;
        const int cbsmax0 = max(max(cbs[0][0], cbs[0][1]), cbs[0][2]);
        const int cbsmax1 = max(max(cbs[1][0], cbs[1][1]), cbs[1][2]);
        const int nzb0 = nzb_of(sd, 2, 0), nzb1 = nzb_of(sd, 2, 1);
        const bool m1 = cb[GB_SCALARS + 1] != 0;
        const int iscale = cb[GB_SCALARS + 2];
        const int midside = mode_ext >> 1, intensity = mode_ext & 1;
        const bool use_long = cb[GB_CB_TYPE + 1] == 0;
        const int n_long = sfb_l[clampi(cbl1 + 1, 0, 22)];
        const int i0 = 3 * sfb_s[clampi(cbsmax1 + 1, 0, 13)];
        const int ms_n = intensity == 1 ? (use_long ? n_long : i0) : max(nzb0, nzb1);
        const bool clip = __clz(red[R_GBMASK]) - 1 < 1 || __clz(red[R_GBMASK + 1]) - 1 < 1;
        int mms0 = 0, mms1 = 0, mis0 = 0, mis1 = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = e ? ib : ia;
          if (clip) {
            if (i < nzb0) x[0][e] = W(clampi(x[0][e].i(), -0x3FFFFFFF, 0x3FFFFFFF));
            if (i < nzb1) x[1][e] = W(clampi(x[1][e].i(), -0x3FFFFFFF, 0x3FFFFFFF));
          }
          W x0 = x[0][e], x1 = x[1][e];
          if (midside == 1 && i < ms_n) {
            x0 = x[0][e] + x[1][e];
            x1 = x[0][e] - x[1][e];
            mms0 |= wabs(x0).i();
            mms1 |= wabs(x1).i();
          }
          const int bp = S.bandpack[i];
          const int ob_l = byte_of(bp, 1), ob_s = byte_of(bp, 2), ow = byte_of(bp, 3);
          bool active;
          if (use_long) {
            active = ob_l >= cbl1 + 1 && ob_l < cbl0 + 1 && ob_l >= 0 && i < nzb0;
          } else if (m1) {
            const int lim = i0 + 3 * fdiv(nzb0 - i0, 3);
            active = ob_s >= cbsmax1 + 1 && ob_s < cbsmax0 + 1 && ob_s >= 0 && i < lim &&
                     i >= i0;
          } else {
            const int w = clampi(ow, 0, 2);
            active = ob_s >= pick3(w, cbs[1][0], cbs[1][1], cbs[1][2]) + 1 &&
                     ob_s < pick3(w, cbs[0][0], cbs[0][1], cbs[0][2]) + 1 && ob_s >= 0;
          }
          if (intensity == 1 && active) {
            int sf_r, il;
            if (use_long) {
              sf_r = ob_l >= 0 ? cb[GB_SFL1 + clampi(ob_l, 0, 22)] : 0;
              il = ob_l >= 0 ? cb[GB_IL_LONG + clampi(ob_l, 0, 22)] : 0;
            } else {
              sf_r = ob_s >= 0 ? cb[GB_SFS1 + clampi(3 * ob_s + ow, 0, 38)] : 0;
              il = ob_s >= 0 ? cb[GB_IL_SHORT + clampi(ob_s, 0, 12)] : 0;
            }
            const int ms1 = clampi(midside, 0, 1);
            const int* iip = tb + TB(ISFIIP) + 2 * ms1;
            W fl, fr;
            if (m1) {
              if (sf_r == 7) {
                fl = iip[0];
                fr = iip[1];
              } else {
                const int* isf = tb + TB(ISF1) + 7 * ms1;
                fl = isf[clampi(sf_r, 0, 6)];
                fr = W(isf[6]) - fl;
              }
            } else if (sf_r == il) {
              fl = iip[0];
              fr = iip[1];
            } else {
              const int* isf = tb + TB(ISF2) + 16 * ((clampi(iscale, 0, 1) << 1) | ms1);
              const int half = clampi((W(sf_r) + W(1)).i() >> 1, 0, 15);
              const bool odd = (sf_r & 1) == 1;
              fl = isf[odd ? half : 0];
              fr = isf[odd ? 0 : half];
            }
            const W xl = ms(fl, x0) << 2, xr = ms(fr, x0) << 2;
            x0 = xl;
            x1 = xr;
            mis0 |= wabs(xl).i();
            mis1 |= wabs(xr).i();
          }
          x[0][e] = x0;
          x[1][e] = x1;
        }
        warp_or(&red[R_MOUT_MS], mms0);
        warp_or(&red[R_MOUT_MS + 1], mms1);
        warp_or(&red[R_MOUT_IS], mis0);
        warp_or(&red[R_MOUT_IS + 1], mis1);
      }
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        warp_or(&red[R_ANYX + ch], (x[ch][0].i() | x[ch][1].i()) != 0);
        if (bnd != 0 && bnd <= blocks_of(sd, nch, ch, a.cutoff).nbfly) {
          const int j = tid % 8;    // anti-alias butterfly (li, ri) = (ia, ib)
          const W a0 = x[ch][0], b0 = x[ch][1];
          const W c0 = tb[TB(CSA) + 2 * j], c1 = tb[TB(CSA) + 2 * j + 1];
          x[ch][0] = (ms(c0, a0) - ms(c1, b0)) << 1;
          x[ch][1] = (ms(c0, b0) + ms(c1, a0)) << 1;
        }
        S.bufA[ch * NS + ia] = x[ch][0].i();
        S.bufA[ch * NS + ib] = x[ch][1].i();
      }
    }
    __syncthreads();   // B2: the stereo samples, the carried history moved

    // ---- 3. IMDCT with overlap: two threads per (channel, block); the
    // other warps run the previous granule's PQMF meanwhile
    if (tid >= 64 * nch) {
      if (g > 0) {
        int16_t* out = a.pcm + ((size_t)b * G + g - 1) * (NS * nch);
        if (g == 1)
          pqmf<true>(S, cur ^ 1, out, nch, (v + 9) & 7, 64 * nch, THREADS - 64 * nch);
        else
          pqmf<false>(S, cur ^ 1, out, nch, (v + 9) & 7, 64 * nch, THREADS - 64 * nch);
      }
    } else {                        // whole warps
      const int h = tid & 1, unit = tid >> 1, ch = unit >> 5, blk = unit & 31;
      const Blocks nb = blocks_of(sd, nch, ch, a.cutoff);
      const int bt = sd[nch + ch], mixed = sd[2 * nch + ch];
      const int pt = S.st[ch], pws = S.st[2 + ch], npv = S.st[4 + ch];
      const int m_lim = max(nb.nbl, nb.nbt);
      const bool in_long = blk < nb.nbl;
      const bool in_short = !in_long && blk < nb.nbt;
      const bool in_prev = !in_long && !in_short && blk >= m_lim && blk < npv;
      const int curr_win = (mixed == 1 && blk < nb.cws) ? 0 : bt;
      const int prev_win = blk < pws ? 0 : pt;
      int* xprev = S.over + ch * 288 + 9 * blk;
      int* xin = S.bufA + ch * NS + 18 * blk;   // the block's input, then its scratch
      int* y = S.bufB + ch * NS + 18 * blk;
      const int* win = tb + TB(IMDCTWIN);
      const int es = (in_long || in_short) ? max(7 - gb_post(red, cb, nch, ch), 0) : 0;
      // A: the carried overlap copied aside (B writes the new one in place);
      // the thread's transform into registers (long: the even (h = 0) or
      // odd (h = 1) 9-point IDCT; short: windows h and 2), then into the
      // block's input, which no one reads any more
      int* xp = S.xpc + ch * 288 + 9 * blk;
      for (int k = h; k < 9; k += 2) xp[k] = xprev[k];
      W t[9];
      W o2[6];
      if (in_long) {
        W acc1 = W(0), acc2 = W(0);
        W xv[9];
#pragma unroll
        for (int i = 8; i >= 0; --i) {
          acc1 = (W(xin[2 * i + 1]) >> es) - acc1;
          acc2 = acc1 - acc2;
          acc1 = (W(xin[2 * i]) >> es) - acc1;
          xv[i] = h ? acc2 : acc1;
        }
        xv[0] = xv[0] >> 1;
        idct9(xv, t, tb + TB(C9));
      } else if (in_short) {
        const W c3 = W(tb[TB(C9)]);
        imdct12(W(xin[h]) >> es, W(xin[h + 3]) >> es, W(xin[h + 6]) >> es, W(xin[h + 9]) >> es,
                W(xin[h + 12]) >> es, W(xin[h + 15]) >> es, c3, t);
        imdct12(W(xin[2]) >> es, W(xin[5]) >> es, W(xin[8]) >> es, W(xin[11]) >> es,
                W(xin[14]) >> es, W(xin[17]) >> es, c3, o2);
      }
      __syncwarp();
      if (in_long) {
#pragma unroll
        for (int k = 0; k < 9; ++k) xin[9 * h + k] = t[k].i();   // even then odd
      } else if (in_short) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          xin[6 * h + k] = t[k].i();
          xin[12 + k] = o2[k].i();
        }
      }
      __syncwarp();
      // B: half the outputs and half the new overlap
      W m = W(0);
      bool any = false;
      if (in_long) {
        const int* fw = tb + TB(FASTWIN36);
        const int* wc = win + 36 * clampi(curr_win, 0, 3);
        const bool fast = prev_win == 0 && curr_win == 0;
#pragma unroll 1
        for (int i = 5 * h; i < 5 + 4 * h; ++i) {
          const W even = xin[8 - i], odd = xin[17 - i];
          const W xo_ = ms(W(tb[TB(C18) + 8 - i]), odd);
          const W xe_ = even >> 2;
          W lo, hi;
          if (fast) {
            const W s = -(W(xp[i]) >> es);
            const W d = -(xe_ - xo_);
            const W tt = s - d;
            lo = d + (ms(tt, W(fw[2 * i])) << 2);
            hi = s + (ms(tt, W(fw[2 * i + 1])) << 2);
          } else {
            const W d = xe_ - xo_;
            lo = (win_prev_at(xp, es, prev_win, win, i) + ms(d, W(wc[i]))) << 2;
            hi = (win_prev_at(xp, es, prev_win, win, 17 - i) + ms(d, W(wc[17 - i]))) << 2;
          }
          m = m | wabs(lo) | wabs(hi);
          y[i] = invert_rescale(lo, i, blk, es, m).i();
          y[17 - i] = invert_rescale(hi, 17 - i, blk, es, m).i();
          xprev[i] = rescale(xe_ + xo_, es).i();
        }
      } else if (in_short) {
        const int* w2 = win + 2 * 36;
        const int* xb = xin;
#pragma unroll 1
        for (int k = 9 * h; k < 9 + 9 * h; ++k) {
          const int grp = k / 3, i = k % 3;
          W val = win_prev_at(xp, es, prev_win, win, k) << 2;
          if (grp == 2) val = val + ms(w2[i], xb[3 + i]);
          else if (grp == 3) val = val + ms(w2[3 + i], xb[5 - i]);
          else if (grp == 4) val = val + (ms(w2[6 + i], xb[2 - i]) + ms(w2[i], xb[9 + i]));
          else if (grp == 5) val = val + (ms(w2[9 + i], xb[i]) + ms(w2[3 + i], xb[11 - i]));
          m = m | wabs(val);
          y[k] = invert_rescale(val, k, blk, es, m).i();
        }
#pragma unroll 1
        for (int k = 5 * h; k < 5 + 4 * h; ++k)
          xprev[k] = rescale(W(xb[k < 3 ? 6 + k : 9 + k]) >> 2, es).i();
      } else if (in_prev) {     // window previous only (HybridTransform :2482-2512)
#pragma unroll 1
        for (int k = 9 * h; k < 9 + 9 * h; ++k) {
          W val = win_prev_at(xp, 0, prev_win, win, k) << 2;
          if ((blk & 1) && (k & 1)) val = -val;
          m = m | wabs(val);
          any = any || val.i() != 0;
          y[k] = val.i();
        }
        for (int k = 5 * h; k < 5 + 4 * h; ++k) xprev[k] = 0;
      } else {
        for (int k = 9 * h; k < 9 + 9 * h; ++k) y[k] = 0;
      }
      if (any) atomicMax(&red[R_EXT + ch], blk);
      warp_or(&red[R_MOUT_IMDCT + ch], m.i());
    }
    __syncthreads();   // B3: the IMDCT output and the new overlap

    // ---- 4. FDCT32 per (slot, channel), eight threads each; the carried
    // block state and the UB flag; the next granule's side row and reductions
    {
      const int nu = 18 * nch;
      if ((tid & ~31) < 8 * nu) {     // whole warps; a partly used warp runs a clamped unit
        const int l = tid & 7, u0 = tid >> 3, u = min(u0, nu - 1);
        const int s = u % 18, ch = u / 18;
        const bool store = u0 < nu;
        const int es = max(6 - (__clz(red[R_MOUT_IMDCT + ch]) - 1), 0);
        const int* x = S.bufB + ch * NS + s;    // stride 18
        const int* dct = tb + TB(DCTTAB);
        int* p = S.bufA + u * FD_STRIDE;        // the 32 post-pass entries
        {   // first pass: butterfly group l
          const W a0 = W(x[18 * l]) >> es, a3 = W(x[18 * (31 - l)]) >> es;
          const W a1 = W(x[18 * (15 - l)]) >> es, a2 = W(x[18 * (16 + l)]) >> es;
          const int s1 = (0x11122335 >> (4 * l)) & 15, s2 = (0x42211111 >> (4 * l)) & 15;
          const W b0 = a0 + a3, b3 = ms(W(dct[3 * l]), a0 - a3) << 1;
          const W b1 = a1 + a2, b2 = ms(W(dct[3 * l + 1]), a1 - a2) << s1;
          if (store) {
            p[l] = (b0 + b1).i();
            p[15 - l] = (ms(W(dct[3 * l + 2]), b0 - b1) << s2).i();
            p[16 + l] = (b2 + b3).i();
            p[31 - l] = (ms(W(dct[3 * l + 2]), b3 - b2) << s2).i();
          }
        }
        __syncwarp();
        {   // second pass: group l / 2 of 8, elements (0, 7, 3, 4) or (1, 6, 2, 5)
          const int hh = l & 1;
          const int* pg = p + 8 * (l >> 1);
          const int* d = dct + 24 + 6 * (l >> 1) + 3 * hh;
          const W u0v = pg[hh], u1v = pg[7 - hh], u2v = pg[3 - hh], u3v = pg[4 + hh];
          const W x0 = u0v + u1v, x1 = ms(W(d[0]), u0v - u1v) << 1;
          const W x2 = u2v + u3v, x3 = ms(W(d[1]), u2v - u3v) << (hh ? 1 : 3);
          const int shc = hh ? 2 : 1;
          const W y0 = x0 + x2, y1 = ms(W(d[2]), x0 - x2) << shc;
          const W y2 = x3 + x1, y3 = ms(W(d[2]), x1 - x3) << shc;
          // hh = 0 holds (A0, A3, A4, A7), hh = 1 (A1, A2, A5, A6); the
          // last step pairs A0..A3 on hh = 0 and A4..A7 on hh = 1
          const W r0 = W(__shfl_xor_sync(FULL, (hh ? y0 : y2).i(), 1));
          const W r1 = W(__shfl_xor_sync(FULL, (hh ? y1 : y3).i(), 1));
          const W P = hh ? r0 : y0, Q = hh ? y2 : r0, U = hh ? r1 : y1, V = hh ? y3 : r1;
          const W cos4 = W(0x5A82799A);
          const W e = P + Q, f = ms(cos4, P - Q) << 1;
          const W hv = ms(cos4, U - V) << 1, gh = (V + U) + hv;
          __syncwarp();
          if (store) {
            int* o = p + 8 * (l >> 1) + 4 * hh;
            o[0] = (hh ? e + gh : e).i();
            o[1] = (hh ? f + hv : f).i();
            o[2] = (hh ? f + gh : gh).i();
            o[3] = hv.i();
          }
        }
        __syncwarp();
        if (store) {   // the 33 stored values, es epilogue, into the history
          int* hrow = S.hist + cur * HBUF + (CARRY + s) * HSTEP + ch;
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            const int j = l + 8 * q;
            if (j >= V33) break;
            const uint32_t r = S.recipes[j];
            const int n = r >> 15;
            W vv = W(p[r & 31]);
            if (n > 1) vv = vv + W(p[(r >> 5) & 31]);
            if (n > 2) vv = vv + W(p[(r >> 10) & 31]);
            hrow[2 * j] = rescale(vv, es).i();
          }
        }
      }
      if (tid == THREADS - 1) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          if (ch >= nch) break;
          const Blocks nb = blocks_of(sd, nch, ch, a.cutoff);
          if (gb_post(red, cb, nch, ch) == 31 && (red[R_ANYX + ch] | red[R_ANYOVER + ch]))
            S.st[6] = 1;
          S.st[ch] = sd[nch + ch];
          S.st[2 + ch] = nb.cws;
          S.st[4 + ch] = max(max(nb.nbl, nb.nbt), red[R_EXT + ch]);
        }
      }
      if (tid < R_N) S.red[cur ^ 1][tid] = red_init(tid);
      if (g + 1 < G && tid < SW) S.sd[cur ^ 1][tid] = side_next;
    }
    __syncthreads();   // B4: the history, the state, the next side row
    v = (v - 9) & 7;
  }

  // ---- the last granule's PQMF, on every thread
  {
    const int gl = G - 1;
    int16_t* out = a.pcm + ((size_t)b * G + gl) * (NS * nch);
    if (gl == 0)
      pqmf<true>(S, 0, out, nch, (v + 9) & 7, 0, THREADS);
    else
      pqmf<false>(S, gl & 1, out, nch, (v + 9) & 7, 0, THREADS);
  }

  // ---- epilogue: the carried state; the ring rebuilt from the last
  // granule's last 16 steps (every ring cell but rows 16 and 33 of the
  // qrows block, which no step writes)
  for (int k = tid; k < 2 * 288; k += THREADS) a.over[(size_t)b * 576 + k] = S.over[k];
  if (tid < 2) {
    a.prev_type[2 * b + tid] = S.st[tid];
    a.prev_ws[2 * b + tid] = S.st[2 + tid];
    a.num_prev[2 * b + tid] = S.st[4 + tid];
  }
  if (tid == 0) a.undef[b] = S.st[6];
  {
    const int vl = (v + 9) & 7;
    int32_t* vb = a.vbuf + (size_t)b * 2176;
    for (int k = tid; k < 16 * nch * V33; k += THREADS) {
      const int s = 2 + k / (nch * V33), ch = (k / V33) % nch, j = k % V33;
      const int val = S.hist[((G - 1) & 1) * HBUF + (CARRY + s) * HSTEP + 2 * j + ch];
      const int cell = ring_cell(s, vl, j, ch);
      vb[cell] = val;
      vb[cell + 8] = val;
    }
  }
}

}  // namespace

// The constants' block sizes, in layout order, for the wrapper to check its
// CONST_LAYOUT against; returns the number of blocks.
extern "C" int eal_mp3_consts_layout(int* sizes) {
  for (int k = 0; k < N_BLOCKS; ++k) sizes[k] = kSizes[k];
  return N_BLOCKS;
}

extern "C" int eal_mp3_granules(const void* huff, const void* side, const void* consts,
                                void* over, void* prev_type, void* prev_ws, void* num_prev,
                                void* vbuf, void* pcm, void* undef, int G, int B, int nch,
                                int vindex, int cutoff, void* stream) {
  if (G < 1 || B < 1 || (nch != 1 && nch != 2) || vindex < 0 || vindex > 7 || cutoff < 1 ||
      cutoff > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.huff = static_cast<const int16_t*>(huff);
  a.side = static_cast<const int32_t*>(side);
  a.consts = static_cast<const int32_t*>(consts);
  a.over = static_cast<int32_t*>(over);
  a.prev_type = static_cast<int32_t*>(prev_type);
  a.prev_ws = static_cast<int32_t*>(prev_ws);
  a.num_prev = static_cast<int32_t*>(num_prev);
  a.vbuf = static_cast<int32_t*>(vbuf);
  a.pcm = static_cast<int16_t*>(pcm);
  a.undef = static_cast<int32_t*>(undef);
  a.G = G;
  a.B = B;
  a.nch = nch;
  a.vindex = vindex;
  a.cutoff = cutoff;
  mp3_granules_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

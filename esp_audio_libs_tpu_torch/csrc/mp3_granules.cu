// MP3 granule kernel for sm_90a: every granule of a run, for B streams of
// one format, in one launch, byte-exact against the JAX package.
//
// Replaces _granules_scan_for and its body _granule_body
// (esp_audio_libs_tpu/models/mp3_pipeline.py:90-265): there an XLA lax.scan
// over the granules of a run, whose step chains the dequantizer and joint
// stereo (ops/mp3dsp.py), the anti-alias butterflies, IMDCT36/12 and the
// overlap-add (ops/mp3imdct.py), and FDCT32 with the int64 PQMF polyphase
// over the vbuf FIFO (ops/mp3subband.py). The carried state (overlap,
// previous block type, window switch, IMDCT block count, the FIFO and its
// phase, the reference-UB flag) never leaves the card between granules.
//
// Design (the simple, right first version): one block of 576 threads per
// stream, both channels in it (MS and intensity stereo couple them). The
// per-format constants (the sample maps and the Helix tables, 12 KB) and
// the carried state are staged into shared memory once; the granule loop
// runs inside the kernel, each stage closed by __syncthreads:
//   1. widen the int16 spectra to the sign-in-MSB form, expand the
//      per-sample parameters from the compact blob, dequantize; guard-bit
//      mask and critical-band ends by shared-memory atomics (OR, max);
//   2. the short-block reorder (a gather) and joint stereo, one thread per
//      sample holding both channels;
//   3. the anti-alias butterflies in place;
//   4. IMDCT36 or IMDCT12x3 (or the window-previous-only branch) with the
//      overlap, one thread per (channel, subband block);
//   5. FDCT32 of the 18 time slots, one thread per (slot, channel);
//   6. the 18 FIFO steps in turn: the stored values, then the int64 PQMF,
//      one thread per output sample.
// What bounds it: not bytes (a stereo granule moves about 3.3 KB of spectra
// and side data in and 2.3 KB of PCM out per stream) but the chain of
// dependent stages per granule, each a few hundred integer operations on 32
// to 576 threads of a block, and 36 block-wide barriers in the FIFO steps;
// at 96 registers one block fills an SM. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W: 0.85 ms for B = 256 x G = 16, 1 % of the bytes bound, about
// 26 us per granule of a block (PERF.md). Making it fast (warp-level
// stages, several streams per block) is a later PR's work.
//
// Integer semantics (those of XLA, which the JAX package runs on): int32
// adds, subtractions, negations and left shifts wrap, done here on uint32
// (the W type) so that no signed overflow is undefined; >> of a signed int
// is arithmetic; MULSHIFT32 is __mulhi; every variable shift count is in
// [0, 31] (clamped where the JAX package clamps it); clz(0) = 32 (__clz);
// the PQMF sums wrap modulo 2^64 and their low 32 bits are kept.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NS = 576;          // samples per granule and channel
constexpr int GPC = 235;         // compact parameter blob words
constexpr int THREADS = NS;
constexpr int V33 = 33;          // values one FIFO step stores per channel

// per-format constants: ops/mp3_kernels.py CONST_LAYOUT, in this order
enum Block {
  LONG_BAND, BAND_OUT_L, BAND_OUT_S, WIN_OUT, SFB_L, SFB_S, POW14, POW43_14, POW43, POLY43LO,
  POLY43HI, POW2EXP, POW2FRAC, CSA, IMDCTWIN, FASTWIN36, C18, C9, DCTTAB, POLYCOEF, ISF1, ISF2,
  ISFIIP, N_BLOCKS
};
constexpr int kSizes[N_BLOCKS] = {576, 576, 576, 576, 23, 14, 4, 64, 48, 5, 5, 8, 8, 16, 144,
                                  18, 9, 5, 48, 264, 14, 64, 4};
template <int K>
struct Off {   // the word offset of block K, a compile-time constant
  static constexpr int v = Off<K - 1>::v + kSizes[K - 1];
};
template <>
struct Off<0> {
  static constexpr int v = 0;
};
#define OFF(k) (Off<k>::v)
constexpr int CONSTS_LEN = OFF(N_BLOCKS);

// compact blob offsets (native/src/mp3_frontend.cpp eal_mp3_granule_params_compact)
constexpr int GB_GAIN_L = 0, GB_GAIN_S = 44, GB_PE_L = 122, GB_SHORT_BASE = 124, GB_PE_S = 126,
              GB_CB_START_S = 128, GB_HAS_SHORT = 130, GB_CB_TYPE = 132, GB_SFL1 = 134,
              GB_SFS1 = 157, GB_IL_LONG = 196, GB_IL_SHORT = 219, GB_SCALARS = 232;

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
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int fdiv(int a, int b) {      // floor division
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// reference CLIP_2N: clip to [-2^n, 2^n - 1], 0 <= n <= 31
__device__ __forceinline__ W clip2n(W y, int n) {
  const W sign = y >> 31;
  const W lim = wu((1u << n) - 1u);
  return (sign.i() != (y >> n).i()) ? wu(sign.u ^ lim.u) : y;
}

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

// ------------------------------------------------------------ dequantizer

struct Sample {            // the per-sample parameters of expand_hp_device
  int gain, band, win, invperm;
  bool is_long, processed, short_proc;
};

__device__ __forceinline__ Sample expand(const int* cb, const int* cst, int ch, int i) {
  Sample s;
  const int pe_l = cb[GB_PE_L + ch], sbase = cb[GB_SHORT_BASE + ch], pe_s = cb[GB_PE_S + ch];
  const bool has_short = cb[GB_HAS_SHORT + ch] != 0;
  const int* sfb_s = cst + OFF(SFB_S);
  const bool long_proc = i < pe_l;
  const int o = i - sbase;
  const int so = clampi(o, 0, NS - 1);
  s.short_proc = o >= 0 && i < pe_s && has_short;
  const int base_s = cb[GB_CB_START_S + ch] == 3 ? sfb_s[3] : sfb_s[0];
  int sband = 0, s_sel = 0, n_sel = 1;
  for (int b = 0; b < 13; ++b) {
    const int start = 3 * (sfb_s[b] - base_s);
    if (so >= start) {
      sband = b;
      s_sel = start;
      n_sel = sfb_s[b + 1] - sfb_s[b];
    }
  }
  const int q = so - s_sel;                       // >= 0
  const int swin = q / n_sel;
  const int sinv = s_sel + n_sel * (q % 3) + q / 3;
  const int lband = cst[OFF(LONG_BAND) + i];
  s.is_long = long_proc;
  s.processed = long_proc || s.short_proc;
  if (long_proc) {
    s.band = lband;
    s.gain = cb[GB_GAIN_L + 22 * ch + lband];
    s.win = 0;
  } else if (s.short_proc) {
    s.band = sband;
    s.gain = cb[GB_GAIN_S + 39 * ch + 3 * sband + (swin < 2 ? swin : 2)];
    s.win = swin;
  } else {
    s.band = -1;
    s.gain = 0;
    s.win = 0;
  }
  s.invperm = s.short_proc ? sbase + sinv : i;
  return s;
}

// DequantBlock (reference :550-634) of one sample: (signed value, magnitude)
__device__ __forceinline__ void dequant(int sx, int scale, const int* cst, int& out, int& mag) {
  const int x = sx & 0x7FFFFFFF;
  const int scale_low = scale & 3;
  const W scalef = cst[OFF(POW14) + scale_low];
  const int scalei = min(scale >> 2, 31);
  const W tab16 = cst[OFF(POW43_14) + ((scale_low << 4) | clampi(x, 0, 15))];
  W y;
  if (x < 4) {
    y = x == 0 ? W(0) : tab16 >> clampi(scalei + 3, 0, 31);
  } else if (x < 16) {
    y = scalei < 0 ? tab16 << clampi((-W(scalei)).i(), 0, 31) : tab16 >> clampi(scalei, 0, 31);
  } else {
    W yb;
    W shb;
    if (x < 64) {
      yb = ms(W(cst[OFF(POW43) + clampi(x - 16, 0, 47)]), scalef);
      shb = W(scalei) - W(3);
    } else {
      W xn = W(x) << 17;
      int sh = 0;
      if (xn.i() < 0x08000000) { xn = xn << 4; sh += 4; }
      if (xn.i() < 0x20000000) { xn = xn << 2; sh += 2; }
      if (xn.i() < 0x40000000) { xn = xn << 1; sh += 1; }
      const int* poly = cst + (xn.i() < 0x5A82799A ? OFF(POLY43LO) : OFF(POLY43HI));
      W yp = poly[0];
      for (int k = 1; k < 5; ++k) yp = ms(yp, xn) + W(poly[k]);
      yp = ms(yp, W(cst[OFF(POW2FRAC) + sh])) << 3;
      yb = ms(yp, scalef);
      shb = W(scalei) - W(cst[OFF(POW2EXP) + sh]);
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

// WinPrevious (:1883-1935): xp[9] -> wp[18]
__device__ __forceinline__ void win_previous(const W* xp, int bt, const int* win, W* wp) {
  if (bt == 2) {
    const int* w2 = win + 2 * 36;
    wp[0] = ms(w2[6], xp[2]) + ms(w2[0], xp[6]);
    wp[1] = ms(w2[7], xp[1]) + ms(w2[1], xp[7]);
    wp[2] = ms(w2[8], xp[0]) + ms(w2[2], xp[8]);
    wp[3] = ms(w2[9], xp[0]) + ms(w2[3], xp[8]);
    wp[4] = ms(w2[10], xp[1]) + ms(w2[4], xp[7]);
    wp[5] = ms(w2[11], xp[2]) + ms(w2[5], xp[6]);
    wp[6] = ms(w2[6], xp[5]);
    wp[7] = ms(w2[7], xp[4]);
    wp[8] = ms(w2[8], xp[3]);
    wp[9] = ms(w2[9], xp[3]);
    wp[10] = ms(w2[10], xp[4]);
    wp[11] = ms(w2[11], xp[5]);
    for (int k = 12; k < 18; ++k) wp[k] = W(0);
  } else {
    const int* w = win + 36 * clampi(bt, 0, 3);
    for (int k = 0; k < 9; ++k) {
      wp[k] = ms(w[18 + k], xp[k]);
      wp[9 + k] = ms(w[27 + k], xp[8 - k]);
    }
  }
}

// FreqInvertRescale (:1937-2044); returns the OR of |y| when es > 0
__device__ __forceinline__ W freq_invert_rescale(W* y, W* np, int blk, int es) {
  if (blk & 1)
    for (int k = 1; k < 18; k += 2) y[k] = -y[k];
  W m = W(0);
  if (es > 0) {
    for (int k = 0; k < 18; ++k) {
      y[k] = clip2n(y[k], 31 - es) << es;
      m = m | wabs(y[k]);
    }
    for (int k = 0; k < 9; ++k) np[k] = clip2n(np[k], 31 - es) << es;
  }
  return m;
}

// IMDCT36 (:2174-2283) of one block
__device__ W imdct36(const int* xin, const int* xprev, int bt_curr, int bt_prev, int blk, int gb,
                     const int* cst, W* y, W* np) {
  const int es = max(7 - gb, 0);
  W xs[18], xp[9];
  for (int k = 0; k < 18; ++k) xs[k] = W(xin[k]) >> es;
  for (int k = 0; k < 9; ++k) xp[k] = W(xprev[k]) >> es;
  W xe[9], xo[9];
  W acc1 = W(0), acc2 = W(0);
  for (int i = 8; i >= 0; --i) {
    acc1 = xs[2 * i + 1] - acc1;
    acc2 = acc1 - acc2;
    acc1 = xs[2 * i] - acc1;
    xo[i] = acc2;
    xe[i] = acc1;
  }
  xo[0] = xo[0] >> 1;
  xe[0] = xe[0] >> 1;
  W even[9], odd[9];
  idct9(xe, even, cst + OFF(C9));
  idct9(xo, odd, cst + OFF(C9));

  const int* win = cst + OFF(IMDCTWIN);
  const int* fw = cst + OFF(FASTWIN36);
  const bool fast = bt_prev == 0 && bt_curr == 0;
  W wp[18];
  win_previous(xp, bt_prev, win, wp);
  const int* wc = win + 36 * clampi(bt_curr, 0, 3);
  W mout = W(0);
  for (int i = 0; i < 9; ++i) {
    const W xo_ = ms(W(cst[OFF(C18) + 8 - i]), odd[8 - i]);
    const W xe_ = even[8 - i] >> 2;
    W lo, hi;
    if (fast) {
      const W s = -xp[i];
      const W d = -(xe_ - xo_);
      const W t = s - d;
      lo = d + (ms(t, W(fw[2 * i])) << 2);
      hi = s + (ms(t, W(fw[2 * i + 1])) << 2);
    } else {
      const W d = xe_ - xo_;
      lo = (wp[i] + ms(d, W(wc[i]))) << 2;
      hi = (wp[17 - i] + ms(d, W(wc[17 - i]))) << 2;
    }
    y[i] = lo;
    y[17 - i] = hi;
    np[i] = xe_ + xo_;
    mout = mout | wabs(lo) | wabs(hi);
  }
  return mout | freq_invert_rescale(y, np, blk, es);
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

// IMDCT12x3 (:2364-2448) of one block
__device__ W imdct12x3(const int* xin, const int* xprev, int bt_prev, int blk, int gb,
                       const int* cst, W* y, W* np) {
  const int es = max(7 - gb, 0);
  W xs[18], xp[9], xb[18];
  for (int k = 0; k < 18; ++k) xs[k] = W(xin[k]) >> es;
  for (int k = 0; k < 9; ++k) xp[k] = W(xprev[k]) >> es;
  const W c3 = W(cst[OFF(C9)]);
  for (int w = 0; w < 3; ++w)
    imdct12(xs[w], xs[w + 3], xs[w + 6], xs[w + 9], xs[w + 12], xs[w + 15], c3, xb + 6 * w);
  W wp[18];
  const int* win = cst + OFF(IMDCTWIN);
  win_previous(xp, bt_prev, win, wp);
  const int* w2 = win + 2 * 36;
  W mout = W(0);
  for (int i = 0; i < 3; ++i) {
    y[i] = wp[i] << 2;
    y[3 + i] = wp[3 + i] << 2;
    y[6 + i] = (wp[6 + i] << 2) + ms(w2[i], xb[3 + i]);
    y[9 + i] = (wp[9 + i] << 2) + ms(w2[3 + i], xb[5 - i]);
    y[12 + i] = (wp[12 + i] << 2) + (ms(w2[6 + i], xb[2 - i]) + ms(w2[i], xb[9 + i]));
    y[15 + i] = (wp[15 + i] << 2) + (ms(w2[9 + i], xb[i]) + ms(w2[3 + i], xb[11 - i]));
    for (int k = 0; k < 18; k += 3) mout = mout | wabs(y[k + i]);
  }
  const int src[9] = {6, 7, 8, 12, 13, 14, 15, 16, 17};
  for (int k = 0; k < 9; ++k) np[k] = xb[src[k]] >> 2;
  return mout | freq_invert_rescale(y, np, blk, es);
}

// ------------------------------------------------------------- subband

// FDCT32 (:7776-7855) of one slot, then the 33 values the FIFO step stores
// (ops/mp3subband.py fdct_values) with the es epilogue (:7981-8005)
__device__ void fdct33(const int* x, int stride, int gb, const int* dct, int* v33) {
  const int es = max(6 - gb, 0);
  W b[32];
  for (int k = 0; k < 32; ++k) b[k] = W(x[k * stride]) >> es;
  const W cos4 = W(0x5A82799A);
  const int sh[8][3] = {{1, 5, 1}, {1, 3, 1}, {1, 3, 1}, {1, 2, 1},
                        {1, 2, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 4}};
  for (int i = 0, c = 0; i < 8; ++i, c += 3) {
    const W a0 = b[i], a3 = b[31 - i], a1 = b[15 - i], a2 = b[16 + i];
    const W b0 = a0 + a3, b3 = ms(W(dct[c]), a0 - a3) << sh[i][0];
    const W b1 = a1 + a2, b2 = ms(W(dct[c + 1]), a1 - a2) << sh[i][1];
    b[i] = b0 + b1;
    b[15 - i] = ms(W(dct[c + 2]), b0 - b1) << sh[i][2];
    b[16 + i] = b2 + b3;
    b[31 - i] = ms(W(dct[c + 2]), b3 - b2) << sh[i][2];
  }
  for (int g = 0; g < 4; ++g) {
    W* p = b + 8 * g;
    const int* d = dct + 24 + 6 * g;
    W a0 = p[0], a7 = p[7], a3 = p[3], a4 = p[4];
    W b0 = a0 + a7, b7 = ms(W(d[0]), a0 - a7) << 1;
    W b3 = a3 + a4, b4 = ms(W(d[1]), a3 - a4) << 3;
    a0 = b0 + b3;
    a3 = ms(W(d[2]), b0 - b3) << 1;
    a4 = b4 + b7;
    a7 = ms(W(d[2]), b7 - b4) << 1;
    W a1 = p[1], a6 = p[6], a2 = p[2], a5 = p[5];
    W b1 = a1 + a6, b6 = ms(W(d[3]), a1 - a6) << 1;
    W b2 = a2 + a5, b5 = ms(W(d[4]), a2 - a5) << 1;
    a1 = b1 + b2;
    a2 = ms(W(d[5]), b1 - b2) << 2;
    a5 = b5 + b6;
    a6 = ms(W(d[5]), b6 - b5) << 2;
    b0 = a0 + a1;
    b1 = ms(cos4, a0 - a1) << 1;
    b2 = a2 + a3;
    b3 = ms(cos4, a3 - a2) << 1;
    p[0] = b0;
    p[1] = b1;
    p[2] = b2 + b3;
    p[3] = b3;
    b4 = a4 + a5;
    b5 = ms(cos4, a4 - a5) << 1;
    b6 = a6 + a7;
    b7 = ms(cos4, a7 - a6) << 1;
    b6 = b6 + b7;
    p[4] = b4 + b6;
    p[5] = b5 + b7;
    p[6] = b5 + b6;
    p[7] = b7;
  }
  // output shuffle (:7856-7979): rows block 1..16, then qrows 17..32
  const signed char rec[32][3] = {
      {1, -1, -1}, {17, 25, 29}, {9, 13, -1}, {21, 25, 29}, {5, -1, -1}, {21, 29, 27},
      {13, 11, -1}, {19, 29, 27}, {3, -1, -1}, {19, 27, 31}, {11, 15, -1}, {23, 27, 31},
      {7, -1, -1}, {23, 31, -1}, {15, -1, -1}, {31, -1, -1},
      {1, -1, -1}, {17, 30, 25}, {14, 9, -1}, {22, 30, 25}, {6, -1, -1}, {22, 26, 30},
      {10, 14, -1}, {18, 26, 30}, {2, -1, -1}, {18, 28, 26}, {12, 10, -1}, {20, 28, 26},
      {4, -1, -1}, {20, 24, 28}, {8, 12, -1}, {16, 24, 28}};
  W v[V33];
  v[0] = b[0];
  for (int r = 0; r < 32; ++r) {
    W t = b[rec[r][0]];
    if (rec[r][1] >= 0) t = t + b[rec[r][1]];
    if (rec[r][2] >= 0) t = t + b[rec[r][2]];
    v[1 + r] = t;
  }
  for (int k = 0; k < V33; ++k) v33[k] = (es > 0 ? clip2n(v[k], 31 - es) << es : v[k]).i();
}

// --------------------------------------------------------------- kernel

__global__ void __launch_bounds__(THREADS) mp3_granules_kernel(Args a) {
  __shared__ int cst[CONSTS_LEN];
  __shared__ int bufA[2 * 18 * V33];     // x (2 x 576), then the FDCT values (18 x 2 x 33)
  __shared__ int bufB[2 * NS];           // dequantized samples, then the IMDCT output
  __shared__ int over[2 * 288];
  __shared__ int vb[2176];
  __shared__ int sd[3 * 2 + GPC];
  __shared__ int red[R_N];
  __shared__ int st[7];                  // prev_type[2], prev_ws[2], num_prev[2], undef

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int nch = a.nch;
  const int B = a.B;
  const int SW = 3 * nch + GPC;

  for (int k = tid; k < CONSTS_LEN; k += THREADS) cst[k] = a.consts[k];
  for (int k = tid; k < 2 * 288; k += THREADS) over[k] = a.over[(size_t)b * 576 + k];
  for (int k = tid; k < 2176; k += THREADS) vb[k] = a.vbuf[(size_t)b * 2176 + k];
  if (tid < 2) {
    st[tid] = a.prev_type[2 * b + tid];
    st[2 + tid] = a.prev_ws[2 * b + tid];
    st[4 + tid] = a.num_prev[2 * b + tid];
  }
  if (tid == 0) st[6] = 0;
  int v = a.vindex;
  const int* cb = sd + 3 * nch;

  for (int g = 0; g < a.G; ++g) {
    // ---- 0. the granule's side row; reductions reset
    const int32_t* srow = a.side + ((size_t)g * B + b) * SW;
    for (int k = tid; k < SW; k += THREADS) sd[k] = srow[k];
    if (tid < R_N) red[tid] = (tid >= R_CBL && tid < R_MOUT_MS) || tid >= R_EXT ? -1 : 0;
    __syncthreads();

    // ---- 1. widen, expand, dequantize (thread = sample, both channels)
    int invp[2];
    bool sproc[2];
    for (int ch = 0; ch < nch; ++ch) {
      const int i = tid;
      const int h = a.huff[(((size_t)g * B + b) * nch + ch) * NS + i];   // sign-extended
      const int hm = h & 0x7FFF;
      const int hs = h < 0 ? static_cast<int>(static_cast<uint32_t>(hm) | 0x80000000u) : hm;
      const Sample s = expand(cb, cst, ch, i);
      int dq = hs, mag = 0;
      if (s.processed) dequant(hs, s.gain, cst, dq, mag);
      if (mag) atomicOr(&red[R_GBMASK + ch], mag);
      if (dq != 0 && s.processed) {
        if (s.is_long) atomicMax(&red[R_CBL + ch], s.band);
        else if (s.win < 3) atomicMax(&red[R_CBS + 3 * ch + s.win], s.band);
      }
      bufB[ch * NS + i] = dq;
      invp[ch] = s.invperm;
      sproc[ch] = s.short_proc;
      if (i < 288 && over[ch * 288 + i] != 0) atomicOr(&red[R_ANYOVER + ch], 1);
    }
    __syncthreads();

    // per-channel results of the dequantizer (every thread, from shared)
    int gb[2], nzb[2], cbl[2], cbs[2][3], cbsmax[2];
    for (int ch = 0; ch < nch; ++ch) {
      gb[ch] = __clz(red[R_GBMASK + ch]) - 1;
      const bool has_short = cb[GB_HAS_SHORT + ch] != 0;
      nzb[ch] = has_short ? cb[GB_PE_S + ch] : sd[ch];
      cbl[ch] = max(red[R_CBL + ch], 0);
      cbsmax[ch] = 0;
      for (int w = 0; w < 3; ++w) {
        cbs[ch][w] = has_short ? max(red[R_CBS + 3 * ch + w], cb[GB_CB_START_S + ch]) : 0;
        cbsmax[ch] = max(cbsmax[ch], cbs[ch][w]);
      }
    }

    // ---- 2. short-block reorder and joint stereo (thread = sample)
    {
      const int i = tid;
      W x[2];
      for (int ch = 0; ch < nch; ++ch) x[ch] = bufB[ch * NS + (sproc[ch] ? invp[ch] : i)];
      if (nch == 2) {
        const int* sfb_l = cst + OFF(SFB_L);
        const int* sfb_s = cst + OFF(SFB_S);
        const int mode_ext = cb[GB_SCALARS];
        const bool m1 = cb[GB_SCALARS + 1] != 0;
        const int iscale = cb[GB_SCALARS + 2];
        const int midside = mode_ext >> 1, intensity = mode_ext & 1;
        if (mode_ext != 0 && (gb[0] < 1 || gb[1] < 1))
          for (int ch = 0; ch < 2; ++ch)
            if (i < nzb[ch]) x[ch] = W(clampi(x[ch].i(), -0x3FFFFFFF, 0x3FFFFFFF));
        // mid-side
        const bool use_long = cb[GB_CB_TYPE + 1] == 0;
        const int n_long = sfb_l[clampi(cbl[1] + 1, 0, 22)];
        const int i0 = 3 * sfb_s[clampi(cbsmax[1] + 1, 0, 13)];
        const int ms_n = intensity == 1 ? (use_long ? n_long : i0) : max(nzb[0], nzb[1]);
        W x0 = x[0], x1 = x[1];
        if (midside == 1 && i < ms_n) {
          x0 = x[0] + x[1];
          x1 = x[0] - x[1];
          atomicOr(&red[R_MOUT_MS], wabs(x0).i());
          atomicOr(&red[R_MOUT_MS + 1], wabs(x1).i());
        }
        // intensity
        const int ob_l = cst[OFF(BAND_OUT_L) + i], ob_s = cst[OFF(BAND_OUT_S) + i];
        const int ow = cst[OFF(WIN_OUT) + i];
        const int ns_in = nzb[0];
        bool active;
        if (use_long) {
          active = ob_l >= cbl[1] + 1 && ob_l < cbl[0] + 1 && ob_l >= 0 && i < ns_in;
        } else if (m1) {
          const int lim = i0 + 3 * fdiv(ns_in - i0, 3);
          active = ob_s >= cbsmax[1] + 1 && ob_s < cbsmax[0] + 1 && ob_s >= 0 && i < lim &&
                   i >= i0;
        } else {
          const int w = clampi(ow, 0, 2);
          active = ob_s >= cbs[1][w] + 1 && ob_s < cbs[0][w] + 1 && ob_s >= 0;
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
          const int* iip = cst + OFF(ISFIIP) + 2 * ms1;
          W fl, fr;
          if (m1) {
            if (sf_r == 7) {
              fl = iip[0];
              fr = iip[1];
            } else {
              const int* isf = cst + OFF(ISF1) + 7 * ms1;
              fl = isf[clampi(sf_r, 0, 6)];
              fr = W(isf[6]) - fl;
            }
          } else if (sf_r == il) {
            fl = iip[0];
            fr = iip[1];
          } else {
            const int* isf = cst + OFF(ISF2) + 16 * ((clampi(iscale, 0, 1) << 1) | ms1);
            const int half = clampi((W(sf_r) + W(1)).i() >> 1, 0, 15);
            const bool odd = (sf_r & 1) == 1;
            fl = isf[odd ? half : 0];
            fr = isf[odd ? 0 : half];
          }
          const W xl = ms(fl, x0) << 2, xr = ms(fr, x0) << 2;
          x0 = xl;
          x1 = xr;
          atomicOr(&red[R_MOUT_IS], wabs(xl).i());
          atomicOr(&red[R_MOUT_IS + 1], wabs(xr).i());
        }
        x[0] = x0;
        x[1] = x1;
      }
      for (int ch = 0; ch < nch; ++ch) {
        bufA[ch * NS + i] = x[ch].i();
        if (x[ch].i() != 0) atomicOr(&red[R_ANYX + ch], 1);
      }
    }
    __syncthreads();

    // post-stereo guard bits and nzb (reference :7694-7701)
    if (nch == 2 && cb[GB_SCALARS] != 0) {
      const int intensity = cb[GB_SCALARS] & 1;
      for (int ch = 0; ch < 2; ++ch)
        gb[ch] = __clz(red[(intensity ? R_MOUT_IS : R_MOUT_MS) + ch]) - 1;
      nzb[0] = nzb[1] = max(nzb[0], nzb[1]);
    }
    // IMDCT block counts (reference IMDCT :2584-2603)
    int nbl[2], nbfly[2], nbt[2], cws[2];
    for (int ch = 0; ch < nch; ++ch) {
      const int bt = sd[nch + ch], mixed = sd[2 * nch + ch];
      const int n_long_all = min((nzb[ch] + 7) / 18 + 1, 32);
      nbl[ch] = bt != 2 ? n_long_all : (mixed == 1 ? a.cutoff : 0);
      nbfly[ch] = bt != 2 ? nbl[ch] - 1 : (mixed == 1 ? a.cutoff - 1 : 0);
      nbt[ch] = (max(nzb[ch], nbfly[ch] * 18 + 8) + 17) / 18;
      cws[ch] = mixed == 1 ? a.cutoff : 0;
    }

    // ---- 3. anti-alias butterflies in place (thread = (channel, boundary, j))
    if (tid < nch * 31 * 8) {
      const int ch = tid / 248, bnd = (tid % 248) / 8 + 1, j = tid % 8;
      if (bnd <= nbfly[ch]) {
        int* x = bufA + ch * NS;
        const int li = 18 * bnd - 1 - j, ri = 18 * bnd + j;
        const W a0 = x[li], b0 = x[ri];
        const W c0 = cst[OFF(CSA) + 2 * j], c1 = cst[OFF(CSA) + 2 * j + 1];
        x[li] = ((ms(c0, a0) - ms(c1, b0)) << 1).i();
        x[ri] = ((ms(c0, b0) + ms(c1, a0)) << 1).i();
      }
    }
    __syncthreads();

    // ---- 4. IMDCT with overlap (thread = (channel, block))
    if (tid < nch * 32) {
      const int ch = tid / 32, blk = tid % 32;
      const int bt = sd[nch + ch], mixed = sd[2 * nch + ch];
      const int pt = st[ch], pws = st[2 + ch], npv = st[4 + ch];
      const int m_lim = max(nbl[ch], nbt[ch]);
      const bool in_long = blk < nbl[ch];
      const bool in_short = !in_long && blk < nbt[ch];
      const bool in_prev = !in_long && !in_short && blk >= m_lim && blk < npv;
      const int curr_win = (mixed == 1 && blk < cws[ch]) ? 0 : bt;
      const int prev_win = blk < pws ? 0 : pt;
      int* xprev = over + ch * 288 + 9 * blk;
      const int* xin = bufA + ch * NS + 18 * blk;
      W y[18], np[9];
      W mout = W(0);
      if (in_long) {
        mout = imdct36(xin, xprev, curr_win, prev_win, blk, gb[ch], cst, y, np);
      } else if (in_short) {
        mout = imdct12x3(xin, xprev, prev_win, blk, gb[ch], cst, y, np);
      } else if (in_prev) {
        // window previous only (HybridTransform :2482-2512)
        W xp[9];
        for (int k = 0; k < 9; ++k) xp[k] = W(xprev[k]);
        win_previous(xp, prev_win, cst + OFF(IMDCTWIN), y);
        W any = W(0);
        for (int k = 0; k < 18; ++k) {
          y[k] = y[k] << 2;
          if ((blk & 1) && (k & 1)) y[k] = -y[k];
          mout = mout | wabs(y[k]);
          any = any | y[k];
        }
        for (int k = 0; k < 9; ++k) np[k] = W(0);
        if (any.i() != 0) atomicMax(&red[R_EXT + ch], blk);
      } else {
        for (int k = 0; k < 18; ++k) y[k] = W(0);
        for (int k = 0; k < 9; ++k) np[k] = W(xprev[k]);
      }
      for (int k = 0; k < 18; ++k) bufB[ch * NS + 18 * blk + k] = y[k].i();
      for (int k = 0; k < 9; ++k) xprev[k] = np[k].i();
      if (mout.i()) atomicOr(&red[R_MOUT_IMDCT + ch], mout.i());
    }
    __syncthreads();

    // ---- 5. FDCT32 per (slot, channel); carried block state; UB flag
    if (tid < 18 * nch) {
      const int s = tid / nch, ch = tid % nch;
      fdct33(bufB + ch * NS + s, 18, __clz(red[R_MOUT_IMDCT + ch]) - 1, cst + OFF(DCTTAB),
             bufA + (2 * s + ch) * V33);
    }
    if (tid == THREADS - 1) {
      for (int ch = 0; ch < nch; ++ch) {
        if (gb[ch] == 31 && (red[R_ANYX + ch] | red[R_ANYOVER + ch])) st[6] = 1;
        st[ch] = sd[nch + ch];
        st[2 + ch] = cws[ch];
        st[4 + ch] = max(max(nbl[ch], nbt[ch]), red[R_EXT + ch]);
      }
    }
    __syncthreads();

    // ---- 6. the 18 FIFO steps: store, then the int64 PQMF
    int16_t* out = a.pcm + ((size_t)b * a.G + g) * (NS * nch);
    for (int s = 0; s < 18; ++s) {
      const int odd = s & 1;
      const int row_off = 17 * odd, qrow_off = 17 * (1 - odd), c0 = (v - odd) & 7;
      if (tid < nch * V33) {
        const int ch = tid / V33, j = tid % V33, cc = 32 * ch;
        const int val = bufA[(2 * s + ch) * V33 + j];
        int row, col;
        if (j == 0) {
          row = qrow_off + 16;
          col = c0 + cc;
        } else if (j <= 16) {
          row = row_off + j - 1;
          col = v + cc;
        } else {
          row = qrow_off + j - 17;
          col = c0 + 16 + cc;
        }
        vb[row * 64 + col] = val;
        vb[row * 64 + col + 8] = val;
      }
      __syncthreads();
      if (tid < 32 * nch) {
        const int ch = tid / 32, n = tid % 32;
        const int r = n <= 16 ? n : 32 - n;
        const int* wrow = vb + (17 * odd + r) * 64 + v + 32 * ch;
        const int* poly = cst + OFF(POLYCOEF);
        unsigned long long acc = 0;
        for (int k = 0; k < 8; ++k) {
          const long long c1 = r < 16 ? poly[16 * r + 2 * k] : poly[256 + k];
          const long long c2 = r < 16 ? poly[16 * r + 2 * k + 1] : 0;
          const long long av = wrow[k], bv = wrow[23 - k];
          if (n <= 16)
            acc += static_cast<unsigned long long>(c1 * av) - static_cast<unsigned long long>(c2 * bv);
          else
            acc += static_cast<unsigned long long>(c2 * av) + static_cast<unsigned long long>(c1 * bv);
        }
        acc += static_cast<unsigned long long>(RND);
        const int s32 = static_cast<int>(
            static_cast<uint32_t>(static_cast<unsigned long long>(static_cast<long long>(acc) >> (32 - CSHIFT))));
        int xo = s32 >> DEF_NFRACBITS;
        const int sign = xo >> 31;
        if (sign != (xo >> 15)) xo = sign ^ 0x7FFF;
        out[s * 32 * nch + n * nch + ch] = static_cast<int16_t>(xo);
      }
      __syncthreads();
      v = (v - odd) & 7;
    }
  }

  for (int k = tid; k < 2 * 288; k += THREADS) a.over[(size_t)b * 576 + k] = over[k];
  for (int k = tid; k < 2176; k += THREADS) a.vbuf[(size_t)b * 2176 + k] = vb[k];
  if (tid < 2) {
    a.prev_type[2 * b + tid] = st[tid];
    a.prev_ws[2 * b + tid] = st[2 + tid];
    a.num_prev[2 * b + tid] = st[4 + tid];
  }
  if (tid == 0) a.undef[b] = st[6];
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

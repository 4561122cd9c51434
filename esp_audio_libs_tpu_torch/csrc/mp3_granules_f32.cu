// MP3 granule kernel of the mirror tier for sm_90a: every granule of a run,
// for B streams of one format, in one launch, in f32.
//
// Replaces _granules_scan_fast_for and its body _granule_body_fast
// (esp_audio_libs_tpu/models/mp3_pipeline.py:137, :271): there an XLA
// lax.scan over the granules of a run whose step is the f32 value mirror of
// the exact tier (esp_audio_libs_tpu/ops/mp3fast.py; here ops/mp3fast.py):
// the dequantizer's closed form x^(4/3) 2^(25 - scalei - scale_low/4) with
// the exact tier's clamps and its saturation at 2147483647, joint stereo,
// the anti-alias butterflies, IMDCT36 / IMDCT12x3 / the window-previous-only
// branch with FreqInvert and the overlap, FDCT32 into the f32 FIFO and the
// dewindowing, floor(acc + 0.5) clipped to int16. Every constant is the
// mirror's: an integer table entry v scaled by a power of two, v 2^(s - 32),
// rounded once to f32. The transcendentals are exp2f / log2f (the library
// functions, not the fast intrinsics). Sums run in the mirror's order; nvcc
// may contract a product and a sum into one FMA, so the result is held to
// the plain version within 1 LSB of PCM and a relative tolerance of state,
// not bit for bit.
//
// The design is csrc/mp3_granules.cu's, simplified: one block of 288
// threads per stream, the per-format tables, the carried overlap and the
// FIFO in shared memory for the whole run, and per granule
//   1. dequantize (thread = two samples, both channels: a butterfly pair
//      where it has one), the band ends by warp reductions;
//   2. the short-block reorder, joint stereo and the butterflies on the same
//      samples in registers;
//   3. the IMDCT with the overlap, one thread per (channel, block);
//   4. FDCT32, one thread per (slot, channel), the 33 stored values of each
//      slot into the granule's linear FIFO history;
//   5. the PQMF of all 18 x 32 x nch outputs over that history (the 15
//      carried steps, then the 18 new ones; the index map of
//      ops/mp3subband.py::subband_granule_onepass), then the last 15 steps
//      moved to the front for the next granule.
// The JAX-layout ring vbuf is read once into the history and rebuilt once
// from the last 16 steps. A restored ring's two copies may disagree: the
// first granule reads each carried value from the copy that the
// step-by-step FIFO's window column falls on (the second copy is kept
// beside the history for that granule).
// The mirror's constants are integer table entries converted where they are
// used (an int-to-float conversion and an exact multiply by a power of two;
// ldexpf there cost 168 registers and 2x the time), and the registers are
// capped for two blocks an SM (MIN_BLOCKS; 2.9x faster than no cap at
// B = 256 x G = 16 on an H100, PERF.md).
// What bounds it: not bytes (a stereo granule moves about 3.3 KB in and
// 2.3 KB out per stream) and not its FP32 operations (about 5.6 x 10^4 a
// stream-granule, chip_smoke.mp3f32_work), but the chain of the five stages
// of each granule on one block, with most of the block idle in stages 3 and
// 4. Making it faster is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mp3_common.cuh"

namespace {

constexpr int THREADS = 288;     // 9 warps: two samples a thread in stages 1-2
constexpr int MIN_BLOCKS = 2;    // blocks (streams) the registers must let share an SM

// FDCT32 first-pass butterfly shifts (ops/mp3fast.py _FP_SHIFTS): s0 = 1, and
// s1, s2 of butterfly i in nibble i (as csrc/mp3_granules.cu packs them)
constexpr unsigned kFpS1 = 0x11122335u, kFpS2 = 0x42211111u;

// 2^e, |e| < 64, exactly; a constant wherever e is
__device__ __forceinline__ float pow2f(int e) {
  return e >= 0 ? static_cast<float>(1ull << e) : 1.0f / static_cast<float>(1ull << -e);
}
// the mirror's folded constant: integer table entry v as f32(v 2^(s - 32))
// (the int rounds once to f32; the power of two scales it exactly)
__device__ __forceinline__ float fc(int v, int s) { return static_cast<float>(v) * pow2f(s - 32); }
// the mirror's four-way select of a window type: 0, 1, 2, else 3
__device__ __forceinline__ int sel4(int bt) { return (bt >= 0 && bt <= 2) ? bt : 3; }

struct Args {
  const int16_t* huff;     // [G, B, nch, 576]
  const int32_t* side;     // [G, B, 3 nch + GPC]
  const int32_t* consts;   // [CONSTS_LEN]
  float* over;             // [B, 2, 288]
  int32_t* prev_type;      // [B, 2]
  int32_t* prev_ws;        // [B, 2]
  int32_t* num_prev;       // [B, 2]
  float* vbuf;             // [B, 2176]
  int16_t* pcm;            // [B, G, 576 nch]
  int G, B, nch, vindex, cutoff;
};

// shared-memory reductions of one granule, all maxima from -1
enum Red {
  R_CBL = 0,    // [2] max long band with a sample of magnitude >= 1
  R_CBS = 2,    // [2][3] max short band per window
  R_EXT = 8,    // [2] last nonzero window-previous-only block
  R_N = 10
};

// DequantBlock's value: x^(4/3) 2^(25 - scalei - scale_low / 4), the exact
// tier's clamps of the scale where they differ from the closed form, its
// saturation at 2147483647 (f32: 2^31); (signed value, magnitude)
__device__ __forceinline__ void dequant_f(int sx, int scale, float& out, float& mag) {
  const int xm = sx & 0x7FFFFFFF;
  const float x = static_cast<float>(xm);
  const float sl = static_cast<float>(scale & 3);
  const int si = min(scale >> 2, 31);
  const int si_eff = xm < 4 ? clampi(si + 3, 0, 31) - 3 : (xm < 16 ? clampi(si, -31, 31) : si);
  const float e = (25.0f - static_cast<float>(si_eff)) - 0.25f * sl;
  const float lx = log2f(fmaxf(x, 1.0f));
  float y = exp2f(lx * (4.0f / 3.0f) + e);
  y = fminf(y, 2147483648.0f);
  if (xm == 0) y = 0.0f;
  out = sx < 0 ? -y : y;
  mag = y;
}

// --------------------------------------------------------------- IMDCT

__device__ __forceinline__ void idct9_f(const float* x, float* o, const int* c9) {
  const float c0 = fc(c9[0], 1), c1 = fc(c9[1], 1), c2 = fc(c9[2], 1), c3 = fc(c9[3], 1),
              c4 = fc(c9[4], 1);
  const float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3], x4 = x[4], x5 = x[5], x6 = x[6],
              x7 = x[7], x8 = x[8];
  const float a1 = x0 - x6, a2 = x1 - x5, a3 = x1 + x5, a4 = x2 - x4, a5 = x2 + x4,
              a6 = x2 + x8, a7 = x1 + x7;
  const float a8 = a6 - a5, a9 = a3 - a7, a10 = a2 - x7, a11 = a4 - x8;
  const float m1 = c0 * x3, m3 = c0 * a10;
  const float a12 = x0 + x6 * 0.5f;
  const float a13 = a12 + m1, a14 = a12 - m1;
  const float a15 = a1 + a11 * 0.5f;
  const float a16 = c1 * a5 + c2 * a6, a17 = c1 * a8 - c2 * a5;
  const float a18 = a16 + a17;
  const float a19 = c3 * a9 + c4 * a7, a20 = c3 * a3 - c4 * a9;
  const float a21 = a20 - a19, a22 = a13 + a16, a23 = a14 + a16, a24 = a14 + a17,
              a25 = a13 + a17, a26 = a14 - a18, a27 = a13 - a18;
  o[0] = a22 + a19;
  o[1] = a15 + m3;
  o[2] = a24 + a20;
  o[3] = a26 - a21;
  o[4] = a1 - a11;
  o[5] = a27 + a21;
  o[6] = a25 - a20;
  o[7] = a15 - m3;
  o[8] = a23 - a19;
}

// imdct12: 6 strided inputs -> 6 outputs
__device__ __forceinline__ void imdct12_f(float x0, float x1, float x2, float x3, float x4,
                                          float x5, const int* c9, float* o) {
  const float c3 = fc(c9[0], 1);
  x4 = x4 - x5;
  x3 = x3 - x4;
  x2 = x2 - x3;
  x3 = x3 - x5;
  x1 = x1 - x2;
  x0 = x0 - x1;
  x1 = x1 - x3;
  x0 = x0 * 0.5f;
  x1 = x1 * 0.5f;
  float a0 = c3 * x2, a1 = x0 + x4 * 0.5f, a2 = x0 - x4;
  const float o0 = a1 + a0, o2 = a2, o4 = a1 - a0;
  a0 = c3 * x3;
  a1 = x1 + x5 * 0.5f;
  a2 = x1 - x5;
  const float o1 = fc(0x7BA3751D, 2) * (a1 + a0);
  const float o3 = fc(0x5A82799A, 2) * a2;
  const float o5 = fc(0x2120FB83, 2) * (a1 - a0);
  o[0] = o0 + o1;
  o[1] = o2 + o3;
  o[2] = o4 + o5;
  o[3] = o4 - o5;
  o[4] = o2 - o3;
  o[5] = o0 - o1;
}

// WinPrevious's value, entry k (0..17), from the carried overlap xp[9]
__device__ __forceinline__ float win_prev_f(const float* xp, int bt, const int* win, int k) {
  if (bt == 2) {
    const int* w2 = win + 2 * 36;
    if (k < 6) {
      const int ia = k < 3 ? 2 - k : k - 3;
      return fc(w2[6 + k], 0) * xp[ia] + fc(w2[k], 0) * xp[8 - ia];
    }
    if (k < 12) return fc(w2[k], 0) * xp[k < 9 ? 11 - k : k - 6];
    return 0.0f;
  }
  return fc(win[36 * sel4(bt) + 18 + k], 0) * xp[k < 9 ? k : 17 - k];
}

// ------------------------------------------------------------- FDCT32

__device__ __forceinline__ void fdct32_f(float* buf, const int* dct) {
  const float cos4 = fc(0x5A82799A, 1);
  int c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a0 = buf[i], a3 = buf[31 - i], a1 = buf[15 - i], a2 = buf[16 + i];
    const int s1 = (kFpS1 >> (4 * i)) & 15, s2 = (kFpS2 >> (4 * i)) & 15;
    const float b0 = a0 + a3, b3 = fc(dct[c], 1) * (a0 - a3);
    const float b1 = a1 + a2, b2 = fc(dct[c + 1], s1) * (a1 - a2);
    buf[i] = b0 + b1;
    buf[15 - i] = fc(dct[c + 2], s2) * (b0 - b1);
    buf[16 + i] = b2 + b3;
    buf[31 - i] = fc(dct[c + 2], s2) * (b3 - b2);
    c += 3;
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float* p = buf + 8 * g;
    const int* d = dct + 24 + 6 * g;
    float a0 = p[0], a7 = p[7], a3 = p[3], a4 = p[4];
    float b0 = a0 + a7, b7 = fc(d[0], 1) * (a0 - a7);
    float b3 = a3 + a4, b4 = fc(d[1], 3) * (a3 - a4);
    a0 = b0 + b3;
    a3 = fc(d[2], 1) * (b0 - b3);
    a4 = b4 + b7;
    a7 = fc(d[2], 1) * (b7 - b4);
    float a1 = p[1], a6 = p[6], a2 = p[2], a5 = p[5];
    float b1 = a1 + a6, b6 = fc(d[3], 1) * (a1 - a6);
    float b2 = a2 + a5, b5 = fc(d[4], 1) * (a2 - a5);
    a1 = b1 + b2;
    a2 = fc(d[5], 2) * (b1 - b2);
    a5 = b5 + b6;
    a6 = fc(d[5], 2) * (b6 - b5);
    b0 = a0 + a1;
    b1 = cos4 * (a0 - a1);
    b2 = a2 + a3;
    b3 = cos4 * (a3 - a2);
    p[0] = b0;
    p[1] = b1;
    p[2] = b2 + b3;
    p[3] = b3;
    b4 = a4 + a5;
    b5 = cos4 * (a4 - a5);
    b6 = a6 + a7;
    b7 = cos4 * (a7 - a6);
    b6 = b6 + b7;
    p[4] = b4 + b6;
    p[5] = b5 + b7;
    p[6] = b5 + b6;
    p[7] = b7;
  }
}

// ------------------------------------------------------------- kernel

struct Smem {
  int tab[CONSTS_LEN - OFF(SFB_L)];  // the per-format tables (TB offsets)
  int bandpack[NS];                  // long_band | band_out_l, band_out_s, win_out << 8, 16, 24
  uint32_t shtab[2 * NS];            // short_word of each offset, base sfb_s[0] then sfb_s[3]
  float hist[HN * HSTEP];            // the granule's FIFO history: step s at slot CARRY + s
  float hist2[CARRY * HSTEP];        // the ring's second copy of the carried steps (first granule)
  float bufA[2 * NS];                // the stereo samples after the butterflies
  float bufB[2 * NS];                // dequantized samples, then the IMDCT output
  float over[2 * 288];
  float pc1[17 * 8];                 // PQMF taps C1[r][k], 2^-26 folded in (row 16: poly[256 + k])
  float pc2[16 * 8];                 // C2[r][k]
  int sd[SW_MAX];                    // the granule's side row
  int red[R_N];
  int st[6];                         // prev_type[2], prev_ws[2], num_prev[2]
  uint32_t recipes[V33];
};

// Joint stereo of the thread's two samples (value mirror: mid-side sums,
// intensity factors fl, fr = f32(table / 2^30); no clip pass)
__device__ __forceinline__ void stereo_f(Smem& S, const int* sd, int ia, int ib, float x[2][2]) {
  const int* cb = sd + 6;
  const int* tb = S.tab;
  const int* red = S.red;
  const int mode_ext = cb[GB_SCALARS];
  const int* sfb_l = tb + TB(SFB_L);
  const int* sfb_s = tb + TB(SFB_S);
  const bool has_s0 = cb[GB_HAS_SHORT] != 0, has_s1 = cb[GB_HAS_SHORT + 1] != 0;
  const int cbl0 = max(red[R_CBL], 0), cbl1 = max(red[R_CBL + 1], 0);
  int cbs[2][3];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int w = 0; w < 3; ++w)
      cbs[ch][w] = (ch ? has_s1 : has_s0) ? max(red[R_CBS + 3 * ch + w], cb[GB_CB_START_S + ch])
                                          : 0;
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
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = e ? ib : ia;
    float x0 = x[0][e], x1 = x[1][e];
    if (midside == 1 && i < ms_n) {
      x0 = x[0][e] + x[1][e];
      x1 = x[0][e] - x[1][e];
    }
    const int bp = S.bandpack[i];
    const int ob_l = byte_of(bp, 1), ob_s = byte_of(bp, 2), ow = byte_of(bp, 3);
    bool active;
    if (use_long) {
      active = ob_l >= cbl1 + 1 && ob_l < cbl0 + 1 && ob_l >= 0 && i < nzb0;
    } else if (m1) {
      const int lim = i0 + 3 * fdiv(nzb0 - i0, 3);
      active = ob_s >= cbsmax1 + 1 && ob_s < cbsmax0 + 1 && ob_s >= 0 && i < lim && i >= i0;
    } else {
      const int w = (ow == 0 || ow == 1) ? ow : 2;
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
      float fl, fr;
      if (m1) {
        if (sf_r == 7) {
          fl = fc(iip[0], 2);
          fr = fc(iip[1], 2);
        } else {
          const int* isf = tb + TB(ISF1) + 7 * ms1;
          fl = fc(isf[clampi(sf_r, 0, 6)], 2);
          fr = fc(isf[6], 2) - fl;
        }
      } else if (sf_r == il) {
        fl = fc(iip[0], 2);
        fr = fc(iip[1], 2);
      } else {
        const int* isf = tb + TB(ISF2) + 16 * ((clampi(iscale, 0, 1) << 1) | ms1);
        const int half = clampi((sf_r + 1) >> 1, 0, 15);
        const bool odd = (sf_r & 1) == 1;
        fl = fc(isf[odd ? half : 0], 2);
        fr = fc(isf[odd ? 0 : half], 2);
      }
      x1 = fr * x0;
      x0 = fl * x0;
    }
    x[0][e] = x0;
    x[1][e] = x1;
  }
}

// One (channel, block) of the hybrid synthesis: y[18] and the new overlap
// np[9] from the block's 18 stereo samples xin and its carried overlap xp
__device__ __forceinline__ void imdct_block(const Smem& S, const float* xin, const float* xp,
                                            bool in_long, bool in_short, bool in_prev,
                                            int curr_win, int prev_win, int blk, float* y,
                                            float* np, bool& any) {
  const int* tb = S.tab;
  const int* win = tb + TB(IMDCTWIN);
  const int* c9 = tb + TB(C9);
  any = false;
  if (in_long) {
    float xe[9], xo[9], even[9], odd[9];
    float acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll
    for (int i = 8; i >= 0; --i) {
      acc1 = xin[2 * i + 1] - acc1;
      acc2 = acc1 - acc2;
      acc1 = xin[2 * i] - acc1;
      xo[i] = acc2;
      xe[i] = acc1;
    }
    xo[0] = xo[0] * 0.5f;
    xe[0] = xe[0] * 0.5f;
    idct9_f(xe, even, c9);
    idct9_f(xo, odd, c9);
    const bool fast = prev_win == 0 && curr_win == 0;
    const int* wc = win + 36 * sel4(curr_win);
    const int* fw = tb + TB(FASTWIN36);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float xo_ = fc(tb[TB(C18) + 8 - i], 0) * odd[8 - i];
      const float xe_ = even[8 - i] * 0.25f;
      if (fast) {
        const float s = -xp[i];
        const float d = -(xe_ - xo_);
        const float t = s - d;
        y[i] = d + t * fc(fw[2 * i], 2);
        y[17 - i] = s + t * fc(fw[2 * i + 1], 2);
      } else {
        const float d = xe_ - xo_;
        y[i] = (win_prev_f(xp, prev_win, win, i) + d * fc(wc[i], 0)) * 4.0f;
        y[17 - i] = (win_prev_f(xp, prev_win, win, 17 - i) + d * fc(wc[17 - i], 0)) * 4.0f;
      }
      np[i] = xe_ + xo_;
    }
  } else if (in_short) {
    float xb[18];
#pragma unroll
    for (int w = 0; w < 3; ++w)
      imdct12_f(xin[w], xin[w + 3], xin[w + 6], xin[w + 9], xin[w + 12], xin[w + 15], c9,
                xb + 6 * w);
    const int* w2 = win + 2 * 36;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      y[0 + i] = win_prev_f(xp, prev_win, win, 0 + i) * 4.0f;
      y[3 + i] = win_prev_f(xp, prev_win, win, 3 + i) * 4.0f;
      y[6 + i] = win_prev_f(xp, prev_win, win, 6 + i) * 4.0f + fc(w2[0 + i], 0) * xb[3 + i];
      y[9 + i] = win_prev_f(xp, prev_win, win, 9 + i) * 4.0f + fc(w2[3 + i], 0) * xb[5 - i];
      y[12 + i] = win_prev_f(xp, prev_win, win, 12 + i) * 4.0f +
                  (fc(w2[6 + i], 0) * xb[2 - i] + fc(w2[0 + i], 0) * xb[9 + i]);
      y[15 + i] = win_prev_f(xp, prev_win, win, 15 + i) * 4.0f +
                  (fc(w2[9 + i], 0) * xb[0 + i] + fc(w2[3 + i], 0) * xb[11 - i]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) np[k] = xb[k < 3 ? 6 + k : 9 + k] * 0.25f;   // 6..8, 12..17
  } else if (in_prev) {     // window previous only (HybridTransform :2482-2512)
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      y[k] = win_prev_f(xp, prev_win, win, k) * 4.0f;
      any = any || y[k] != 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) np[k] = 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < 18; ++k) y[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) np[k] = xp[k];
  }
  if (blk & 1) {            // FreqInvert: odd samples of odd blocks negated
#pragma unroll
    for (int k = 1; k < 18; k += 2) y[k] = -y[k];
  }
}

// The PQMF of all 18 x 32 x nch outputs of a granule over its history.
// Item (s, ch, r), r = 0..15: row r gives outputs r (lo) and 32 - r (hi);
// row 0 gives output 0 and, in hi's place, output 16 (row 16). With A[k] =
// value 1 + r of step s - 2k (row 16: value 0 of step s - 2k - 1) and
// Bv[k] = value 17 + r of step s - 15 + 2k:
//   lo = sum_k c1 A - c2 Bv,  hi = sum_k c2 A + c1 Bv  (row 16: C1[16] A)
// In the first granule a carried value is read from the ring copy the
// step-by-step FIFO's window column falls on: column vs + k of the rows
// block, vs + 23 - k of the qrows block, the second copy from 8 on.
__device__ __forceinline__ void pqmf_f(const Smem& S, int16_t* out, int nch, int v, bool first) {
#pragma unroll 1
  for (int item = threadIdx.x; item < 18 * nch * 16; item += THREADS) {
    const int r = item & 15, hi_ = item >> 4;
    const int ch = nch == 2 ? hi_ & 1 : 0, s = nch == 2 ? hi_ >> 1 : hi_;
    const float* hc = S.hist + (CARRY + s) * HSTEP + ch;    // step s; earlier below
    const float* dc = S.hist2 + (CARRY + s) * HSTEP + ch;   // the second copy, steps < 0
    const int vs = (v - (s >> 1)) & 7;
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int sa = s - 2 * k, s2 = sa - 1, sb = s - 15 + 2 * k;
      float av = hc[-2 * k * HSTEP + 2 * (1 + r)];
      float a16 = hc[(-2 * k - 1) * HSTEP];
      float bv = hc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      if (first) {
        const bool da = vs + k >= 8, db = vs + 7 - k >= 8;
        if (da && sa < 0) av = dc[-2 * k * HSTEP + 2 * (1 + r)];
        if (da && s2 < 0) a16 = dc[(-2 * k - 1) * HSTEP];
        if (db && sb < 0) bv = dc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      }
      const float c1 = S.pc1[8 * r + k], c2 = S.pc2[8 * r + k];
      lo += c1 * av - c2 * bv;
      hi += r ? c2 * av + c1 * bv : S.pc1[8 * 16 + k] * a16;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float q = fminf(fmaxf(floorf((e ? hi : lo) + 0.5f), -32768.0f), 32767.0f);
      const int n = e ? (r ? 32 - r : 16) : r;
      out[s * 32 * nch + n * nch + ch] = static_cast<int16_t>(q);
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mp3_granules_f32_kernel(Args a) {
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
  if (tid < V33) S.recipes[tid] = kRecipes[tid];
  {
    const float* vb = a.vbuf + (size_t)b * 2176;
    for (int k = tid; k < CARRY * nch * V33; k += THREADS) {
      const int s = k / (nch * V33) - CARRY, ch = (k / V33) % nch, j = k % V33;
      const int cell = ring_cell(s, a.vindex, j, ch);
      S.hist[(CARRY + s) * HSTEP + 2 * j + ch] = vb[cell];
      S.hist2[(CARRY + s) * HSTEP + 2 * j + ch] = vb[cell + 8];
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * NS; k += THREADS) {
    const int* sfb_s = tb + TB(SFB_S);
    S.shtab[k] = short_word(sfb_s, k >= NS ? sfb_s[3] : sfb_s[0], k % NS);
  }
  if (tid < 17 * 8) {   // PQMF taps (ops/mp3subband.py _poly_coefs_np), 2^-26 folded in
    const int r = tid / 8, k = tid % 8;
    const int* poly = tb + TB(POLYCOEF);
    S.pc1[tid] = fc(r < 16 ? poly[16 * r + 2 * k] : poly[256 + k], 6);
    if (r < 16) S.pc2[tid] = fc(poly[16 * r + 2 * k + 1], 6);
  }

  int ia, ib, bnd;
  samples_of(tid, ia, ib, bnd);
  int v = a.vindex;
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const int* sd = S.sd;
    const int* cb = sd + 3 * nch;
    if (tid < SW) S.sd[tid] = a.side[((size_t)g * B + b) * SW + tid];
    if (tid < R_N) S.red[tid] = -1;
    __syncthreads();   // the side row

    // ---- 1. widen, expand, dequantize (both channels of two samples)
    int src[2][2] = {};      // where stage 2 reads each sample: the reorder's source
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      if (ch >= nch) break;
      const Chan c = chan_of(cb, ch);
      const int16_t* hp = a.huff + (((size_t)g * B + b) * nch + ch) * NS;
      int cbl = -1, cbs0 = -1, cbs1 = -1, cbs2 = -1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = e ? ib : ia;
        const int h = hp[i];                           // sign-extended int16
        const int hm = h & 0x7FFF;
        const int hs = h < 0 ? static_cast<int>(static_cast<uint32_t>(hm) | 0x80000000u) : hm;
        const bool long_proc = i < c.pe_l;
        const int o = i - c.sbase;
        const bool short_proc = o >= 0 && i < c.pe_s && c.has_short;
        float d = static_cast<float>(hs);              // unprocessed: the raw value, as the mirror
        src[ch][e] = i;
        if (long_proc || short_proc) {
          const uint32_t sw = S.shtab[c.tab + clampi(o, 0, NS - 1)];
          if (short_proc) src[ch][e] = c.sbase + static_cast<int>(sw >> 8);
          const int sband = sw & 15, swin = (sw >> 4) & 3;
          const int lband = byte_of(S.bandpack[i], 0);
          const int gain = long_proc ? cb[GB_GAIN_L + 22 * ch + lband]
                                     : cb[GB_GAIN_S + 39 * ch + 3 * sband + min(swin, 2)];
          float mag;
          dequant_f(hs, gain, d, mag);
          if (mag >= 1.0f) {     // the exact tier's nonzero: its value truncates to nonzero
            if (long_proc) cbl = max(cbl, lband);
            else if (swin == 0) cbs0 = max(cbs0, sband);
            else if (swin == 1) cbs1 = max(cbs1, sband);
            else if (swin == 2) cbs2 = max(cbs2, sband);
          }
        }
        S.bufB[ch * NS + i] = d;
      }
      warp_max(&S.red[R_CBL + ch], cbl);
      warp_max(&S.red[R_CBS + 3 * ch], cbs0);
      warp_max(&S.red[R_CBS + 3 * ch + 1], cbs1);
      warp_max(&S.red[R_CBS + 3 * ch + 2], cbs2);
    }
    __syncthreads();   // the dequantized samples and their band ends

    // ---- 2. short-block reorder, joint stereo, butterflies (same samples)
    {
      float x[2][2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int e = 0; e < 2; ++e) x[ch][e] = ch < nch ? S.bufB[ch * NS + src[ch][e]] : 0.0f;
      if (nch == 2 && cb[GB_SCALARS] != 0) stereo_f(S, sd, ia, ib, x);
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        if (bnd != 0 && bnd <= blocks_of(sd, nch, ch, a.cutoff).nbfly) {
          const int j = tid % 8;    // anti-alias butterfly (li, ri) = (ia, ib)
          const float a0 = x[ch][0], b0 = x[ch][1];
          const float c0 = fc(tb[TB(CSA) + 2 * j], 1), c1 = fc(tb[TB(CSA) + 2 * j + 1], 1);
          x[ch][0] = c0 * a0 - c1 * b0;
          x[ch][1] = c0 * b0 + c1 * a0;
        }
        S.bufA[ch * NS + ia] = x[ch][0];
        S.bufA[ch * NS + ib] = x[ch][1];
      }
    }
    __syncthreads();   // the stereo samples

    // ---- 3. IMDCT with overlap, one thread per (channel, block)
    if (tid < 32 * nch) {
      const int ch = tid >> 5, blk = tid & 31;
      const Blocks nb = blocks_of(sd, nch, ch, a.cutoff);
      const int bt = sd[nch + ch], mixed = sd[2 * nch + ch];
      const int pt = S.st[ch], pws = S.st[2 + ch], npv = S.st[4 + ch];
      const int m_lim = max(nb.nbl, nb.nbt);
      const bool in_long = blk < nb.nbl;
      const bool in_short = !in_long && blk < nb.nbt;
      const bool in_prev = !in_long && !in_short && blk >= m_lim && blk < npv;
      const int curr_win = (mixed == 1 && blk < nb.cws) ? 0 : bt;
      const int prev_win = blk < pws ? 0 : pt;
      float xp[9], y[18], np[9];
      float* over = S.over + ch * 288 + 9 * blk;
#pragma unroll
      for (int k = 0; k < 9; ++k) xp[k] = over[k];
      bool any;
      imdct_block(S, S.bufA + ch * NS + 18 * blk, xp, in_long, in_short, in_prev, curr_win,
                  prev_win, blk, y, np, any);
#pragma unroll
      for (int k = 0; k < 18; ++k) S.bufB[ch * NS + 18 * blk + k] = y[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) over[k] = np[k];
      if (in_prev && any) atomicMax(&S.red[R_EXT + ch], blk);
    }
    __syncthreads();   // the IMDCT output, the new overlap

    // ---- 4. FDCT32 per (slot, channel) into the history; the carried block state
    if (tid < 18 * nch) {
      const int ch = tid / 18, s = tid % 18;
      float buf[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) buf[k] = S.bufB[ch * NS + 18 * k + s];
      fdct32_f(buf, tb + TB(DCTTAB));
      float* hrow = S.hist + (CARRY + s) * HSTEP + ch;
#pragma unroll
      for (int j = 0; j < V33; ++j) {
        const uint32_t r = S.recipes[j];
        const int n = r >> 15;
        float vv = buf[r & 31];
        if (n > 1) vv = vv + buf[(r >> 5) & 31];
        if (n > 2) vv = vv + buf[(r >> 10) & 31];
        hrow[2 * j] = vv;
      }
    } else if (tid == THREADS - 1) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        const Blocks nb = blocks_of(sd, nch, ch, a.cutoff);
        S.st[ch] = sd[nch + ch];
        S.st[2 + ch] = nb.cws;
        S.st[4 + ch] = max(max(nb.nbl, nb.nbt), S.red[R_EXT + ch]);
      }
    }
    __syncthreads();   // the history

    // ---- 5. the PQMF; then the last 15 steps become the next granule's carried ones
    pqmf_f(S, a.pcm + ((size_t)b * G + g) * (NS * nch), nch, v, g == 0);
    if (g + 1 < G) {
      __syncthreads();
      for (int k = tid; k < CARRY * HSTEP; k += THREADS) S.hist[k] = S.hist[18 * HSTEP + k];
      v = (v - 9) & 7;
    }
    __syncthreads();
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
  {
    float* vb = a.vbuf + (size_t)b * 2176;
    for (int k = tid; k < 16 * nch * V33; k += THREADS) {
      const int s = 2 + k / (nch * V33), ch = (k / V33) % nch, j = k % V33;
      const float val = S.hist[(CARRY + s) * HSTEP + 2 * j + ch];
      const int cell = ring_cell(s, v, j, ch);
      vb[cell] = val;
      vb[cell + 8] = val;
    }
  }
}

}  // namespace

extern "C" int eal_mp3_granules_f32(const void* huff, const void* side, const void* consts,
                                    void* over, void* prev_type, void* prev_ws, void* num_prev,
                                    void* vbuf, void* pcm, int G, int B, int nch, int vindex,
                                    int cutoff, void* stream) {
  if (G < 1 || B < 1 || (nch != 1 && nch != 2) || vindex < 0 || vindex > 7 || cutoff < 1 ||
      cutoff > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.huff = static_cast<const int16_t*>(huff);
  a.side = static_cast<const int32_t*>(side);
  a.consts = static_cast<const int32_t*>(consts);
  a.over = static_cast<float*>(over);
  a.prev_type = static_cast<int32_t*>(prev_type);
  a.prev_ws = static_cast<int32_t*>(prev_ws);
  a.num_prev = static_cast<int32_t*>(num_prev);
  a.vbuf = static_cast<float*>(vbuf);
  a.pcm = static_cast<int16_t*>(pcm);
  a.G = G;
  a.B = B;
  a.nch = nch;
  a.vindex = vindex;
  a.cutoff = cutoff;
  mp3_granules_f32_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
// functions, not the fast intrinsics). Sums run in the mirror's order, and
// every product that feeds a sum is rounded on its own (mul: __fmul_rn,
// which nvcc never contracts into an FMA). Through tools/cuda_cpu_shim.h
// (with the plain version's exp2 / log2 taken from the same C library) the
// kernel equals the plain version bit for bit; on the card its state
// equals it and its PCM is within 1 LSB (PERF.md).
//
// The first design (one 288-thread block per stream, five stages a granule
// in turn, seven barriers) took 0.159 / 1.292 ms at B = 256 / 2048 x G = 16
// on an H100; cutting one stage out saved: the IMDCT, on 64 threads, 0.041 /
// 0.304 ms; FDCT32, on 36, 0.038 / 0.300; the PQMF 0.023 / 0.179; the
// dequantizer 0.008 / 0.069; the history's front copy 0.0015 / 0.021
// (tools/kernel_variants.py --mp3f32, PERF.md).
//
// This design is csrc/mp3_granules.cu's: one block of 288 threads (9 warps)
// per stream, registers capped at 72 (MIN_BLOCKS = 3 blocks, i.e. streams,
// share an SM; ptxas spills nothing there), so that one stream's narrow
// stages overlap another's wide ones. The per-format tables, the carried
// overlap and the FIFO live in shared memory for the whole run. A granule
// takes four block barriers:
//   1. widen, expand and dequantize (thread = two samples, both channels: a
//      butterfly pair where it has one), the band ends by warp reductions;
//   2. the short-block reorder, joint stereo and the butterflies on the same
//      samples in registers;
//   3. IMDCT36 / IMDCT12x3 / the window-previous-only branch with the
//      overlap, two threads per (channel, subband block), each running one
//      of the two 9-point IDCTs (or the short windows), then half the
//      outputs and half the new overlap; beside it, on the other warps, the
//      previous granule's PQMF;
//   4. FDCT32 of the 18 slots, eight threads per (slot, channel), warp
//      shuffles between the butterfly passes, the 33 stored values of each
//      slot written into the granule's linear FIFO history, and those of
//      steps 3..17 also into the other history as the next granule's
//      carried steps.
// The PQMF computes all 18 x 32 x nch outputs of a granule in one pass over
// its history (the 15 carried steps, then the 18 new ones; the index map of
// ops/mp3subband.py::subband_granule_onepass); two histories alternate
// between granules, so nothing moves the carried steps. The side row and
// the spectra of granule g + 1 are loaded while granule g runs. The
// JAX-layout ring vbuf is read once into the histories and rebuilt once
// from the last 16 steps. A restored ring's two copies may disagree: the
// first granule reads each carried value from the copy that the
// step-by-step FIFO's window column falls on (the second copy waits in the
// other history's slots 18..32, which granule 1 writes after that PQMF).
// The mirror's constants are integer table entries converted where they are
// used (an int-to-float conversion and an exact multiply by a power of two;
// ldexpf there cost 168 registers and 2x the time).
// What bounds it: not bytes (a stereo granule moves about 3.3 KB in and
// 2.3 KB out per stream) and not its FP32 operations (about 5.6 x 10^4 a
// stream-granule, chip_smoke.mp3f32_work), but the latency of each
// granule's chain of four stages on a block: no stage's cut saves more than
// about a tenth of the time. On an H100: about 0.11 / 0.71 ms at B = 256 /
// 2048 x G = 16 (PERF.md).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mp3_common.cuh"

namespace {

constexpr int THREADS = 288;     // 9 warps: two samples a thread in stages 1-2
constexpr int MIN_BLOCKS = 3;    // blocks (streams) the registers must let share an SM
constexpr int HBUF = HN * HSTEP; // one granule's history; granules alternate two of them
constexpr int FD_STRIDE = 33;    // FDCT scratch words per (slot, channel)

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
// a product rounded on its own: __fmul_rn is never contracted into an FMA
// with the sum it feeds, so every sum rounds as the mirror's does
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
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
  const float e = (25.0f - static_cast<float>(si_eff)) - mul(0.25f, sl);
  const float lx = log2f(fmaxf(x, 1.0f));
  float y = exp2f(mul(lx, 4.0f / 3.0f) + e);
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
  const float m1 = mul(c0, x3), m3 = mul(c0, a10);
  const float a12 = x0 + mul(x6, 0.5f);
  const float a13 = a12 + m1, a14 = a12 - m1;
  const float a15 = a1 + mul(a11, 0.5f);
  const float a16 = mul(c1, a5) + mul(c2, a6), a17 = mul(c1, a8) - mul(c2, a5);
  const float a18 = a16 + a17;
  const float a19 = mul(c3, a9) + mul(c4, a7), a20 = mul(c3, a3) - mul(c4, a9);
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
  x0 = mul(x0, 0.5f);
  x1 = mul(x1, 0.5f);
  float a0 = mul(c3, x2), a1 = x0 + mul(x4, 0.5f), a2 = x0 - x4;
  const float o0 = a1 + a0, o2 = a2, o4 = a1 - a0;
  a0 = mul(c3, x3);
  a1 = x1 + mul(x5, 0.5f);
  a2 = x1 - x5;
  const float o1 = mul(fc(0x7BA3751D, 2), a1 + a0);
  const float o3 = mul(fc(0x5A82799A, 2), a2);
  const float o5 = mul(fc(0x2120FB83, 2), a1 - a0);
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
      return mul(fc(w2[6 + k], 0), xp[ia]) + mul(fc(w2[k], 0), xp[8 - ia]);
    }
    if (k < 12) return mul(fc(w2[k], 0), xp[k < 9 ? 11 - k : k - 6]);
    return 0.0f;
  }
  return mul(fc(win[36 * sel4(bt) + 18 + k], 0), xp[k < 9 ? k : 17 - k]);
}

// ------------------------------------------------------------- kernel

struct Smem {
  int tab[CONSTS_LEN - OFF(SFB_L)];  // the per-format tables (TB offsets)
  int bandpack[NS];                  // long_band | band_out_l, band_out_s, win_out << 8, 16, 24
  uint32_t shtab[2 * NS];            // short_word of each offset, base sfb_s[0] then sfb_s[3]
  float hist[2 * HBUF];              // FIFO histories of granules g (g & 1) and g - 1, see pqmf_f
  float bufA[2 * 18 * FD_STRIDE];    // x (2 x 576), the IMDCT scratch, the FDCT scratch (36 x 33)
  float bufB[2 * NS];                // dequantized samples, then the IMDCT output
  float over[2 * 288];
  float xpc[2 * 288];                // the overlap as the granule found it (IMDCT reads it)
  float4 pq[8 * 16];                 // PQMF taps [k][r]: (C1, C2, row 16's tap, 0), see pqmf_f
  int sd[2][SW_MAX];                 // side rows of granules g and g + 1
  int red[2][R_N];                   // reductions of granules g and g + 1
  int st[6];                         // prev_type[2], prev_ws[2], num_prev[2]
  uint32_t recipes[V33];
};

// Joint stereo of the thread's two samples (value mirror: mid-side sums,
// intensity factors fl, fr = f32(table / 2^30); no clip pass)
__device__ __forceinline__ void stereo_f(const Smem& S, const int* sd, const int* red, int ia,
                                         int ib, float x[2][2]) {
  const int* cb = sd + 6;
  const int* tb = S.tab;
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
      x1 = mul(fr, x0);
      x0 = mul(fl, x0);
    }
    x[0][e] = x0;
    x[1][e] = x1;
  }
}

// Output k of block blk after FreqInvert (odd outputs of odd blocks negated)
__device__ __forceinline__ float inv(float y, int k, int blk) {
  return ((blk & 1) && (k & 1)) ? -y : y;
}

// The PQMF of all 18 x 32 x nch outputs of a granule over its history,
// after its stage 4. Item (s, ch, r), r = 0..15: row r gives outputs r (lo)
// and 32 - r (hi); row 0 gives output 0 and, in hi's place, output 16 (row
// 16). With A[k] = value 1 + r of step s - 2k (row 16: value 0 of step
// s - 2k - 1) and Bv[k] = value 17 + r of step s - 15 + 2k:
//   lo = sum_k c1 A - c2 Bv,  hi = sum_k c2 A + c1 Bv  (row 16: C1[16] A)
// in the mirror's order, k = 0..7.
// The history of granule g is hist[g & 1]: step s (-15..17) at HSTEP words
// from slot CARRY + s. Stage 4 of granule g writes its steps 3..17 into
// both histories (the other one's slots 0..14 are the next granule's
// carried steps), so no granule moves its history. In the first granule
// (FIRST) a carried value is read from the ring copy the step-by-step
// FIFO's window column falls on: column vs + k of the rows block, vs + 23 - k
// of the qrows block, the second copy from 8 on; that copy lies in the other
// history's slots 18..32 (HN + s), which granule 1 writes only after this
// PQMF has run. Threads t0 .. t0 + nt - 1 run it (nt a multiple of 16).
template <bool FIRST>
__device__ __forceinline__ void pqmf_f(const Smem& S, int buf, int16_t* out, int nch, int v,
                                       int t0, int nt) {
  const int r = (threadIdx.x - t0) & 15;
#pragma unroll 1
  for (int item = threadIdx.x - t0; item < 18 * nch * 16; item += nt) {
    const int hi_ = item >> 4;
    const int ch = nch == 2 ? hi_ & 1 : 0, s = nch == 2 ? hi_ >> 1 : hi_;
    const float* hc = S.hist + buf * HBUF + (CARRY + s) * HSTEP + ch;   // step s; earlier below
    const float* dc = S.hist + (buf ^ 1) * HBUF + (HN + s) * HSTEP + ch;
    const int vs = (v - (s >> 1)) & 7;
    float lo = 0.0f, hi = 0.0f;
#pragma unroll 2
    for (int k = 0; k < 8; ++k) {
      const float4 c = S.pq[16 * k + r];
      const int sa = s - 2 * k, s2 = sa - 1, sb = s - 15 + 2 * k;
      float av = hc[-2 * k * HSTEP + 2 * (1 + r)];
      float a16 = hc[(-2 * k - 1) * HSTEP];
      float bv = hc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      if (FIRST) {
        const bool da = vs + k >= 8, db = vs + 7 - k >= 8;
        if (da && sa < 0) av = dc[-2 * k * HSTEP + 2 * (1 + r)];
        if (da && s2 < 0) a16 = dc[(-2 * k - 1) * HSTEP];
        if (db && sb < 0) bv = dc[(2 * k - 15) * HSTEP + 2 * (17 + r)];
      }
      lo += mul(c.x, av) - mul(c.y, bv);
      hi += r ? mul(c.y, av) + mul(c.x, bv) : mul(c.z, a16);
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
  if (tid < R_N) S.red[0][tid] = -1;
  if (tid < SW) S.sd[0][tid] = a.side[(size_t)b * SW + tid];
  {
    const float* vb = a.vbuf + (size_t)b * 2176;
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
  if (tid < 8 * 16) {   // PQMF taps (ops/mp3subband.py _poly_coefs_np), 2^-26 folded in
    const int k = tid / 16, r = tid % 16;
    const int* poly = tb + TB(POLYCOEF);
    S.pq[tid] = make_float4(fc(poly[16 * r + 2 * k], 6), fc(poly[16 * r + 2 * k + 1], 6),
                            r ? 0.0f : fc(poly[256 + k], 6), 0.0f);
  }

  // the thread's samples in stages 1-2 and their spectra, loaded a granule ahead
  int ia, ib, bnd;
  samples_of(tid, ia, ib, bnd);
  // the offsets unsigned: a signed one keeps its sign word for the 64-bit address
  const uint32_t ua = static_cast<uint32_t>(ia), ub = static_cast<uint32_t>(ib);
  int hx[2] = {};      // per channel: sample ia in the low half, ib in the high half
  int side_next = 0;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    if (ch >= nch) break;
    const int16_t* h = a.huff + ((size_t)b * nch + ch) * NS;
    hx[ch] = (h[ua] & 0xFFFF) | static_cast<int>(static_cast<uint32_t>(h[ub]) << 16);
  }
  __syncthreads();

  int v = a.vindex;
#pragma unroll 1
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
      int cbl = -1, cbs0 = -1, cbs1 = -1, cbs2 = -1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = e ? ib : ia;
        const int h = e ? hx[ch] >> 16 : static_cast<int16_t>(hx[ch]);   // sign-extended
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
      warp_max(&red[R_CBL + ch], cbl);
      warp_max(&red[R_CBS + 3 * ch], cbs0);
      warp_max(&red[R_CBS + 3 * ch + 1], cbs1);
      warp_max(&red[R_CBS + 3 * ch + 2], cbs2);
    }
    if (g + 1 < G) {               // the next granule's spectra and side row
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        const int16_t* h = a.huff + (((size_t)(g + 1) * B + b) * nch + ch) * NS;
        hx[ch] = (h[ua] & 0xFFFF) | static_cast<int>(static_cast<uint32_t>(h[ub]) << 16);
      }
      if (tid < SW) side_next = a.side[((size_t)(g + 1) * B + b) * SW + tid];
    }
    __syncthreads();   // B1: the dequantized samples and their band ends

    // ---- 2. short-block reorder, joint stereo, butterflies (same samples)
    {
      float x[2][2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int e = 0; e < 2; ++e) x[ch][e] = ch < nch ? S.bufB[ch * NS + src[ch][e]] : 0.0f;
      if (nch == 2 && cb[GB_SCALARS] != 0) stereo_f(S, sd, red, ia, ib, x);
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch >= nch) break;
        if (bnd != 0 && bnd <= blocks_of(sd, nch, ch, a.cutoff).nbfly) {
          const int j = tid % 8;    // anti-alias butterfly (li, ri) = (ia, ib)
          const float a0 = x[ch][0], b0 = x[ch][1];
          const float c0 = fc(tb[TB(CSA) + 2 * j], 1), c1 = fc(tb[TB(CSA) + 2 * j + 1], 1);
          x[ch][0] = mul(c0, a0) - mul(c1, b0);
          x[ch][1] = mul(c0, b0) + mul(c1, a0);
        }
        S.bufA[ch * NS + ia] = x[ch][0];
        S.bufA[ch * NS + ib] = x[ch][1];
      }
    }
    __syncthreads();   // B2: the stereo samples

    // ---- 3. IMDCT with overlap: two threads per (channel, block); the
    // other warps run the previous granule's PQMF meanwhile
    if (tid >= 64 * nch) {
      if (g > 0) {
        int16_t* out = a.pcm + ((size_t)b * G + g - 1) * (NS * nch);
        if (g == 1)
          pqmf_f<true>(S, cur ^ 1, out, nch, (v + 9) & 7, 64 * nch, THREADS - 64 * nch);
        else
          pqmf_f<false>(S, cur ^ 1, out, nch, (v + 9) & 7, 64 * nch, THREADS - 64 * nch);
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
      float* xprev = S.over + ch * 288 + 9 * blk;
      float* xin = S.bufA + ch * NS + 18 * blk;   // the block's input, then its scratch
      float* y = S.bufB + ch * NS + 18 * blk;
      const int* win = tb + TB(IMDCTWIN);
      const int* c9 = tb + TB(C9);
      // A: the carried overlap copied aside (B writes the new one in place);
      // the thread's transform into registers (long: the even (h = 0) or
      // odd (h = 1) 9-point IDCT; short: windows h and 2), then into the
      // block's input, which no one reads any more
      float* xp = S.xpc + ch * 288 + 9 * blk;
      for (int k = h; k < 9; k += 2) xp[k] = xprev[k];
      float t[9];
      float o2[6];
      if (in_long) {
        float acc1 = 0.0f, acc2 = 0.0f;
        float xv[9];
#pragma unroll
        for (int i = 8; i >= 0; --i) {
          acc1 = xin[2 * i + 1] - acc1;
          acc2 = acc1 - acc2;
          acc1 = xin[2 * i] - acc1;
          xv[i] = h ? acc2 : acc1;
        }
        xv[0] = mul(xv[0], 0.5f);
        idct9_f(xv, t, c9);
      } else if (in_short) {
        imdct12_f(xin[h], xin[h + 3], xin[h + 6], xin[h + 9], xin[h + 12], xin[h + 15], c9, t);
        imdct12_f(xin[2], xin[5], xin[8], xin[11], xin[14], xin[17], c9, o2);
      }
      __syncwarp();
      if (in_long) {
#pragma unroll
        for (int k = 0; k < 9; ++k) xin[9 * h + k] = t[k];   // even then odd
      } else if (in_short) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          xin[6 * h + k] = t[k];
          xin[12 + k] = o2[k];
        }
      }
      __syncwarp();
      // B: half the outputs and half the new overlap
      bool any = false;
      if (in_long) {
        const bool fast = prev_win == 0 && curr_win == 0;
        const int* wc = win + 36 * sel4(curr_win);
        const int* fw = tb + TB(FASTWIN36);
#pragma unroll 1
        for (int i = 5 * h; i < 5 + 4 * h; ++i) {
          const float xo_ = mul(fc(tb[TB(C18) + 8 - i], 0), xin[17 - i]);
          const float xe_ = mul(xin[8 - i], 0.25f);
          float lo, hi;
          if (fast) {
            const float s = -xp[i];
            const float d = -(xe_ - xo_);
            const float tt = s - d;
            lo = d + mul(tt, fc(fw[2 * i], 2));
            hi = s + mul(tt, fc(fw[2 * i + 1], 2));
          } else {
            const float d = xe_ - xo_;
            lo = mul(win_prev_f(xp, prev_win, win, i) + mul(d, fc(wc[i], 0)), 4.0f);
            hi = mul(win_prev_f(xp, prev_win, win, 17 - i) + mul(d, fc(wc[17 - i], 0)), 4.0f);
          }
          y[i] = inv(lo, i, blk);
          y[17 - i] = inv(hi, 17 - i, blk);
          xprev[i] = xe_ + xo_;
        }
      } else if (in_short) {
        const int* w2 = win + 2 * 36;
        const float* xb = xin;
#pragma unroll 1
        for (int k = 9 * h; k < 9 + 9 * h; ++k) {
          const int grp = k / 3, i = k % 3;
          float val = mul(win_prev_f(xp, prev_win, win, k), 4.0f);
          if (grp == 2) val = val + mul(fc(w2[i], 0), xb[3 + i]);
          else if (grp == 3) val = val + mul(fc(w2[3 + i], 0), xb[5 - i]);
          else if (grp == 4)
            val = val + (mul(fc(w2[6 + i], 0), xb[2 - i]) + mul(fc(w2[i], 0), xb[9 + i]));
          else if (grp == 5)
            val = val + (mul(fc(w2[9 + i], 0), xb[i]) + mul(fc(w2[3 + i], 0), xb[11 - i]));
          y[k] = inv(val, k, blk);
        }
#pragma unroll 1
        for (int k = 5 * h; k < 5 + 4 * h; ++k) xprev[k] = mul(xb[k < 3 ? 6 + k : 9 + k], 0.25f);
      } else if (in_prev) {     // window previous only (HybridTransform :2482-2512)
#pragma unroll 1
        for (int k = 9 * h; k < 9 + 9 * h; ++k) {
          const float val = mul(win_prev_f(xp, prev_win, win, k), 4.0f);
          any = any || val != 0.0f;
          y[k] = inv(val, k, blk);
        }
        for (int k = 5 * h; k < 5 + 4 * h; ++k) xprev[k] = 0.0f;
      } else {
        for (int k = 9 * h; k < 9 + 9 * h; ++k) y[k] = inv(0.0f, k, blk);
      }
      if (any) atomicMax(&red[R_EXT + ch], blk);
    }
    __syncthreads();   // B3: the IMDCT output and the new overlap

    // ---- 4. FDCT32 per (slot, channel), eight threads each, into both
    // histories; the carried block state; the next granule's side row and
    // reductions
    {
      const int nu = 18 * nch;
      if ((tid & ~31) < 8 * nu) {     // whole warps; a partly used warp runs a clamped unit
        const int l = tid & 7, u0 = tid >> 3, u = min(u0, nu - 1);
        const int s = u % 18, ch = u / 18;
        const bool store = u0 < nu;
        const float* x = S.bufB + ch * NS + s;  // stride 18
        const int* dct = tb + TB(DCTTAB);
        float* p = S.bufA + u * FD_STRIDE;      // the 32 post-pass entries
        {   // first pass: butterfly l
          const float a0 = x[18 * l], a3 = x[18 * (31 - l)];
          const float a1 = x[18 * (15 - l)], a2 = x[18 * (16 + l)];
          const int s1 = (kFpS1 >> (4 * l)) & 15, s2 = (kFpS2 >> (4 * l)) & 15;
          const float b0 = a0 + a3, b3 = mul(fc(dct[3 * l], 1), a0 - a3);
          const float b1 = a1 + a2, b2 = mul(fc(dct[3 * l + 1], s1), a1 - a2);
          if (store) {
            p[l] = b0 + b1;
            p[15 - l] = mul(fc(dct[3 * l + 2], s2), b0 - b1);
            p[16 + l] = b2 + b3;
            p[31 - l] = mul(fc(dct[3 * l + 2], s2), b3 - b2);
          }
        }
        __syncwarp();
        {   // second pass: group l / 2 of 8, elements (0, 7, 3, 4) or (1, 6, 2, 5)
          const int hh = l & 1;
          const float* pg = p + 8 * (l >> 1);
          const int* d = dct + 24 + 6 * (l >> 1) + 3 * hh;
          const float u0v = pg[hh], u1v = pg[7 - hh], u2v = pg[3 - hh], u3v = pg[4 + hh];
          const float x0 = u0v + u1v, x1 = mul(fc(d[0], 1), u0v - u1v);
          const float x2 = u2v + u3v, x3 = mul(fc(d[1], hh ? 1 : 3), u2v - u3v);
          const float cd = fc(d[2], hh ? 2 : 1);
          const float y0 = x0 + x2, y1 = mul(cd, x0 - x2);
          const float y2 = x3 + x1, y3 = mul(cd, x1 - x3);
          // hh = 0 holds (A0, A3, A4, A7), hh = 1 (A1, A2, A5, A6); the
          // last step pairs A0..A3 on hh = 0 and A4..A7 on hh = 1
          const float r0 = __shfl_xor_sync(FULL, hh ? y0 : y2, 1);
          const float r1 = __shfl_xor_sync(FULL, hh ? y1 : y3, 1);
          const float P = hh ? r0 : y0, Q = hh ? y2 : r0, U = hh ? r1 : y1, V = hh ? y3 : r1;
          const float cos4 = fc(0x5A82799A, 1);
          const float e = P + Q, f = mul(cos4, P - Q);
          const float hv = mul(cos4, U - V), gh = (V + U) + hv;
          __syncwarp();
          if (store) {
            float* o = p + 8 * (l >> 1) + 4 * hh;
            o[0] = hh ? e + gh : e;
            o[1] = hh ? f + hv : f;
            o[2] = hh ? f + gh : gh;
            o[3] = hv;
          }
        }
        __syncwarp();
        if (store) {   // the 33 stored values into the history; steps 3..17 also
                       // into the other one as the next granule's carried steps
          float* hrow = S.hist + cur * HBUF + (CARRY + s) * HSTEP + ch;
          float* hnext = S.hist + (cur ^ 1) * HBUF + (s - 3) * HSTEP + ch;
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            const int j = l + 8 * q;
            if (j >= V33) break;
            const uint32_t rc = S.recipes[j];
            const int n = rc >> 15;
            float vv = p[rc & 31];
            if (n > 1) vv = vv + p[(rc >> 5) & 31];
            if (n > 2) vv = vv + p[(rc >> 10) & 31];
            hrow[2 * j] = vv;
            if (s >= 3) hnext[2 * j] = vv;
          }
        }
      }
      if (tid == THREADS - 1) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          if (ch >= nch) break;
          const Blocks nb = blocks_of(sd, nch, ch, a.cutoff);
          S.st[ch] = sd[nch + ch];
          S.st[2 + ch] = nb.cws;
          S.st[4 + ch] = max(max(nb.nbl, nb.nbt), red[R_EXT + ch]);
        }
      }
      if (tid < R_N) S.red[cur ^ 1][tid] = -1;
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
      pqmf_f<true>(S, 0, out, nch, (v + 9) & 7, 0, THREADS);
    else
      pqmf_f<false>(S, gl & 1, out, nch, (v + 9) & 7, 0, THREADS);
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
    const int vl = (v + 9) & 7;
    float* vb = a.vbuf + (size_t)b * 2176;
    for (int k = tid; k < 16 * nch * V33; k += THREADS) {
      const int s = 2 + k / (nch * V33), ch = (k / V33) % nch, j = k % V33;
      const float val = S.hist[((G - 1) & 1) * HBUF + (CARRY + s) * HSTEP + 2 * j + ch];
      const int cell = ring_cell(s, vl, j, ch);
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

// What the two MP3 granule kernels share (csrc/mp3_granules.cu, the exact
// tier, and csrc/mp3_granules_f32.cu, its f32 mirror): the per-format
// constants' layout and the compact parameter blob's offsets, the FIFO's
// stored values and ring map, the per-sample parameter expansion (the
// short-block words), the IMDCT block counts and the samples a thread of
// stages 1-2 owns. Include it after <cuda_runtime.h>.

#pragma once

#include <cstdint>

namespace {

constexpr int NS = 576;          // samples per granule and channel
constexpr int GPC = 235;         // compact parameter blob words
constexpr int SW_MAX = 3 * 2 + GPC;
constexpr int V33 = 33;          // values one FIFO step stores per channel
constexpr int CARRY = 15;        // FIFO steps a granule reads from before it
constexpr int HSTEP = 2 * V33;   // history words per step: value j of channel ch at 2 j + ch
constexpr int HN = CARRY + 18;   // history steps of a granule: the carried ones, then its own

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
#define TB(k) (Off<k>::v - Off<SFB_L>::v)   // offset in the tables kept in shared memory
constexpr int CONSTS_LEN = OFF(N_BLOCKS);

// compact blob offsets (native/src/mp3_frontend.cpp eal_mp3_granule_params_compact)
constexpr int GB_GAIN_L = 0, GB_GAIN_S = 44, GB_PE_L = 122, GB_SHORT_BASE = 124, GB_PE_S = 126,
              GB_CB_START_S = 128, GB_HAS_SHORT = 130, GB_CB_TYPE = 132, GB_SFL1 = 134,
              GB_SFS1 = 157, GB_IL_LONG = 196, GB_IL_SHORT = 219, GB_SCALARS = 232;

// the FIFO values of FDCT32's output shuffle (ops/mp3subband.py _ROWS, _QROWS;
// reference :7856-7979): value j is the sum of up to three post-pass
// entries, packed as idx0 | idx1 << 5 | idx2 << 10 | count << 15
__host__ __device__ constexpr uint32_t rec(int n, int a, int b = 0, int c = 0) {
  return static_cast<uint32_t>(a | b << 5 | c << 10 | n << 15);
}
__constant__ uint32_t kRecipes[V33] = {
    rec(1, 0),
    rec(1, 1), rec(3, 17, 25, 29), rec(2, 9, 13), rec(3, 21, 25, 29), rec(1, 5),
    rec(3, 21, 29, 27), rec(2, 13, 11), rec(3, 19, 29, 27), rec(1, 3), rec(3, 19, 27, 31),
    rec(2, 11, 15), rec(3, 23, 27, 31), rec(1, 7), rec(2, 23, 31), rec(1, 15), rec(1, 31),
    rec(1, 1), rec(3, 17, 30, 25), rec(2, 14, 9), rec(3, 22, 30, 25), rec(1, 6),
    rec(3, 22, 26, 30), rec(2, 10, 14), rec(3, 18, 26, 30), rec(1, 2), rec(3, 18, 28, 26),
    rec(2, 12, 10), rec(3, 20, 28, 26), rec(1, 4), rec(3, 20, 24, 28), rec(2, 8, 12),
    rec(3, 16, 24, 28)};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int fdiv(int a, int b) {      // floor division
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void warp_max(int* dst, int v) {
  const int r = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0 && r >= 0) atomicMax(dst, r);
}

// ------------------------------------------------------------ FIFO map

// Where step s of a granule whose phase is v keeps stored value j (0..32)
// of channel ch in the JAX-layout ring [34 rows, 64 columns]: the index of
// the first of its two cells (the second is 8 further; ops/mp3subband.py
// fifo_cell). Steps before the granule (s < 0) are where the ring holds
// them when the granule starts.
__device__ __forceinline__ int ring_cell(int s, int v, int j, int ch) {
  const int odd = s & 1;
  const int vs = (v - (s >> 1)) & 7;           // the phase at step s
  const int c0 = (vs - odd) & 7;
  int row, col;
  if (j == 0) {
    row = 17 * (1 - odd) + 16;
    col = c0;
  } else if (j <= 16) {
    row = 17 * odd + j - 1;
    col = vs;
  } else {
    row = 17 * (1 - odd) + j - 17;
    col = c0 + 16;
  }
  return row * 64 + col + 32 * ch;
}
// ------------------------------------------------------------ dequantizer

// The per-sample parameters of expand_hp_device for one channel: what the
// granule's blob says once per channel, then per sample a band-map word and
// a short-block word from tables built when the block starts.
struct Chan {
  int pe_l, sbase, pe_s, tab;   // tab: 0 or NS, the short table of base sfb_s[0] or sfb_s[3]
  bool has_short;
};
__device__ __forceinline__ Chan chan_of(const int* cb, int ch) {
  Chan c;
  c.pe_l = cb[GB_PE_L + ch];
  c.sbase = cb[GB_SHORT_BASE + ch];
  c.pe_s = cb[GB_PE_S + ch];
  c.has_short = cb[GB_HAS_SHORT + ch] != 0;
  c.tab = cb[GB_CB_START_S + ch] == 3 ? NS : 0;
  return c;
}

// short-block word of an offset so (0..575) past the short base: the band
// (4 bits), the window min(q / n_sel, 3) (2 bits) and the reorder offset
// s_sel + n_sel (q % 3) + q / 3 (from bit 8), q = so - s_sel
__device__ __forceinline__ uint32_t short_word(const int* sfb_s, int base_s, int so) {
  int sband = 0;
  for (int b = 0; b < 13; ++b)
    if (so >= 3 * (sfb_s[b] - base_s)) sband = b;
  const int s_sel = 3 * (sfb_s[sband] - base_s);
  const int n_sel = sfb_s[sband + 1] - sfb_s[sband];
  const int q = so - s_sel;                       // >= 0
  const int swin = min(q / n_sel, 3);
  const int sinv = s_sel + n_sel * (q % 3) + q / 3;
  return static_cast<uint32_t>(sband | swin << 4) | static_cast<uint32_t>(sinv) << 8;
}

// The IMDCT block counts of channel ch (reference IMDCT :2584-2603) and its
// nonzero bound, before (nzb_in) and after joint stereo: the side row alone
// decides them.
struct Blocks {
  int nzb_in, nzb, nbl, nbfly, nbt, cws;
};
__device__ __forceinline__ int nzb_of(const int* sd, int nch, int ch) {
  const int* cb = sd + 3 * nch;
  return cb[GB_HAS_SHORT + ch] != 0 ? cb[GB_PE_S + ch] : sd[ch];
}
__device__ __forceinline__ Blocks blocks_of(const int* sd, int nch, int ch, int cutoff) {
  Blocks k;
  k.nzb_in = nzb_of(sd, nch, ch);
  k.nzb = nch == 2 && sd[3 * nch + GB_SCALARS] != 0
              ? max(nzb_of(sd, nch, 0), nzb_of(sd, nch, 1)) : k.nzb_in;
  const int bt = sd[nch + ch], mixed = sd[2 * nch + ch];
  const int n_long_all = min((k.nzb + 7) / 18 + 1, 32);
  k.nbl = bt != 2 ? n_long_all : (mixed == 1 ? cutoff : 0);
  k.nbfly = bt != 2 ? k.nbl - 1 : (mixed == 1 ? cutoff - 1 : 0);
  k.nbt = (max(k.nzb, k.nbfly * 18 + 8) + 17) / 18;
  k.cws = mixed == 1 ? cutoff : 0;
  return k;
}
__device__ __forceinline__ int byte_of(int w, int k) {   // signed byte k of a packed word
  return static_cast<int>(static_cast<int8_t>(static_cast<uint32_t>(w) >> (8 * k)));
}

// the two samples of thread t in stages 1-2: a butterfly pair (li, ri) of
// boundary bnd (t < 248), else two samples no butterfly touches (bnd = 0)
__device__ __forceinline__ void samples_of(int t, int& ia, int& ib, int& bnd) {
  if (t < 248) {
    bnd = t / 8 + 1;
    const int j = t % 8;
    ia = 18 * bnd - 1 - j;
    ib = 18 * bnd + j;
    return;
  }
  bnd = 0;
  const int q = t - 248;   // 0..39
  if (q < 32) {
    ia = 18 * q + 8;       // offsets 8 and 9 of every block
  } else if (q < 36) {
    ia = 2 * (q - 32);     // offsets 0..7 of block 0
  } else {
    ia = 568 + 2 * (q - 36);   // offsets 10..17 of block 31
  }
  ib = ia + 1;
}

__device__ __forceinline__ int pick3(int w, int a0, int a1, int a2) {
  return w == 0 ? a0 : (w == 1 ? a1 : a2);
}

}  // namespace

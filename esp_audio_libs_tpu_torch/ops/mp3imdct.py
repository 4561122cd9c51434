"""MP3 hybrid-filterbank synthesis (anti-alias + IMDCT + overlap-add), plain
PyTorch.

The counterpart of esp_audio_libs_tpu/ops/mp3imdct.py (reference:
src/decode/mp3_decoder.cpp :1783-1881 AntiAlias, :1883-1935 WinPrevious,
:1937-2044 FreqInvertRescale, :2051-2172 idct9, :2174-2283 IMDCT36,
:2285-2448 imdct12/IMDCT12x3, :2450-2532 HybridTransform, :2552-2617 IMDCT).

Every (lane, block) pair is computed at once: both transforms run as
straight-line tensor math and the per-block type, window and rescale
decisions become selects. All arithmetic is int32 with wraparound and
MULSHIFT32; the integers are the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from .mp3dsp import _clz32, mulshift32, or_reduce, tables

__all__ = ["imdct_granule"]

NBANDS = 32
_C6 = (0x7BA3751D, 0x5A82799A, 0x2120FB83)   # cos(((0:2) + 0.5) pi / 6), Q31 (reference)


def _antialias(x, nbfly, T):
    """Reference AntiAlias (:1783-1865): csa butterflies across the 31 block
    boundaries, applied where the boundary index <= nBfly."""
    dev = x.device
    b_ids = torch.arange(1, NBANDS, device=dev)
    j_ids = torch.arange(8, device=dev)
    li = (18 * b_ids[:, None] - 1 - j_ids[None, :]).reshape(-1)
    ri = (18 * b_ids[:, None] + j_ids[None, :]).reshape(-1)
    a0, b0 = x[:, li], x[:, ri]
    c0 = T["csa"][:, 0].repeat(NBANDS - 1)[None, :]
    c1 = T["csa"][:, 1].repeat(NBANDS - 1)[None, :]
    new_a = (mulshift32(c0, a0) - mulshift32(c1, b0)) << 1
    new_b = (mulshift32(c0, b0) + mulshift32(c1, a0)) << 1
    active = b_ids.repeat_interleave(8)[None, :] <= nbfly[:, None]
    out = x.clone()
    out[:, li] = torch.where(active, new_a, a0)
    out[:, ri] = torch.where(active, new_b, b0)
    return out


def _idct9(x, T):
    """Reference idct9 (:2051-2131). x: list of 9 tensors; returns 9."""
    c9_0, c9_1, c9_2, c9_3, c9_4 = (T[f"c9_{i}"] for i in range(5))
    x0, x1, x2, x3, x4, x5, x6, x7, x8 = x

    a1 = x0 - x6
    a2 = x1 - x5
    a3 = x1 + x5
    a4 = x2 - x4
    a5 = x2 + x4
    a6 = x2 + x8
    a7 = x1 + x7

    a8 = a6 - a5
    a9 = a3 - a7
    a10 = a2 - x7
    a11 = a4 - x8

    m1 = mulshift32(c9_0, x3)
    m3 = mulshift32(c9_0, a10)
    m5 = mulshift32(c9_1, a5)
    m6 = mulshift32(c9_2, a6)
    m7 = mulshift32(c9_1, a8)
    m8 = mulshift32(c9_2, a5)
    m9 = mulshift32(c9_3, a9)
    m10 = mulshift32(c9_4, a7)
    m11 = mulshift32(c9_3, a3)
    m12 = mulshift32(c9_4, a9)

    a12 = x0 + (x6 >> 1)
    a13 = a12 + (m1 << 1)
    a14 = a12 - (m1 << 1)
    a15 = a1 + (a11 >> 1)
    a16 = (m5 << 1) + (m6 << 1)
    a17 = (m7 << 1) - (m8 << 1)
    a18 = a16 + a17
    a19 = (m9 << 1) + (m10 << 1)
    a20 = (m11 << 1) - (m12 << 1)

    a21 = a20 - a19
    a22 = a13 + a16
    a23 = a14 + a16
    a24 = a14 + a17
    a25 = a13 + a17
    a26 = a14 - a18
    a27 = a13 - a18

    return [a22 + a19, a15 + (m3 << 1), a24 + a20, a26 - a21, a1 - a11, a27 + a21,
            a25 - a20, a15 - (m3 << 1), a23 - a19]


def _win_previous(xprev, bt_prev, T):
    """Reference WinPrevious (:1883-1935). xprev: [..., 9] -> [..., 18]; the
    short layout where bt_prev == 2, the long one elsewhere."""
    win = T["imdctWin"]                                   # [4, 36]
    bt = bt_prev.clamp(0, 3).to(torch.int64)
    wlo = win[:, 18:27][bt]                               # [..., 9]
    whi = win[:, 27:36].flip(-1)[bt]                      # imdctWin[bt][35..27]
    x = xprev
    lo = mulshift32(wlo, x)                               # xPrevWin[0..8]
    hi = mulshift32(whi, x)                               # xPrevWin[17..9]
    long_out = torch.cat([lo, hi.flip(-1)], dim=-1)

    w2 = win[2]
    s = [mulshift32(w2[6], x[..., 2]) + mulshift32(w2[0], x[..., 6]),
         mulshift32(w2[7], x[..., 1]) + mulshift32(w2[1], x[..., 7]),
         mulshift32(w2[8], x[..., 0]) + mulshift32(w2[2], x[..., 8]),
         mulshift32(w2[9], x[..., 0]) + mulshift32(w2[3], x[..., 8]),
         mulshift32(w2[10], x[..., 1]) + mulshift32(w2[4], x[..., 7]),
         mulshift32(w2[11], x[..., 2]) + mulshift32(w2[5], x[..., 6]),
         mulshift32(w2[6], x[..., 5]), mulshift32(w2[7], x[..., 4]),
         mulshift32(w2[8], x[..., 3]), mulshift32(w2[9], x[..., 3]),
         mulshift32(w2[10], x[..., 4]), mulshift32(w2[11], x[..., 5])]
    short_out = torch.stack(s + [torch.zeros_like(s[0])] * 6, dim=-1)
    return torch.where((bt_prev == 2)[..., None], short_out, long_out)


def _clip2n(y, n):
    """Reference CLIP_2N: clip to [-2^n, 2^n - 1], n per element in [0, 31]."""
    sign = y >> 31
    lim = (torch.ones_like(n) << n) - 1
    return torch.where(sign != (y >> n), sign ^ lim, y)


def _freq_invert_rescale(y, new_prev, blk, es):
    """Reference FreqInvertRescale (:1937-2044) on (y [..., 18], new_prev
    [..., 9]): odd samples of odd blocks negated; with es > 0 both clipped
    to 2^(31 - es) and shifted left by es. Returns (y, new_prev, the OR of
    |y| where es > 0, else 0)."""
    odd = ((blk & 1) == 1)[..., None] & ((torch.arange(18, device=y.device) & 1) == 1)
    y = torch.where(odd, -y, y)
    es_b = es[..., None]
    has_es = es_b > 0
    yv = _clip2n(y, 31 - es_b) << es_b
    xpv = _clip2n(new_prev, 31 - es_b) << es_b
    mout = torch.where(es > 0, or_reduce(yv.abs()), torch.zeros_like(es))
    return torch.where(has_es, yv, y), torch.where(has_es, xpv, new_prev), mout


def _imdct36(xcur, xprev, bt_curr, bt_prev, blk, gb, T):
    """Reference IMDCT36 (:2174-2283) over [..., 18] blocks.

    Returns (y [..., 18], new_xprev [..., 9], mout [...]).
    """
    es = (7 - gb).clamp(min=0)
    xs = xcur >> es[..., None]
    xprev = xprev >> es[..., None]

    # accumulation loop (suffix alternating sums), i = 8..0
    xbuf_e, xbuf_o = [None] * 9, [None] * 9
    acc1 = torch.zeros_like(xs[..., 0])
    acc2 = torch.zeros_like(acc1)
    for i in range(8, -1, -1):
        acc1 = xs[..., 2 * i + 1] - acc1
        acc2 = acc1 - acc2
        acc1 = xs[..., 2 * i] - acc1
        xbuf_o[i] = acc2
        xbuf_e[i] = acc1
    xbuf_o[0] = xbuf_o[0] >> 1
    xbuf_e[0] = xbuf_e[0] >> 1

    even = _idct9(xbuf_e, T)
    odd = _idct9(xbuf_o, T)

    c18 = T["c18"]
    fast = (bt_prev == 0) & (bt_curr == 0)
    fast_win = T["fastWin36"]
    win_prev = _win_previous(xprev, bt_prev, T)
    win = T["imdctWin"]
    btc = bt_curr.clamp(0, 3).to(torch.int64)

    y = [None] * 18
    new_prev = [None] * 9
    mout = torch.zeros_like(acc1)
    for i in range(9):
        xo = mulshift32(c18[8 - i], odd[8 - i])
        xe = even[8 - i] >> 2

        # fast path (:2222-2249)
        s_f = -xprev[..., i]
        d_f = -(xe - xo)
        t = s_f - d_f
        ylo_f = d_f + (mulshift32(t, fast_win[2 * i]) << 2)
        yhi_f = s_f + (mulshift32(t, fast_win[2 * i + 1]) << 2)

        # slow path (:2252-2275)
        d_s = xe - xo
        ylo_s = (win_prev[..., i] + mulshift32(d_s, win[btc, i])) << 2
        yhi_s = (win_prev[..., 17 - i] + mulshift32(d_s, win[btc, 17 - i])) << 2

        y[i] = torch.where(fast, ylo_f, ylo_s)
        y[17 - i] = torch.where(fast, yhi_f, yhi_s)
        new_prev[i] = xe + xo
        mout = mout | y[i].abs() | y[17 - i].abs()

    y, new_prev, mout_es = _freq_invert_rescale(torch.stack(y, -1), torch.stack(new_prev, -1),
                                                blk, es)
    return y, new_prev, mout | mout_es


def _imdct12(x, T):
    """Reference imdct12 (:2291-2340): 6 strided inputs -> 6 outputs."""
    c3_0 = T["c9_0"]   # the same constant 0x6ed9eba1
    x0, x1, x2, x3, x4, x5 = x

    x4 = x4 - x5
    x3 = x3 - x4
    x2 = x2 - x3
    x3 = x3 - x5
    x1 = x1 - x2
    x0 = x0 - x1
    x1 = x1 - x3

    x0 = x0 >> 1
    x1 = x1 >> 1

    a0 = mulshift32(c3_0, x2) << 1
    a1 = x0 + (x4 >> 1)
    a2 = x0 - x4
    o0, o2, o4 = a1 + a0, a2, a1 - a0

    a0 = mulshift32(c3_0, x3) << 1
    a1 = x1 + (x5 >> 1)
    a2 = x1 - x5

    c6 = [torch.tensor(c, dtype=torch.int32, device=x0.device) for c in _C6]
    o1 = mulshift32(c6[0], a1 + a0) << 2
    o3 = mulshift32(c6[1], a2) << 2
    o5 = mulshift32(c6[2], a1 - a0) << 2
    return [o0 + o1, o2 + o3, o4 + o5, o4 - o5, o2 - o3, o0 - o1]


def _imdct12x3(xcur, xprev, bt_prev, blk, gb, T):
    """Reference IMDCT12x3 (:2364-2448). Same signature as _imdct36."""
    es = (7 - gb).clamp(min=0)
    xs = xcur >> es[..., None]
    xprev_s = xprev >> es[..., None]

    xbuf = [None] * 18
    for w in range(3):
        outs = _imdct12([xs[..., w + 3 * k] for k in range(6)], T)
        for k in range(6):
            xbuf[6 * w + k] = outs[k]

    wp = _win_previous(xprev_s, bt_prev, T)
    w2 = T["imdctWin"][2]

    y = [None] * 18
    mout = torch.zeros_like(xs[..., 0])
    for i in range(3):
        y[0 + i] = wp[..., 0 + i] << 2
        y[3 + i] = wp[..., 3 + i] << 2
        y[6 + i] = (wp[..., 6 + i] << 2) + mulshift32(w2[0 + i], xbuf[3 + i])
        y[9 + i] = (wp[..., 9 + i] << 2) + mulshift32(w2[3 + i], xbuf[5 - i])
        y[12 + i] = (wp[..., 12 + i] << 2) + (mulshift32(w2[6 + i], xbuf[2 - i])
                                              + mulshift32(w2[0 + i], xbuf[9 + i]))
        y[15 + i] = (wp[..., 15 + i] << 2) + (mulshift32(w2[9 + i], xbuf[0 + i])
                                              + mulshift32(w2[3 + i], xbuf[11 - i]))
        for k in (0, 3, 6, 9, 12, 15):
            mout = mout | y[k + i].abs()

    new_prev = torch.stack([xbuf[i] >> 2 for i in (6, 7, 8, 12, 13, 14, 15, 16, 17)], -1)
    y, new_prev, mout_es = _freq_invert_rescale(torch.stack(y, -1), new_prev, blk, es)
    return y, new_prev, mout | mout_es


def imdct_granule(x, xprev, nzb, gb, block_type, mixed, prev_type, prev_win_switch,
                  block_cutoff, n_prev):
    """Hybrid synthesis for one granule and one channel, over lanes.

    Args:
      x: int32 ``[L, 576]`` dequantized samples.
      xprev: int32 ``[L, 32, 9]`` carried overlap state (reference overBuf).
      nzb, gb, block_type, mixed: int32 ``[L]``.
      prev_type, prev_win_switch, n_prev: int32 ``[L]`` carried state
        (reference prevType / prevWinSwitch / numPrevIMDCT).
      block_cutoff: int32 ``[L]`` sfBand->l[8 or 6] / 18.

    Returns (out [L, 18, 32], new_xprev, new_nzb, gb_out, n_blocks_out,
    curr_win_switch).
    """
    T = tables(x.device)
    i32 = torch.int32
    x, xprev = x.to(i32), xprev.to(i32)
    nzb, gb, block_type, mixed, prev_type, prev_win_switch, block_cutoff, n_prev = (
        v.to(i32) for v in (nzb, gb, block_type, mixed, prev_type, prev_win_switch,
                            block_cutoff, n_prev))
    L = x.shape[0]

    # block counts (reference IMDCT :2584-2603)
    is_short = block_type == 2
    n_long_all = torch.clamp(torch.div(nzb + 7, 18, rounding_mode="floor") + 1, max=32)
    zero = torch.zeros_like(nzb)
    n_blocks_long = torch.where(~is_short, n_long_all,
                                torch.where(mixed == 1, block_cutoff, zero))
    nbfly = torch.where(~is_short, n_blocks_long - 1,
                        torch.where(mixed == 1, block_cutoff - 1, zero))

    x = _antialias(x, nbfly, T)
    nzb = torch.maximum(nzb, nbfly * 18 + 8)
    n_blocks_total = torch.div(nzb + 17, 18, rounding_mode="floor")

    curr_win_switch = torch.where(mixed == 1, block_cutoff, zero)

    blk = torch.arange(NBANDS, dtype=i32, device=x.device)[None, :].expand(L, NBANDS)
    xb = x.reshape(L, NBANDS, 18)

    curr_win = torch.where((mixed[:, None] == 1) & (blk < curr_win_switch[:, None]),
                           torch.zeros_like(blk), block_type[:, None].expand(L, NBANDS))
    prev_win = torch.where(blk < prev_win_switch[:, None], torch.zeros_like(blk),
                           prev_type[:, None].expand(L, NBANDS))
    gb_b = gb[:, None].expand(L, NBANDS)

    y36, prev36, mout36 = _imdct36(xb, xprev, curr_win, prev_win, blk, gb_b, T)
    y12, prev12, mout12 = _imdct12x3(xb, xprev, prev_win, blk, gb_b, T)

    # "window previous only" (HybridTransform :2482-2512): unshifted xprev,
    # y = xPrevWin << 2 with frequency inversion, xprev zeroed
    ypo = _win_previous(xprev, prev_win, T) << 2
    odd_samp = (torch.arange(18, device=x.device) & 1) == 1
    ypo = torch.where(((blk & 1) == 1)[..., None] & odd_samp, -ypo, ypo)
    mout_po = or_reduce(ypo.abs())
    po_nonzero = or_reduce(ypo) != 0

    # branch per (lane, block)
    m_lim = torch.maximum(n_blocks_long, n_blocks_total)[:, None]
    in_long = blk < n_blocks_long[:, None]
    in_short = ~in_long & (blk < n_blocks_total[:, None])
    in_prev = ~in_long & ~in_short & (blk >= m_lim) & (blk < n_prev[:, None])

    y = torch.where(in_long[..., None], y36,
                    torch.where(in_short[..., None], y12,
                                torch.where(in_prev[..., None], ypo, torch.zeros_like(y36))))
    new_prev = torch.where(in_long[..., None], prev36,
                           torch.where(in_short[..., None], prev12,
                                       torch.where(in_prev[..., None],
                                                   torch.zeros_like(prev36), xprev)))
    zb = torch.zeros_like(mout36)
    mout_blk = torch.where(in_long, mout36,
                           torch.where(in_short, mout12, torch.where(in_prev, mout_po, zb)))
    gb_out = _clz32(or_reduce(mout_blk)) - 1

    # numPrevIMDCT: M, possibly set to the INDEX of the last nonzero
    # prev-only block (reference :2500-2511 sets nBlocksOut = i, not i+1)
    ext = torch.where(in_prev & po_nonzero, blk, torch.full_like(blk, -1))
    n_blocks_out = torch.maximum(m_lim[:, 0], ext.max(dim=-1).values)

    return y.transpose(1, 2), new_prev, nzb, gb_out, n_blocks_out, curr_win_switch

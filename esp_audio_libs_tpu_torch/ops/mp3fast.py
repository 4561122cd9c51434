"""The relaxed-precision MP3 granule pipeline (the ``fast="mirror"`` tier):
the exact tier's arithmetic mirrored in f32, plain PyTorch.

The counterpart of esp_audio_libs_tpu/ops/mp3fast.py (reference: the Helix
granule pipeline, mp3_decoder.cpp:550-795 dequant, :1783-2617 hybrid IMDCT,
:798-1120,7707-8019 subband synthesis; the exact modules ops/mp3dsp.py,
ops/mp3imdct.py and ops/mp3subband.py carry the per-line citations). Every
fixed-point operation of the exact tier becomes its real-valued meaning:

- ``MULSHIFT32(c, x) << s`` -> ``x * f32(c * 2**(s - 32))`` (constant folded);
- the guard-bit shifts (``es``), CLIP_2N and the mOut/clz bookkeeping go
  (f32 has the headroom);
- the dequantizer's tables and polynomial -> one closed form
  ``x^(4/3) * 2^(25 - scalei - scale_low/4)`` through exp2/log2, with the
  exact tier's clamps of the scale and its saturation at 2147483647,

so each f32 tensor holds about the same value as the exact tier's int32
tensor, and the PCM takes the same rounding (``+2^25 >> 26`` ==
``floor(x + 0.5)`` in PCM units) and int16 clip. Within 1 LSB of the exact
tier on decodable streams, and at most 4 LSB on under 0.5 % of samples on
content that clips hard (the exact tier truncates guard bits there).

The JAX module's select trees (``const_lookup_f``, ``_sel3``, ``_sel4``)
and roll-based short-block reorder (``_section_perm``) stand in for
gathers that were slow on the TPU; here they are gathers of the same f32
constants and the same permutation (``hp["invperm"]``, as ops/mp3dsp.py
reorders). The FIFO keeps the exact tier's layout and phase protocol
(ops/mp3subband.py), so a carried state crosses between the tiers and
packages by a dtype cast.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime.tables import mp3_tables
from .mp3subband import _QROWS, _ROWS, _poly_coefs_np

__all__ = ["dequantize_granule_fast", "imdct_granule_fast", "subband_granule_fast"]

MAX_NSAMP = 576
NBANDS = 32
F32 = torch.float32


def _c(v, s=0) -> float:
    """A Q31/Q32 integer constant as the folded f32 coefficient
    ``v * 2**(s - 32)`` (a Python float holding an f32 value)."""
    return float(np.float32(float(int(v)) * 2.0 ** (s - 32)))


@functools.lru_cache(None)
def _consts_np() -> dict:
    """The f32 constant tables of the mirror, numpy."""
    T = mp3_tables()
    win = np.asarray(T["imdctWin"], np.float64)
    C1, C2 = _poly_coefs_np()
    f = lambda a: np.asarray(a, np.float64).astype(np.float32)   # noqa: E731
    return {
        "csa0": f(np.tile(T["csa"][:, 0] / 2.0 ** 31, NBANDS - 1)),
        "csa1": f(np.tile(T["csa"][:, 1] / 2.0 ** 31, NBANDS - 1)),
        "win": f(win / 2.0 ** 32),                                  # [4, 36]
        "isf1": f(np.asarray(T["ISFMpeg1"], np.float64) / 2.0 ** 30),   # [2, 7]
        "isf2": f(np.asarray(T["ISFMpeg2"], np.float64).reshape(4, 16) / 2.0 ** 30),
        "iip": f(np.asarray(T["ISFIIP"], np.float64) / 2.0 ** 30),      # [2, 2]
        # acc int64 + (1 << 25) >> 26 -> PCM units: 2^-26 folded into the taps
        "C1": f(C1.astype(np.float64) / 2.0 ** 26),                     # [17, 8]
        "C2": f(C2.astype(np.float64) / 2.0 ** 26),
    }


@functools.lru_cache(None)
def _consts(device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in _consts_np().items()}


def _sel4_index(bt):
    """The JAX module's four-way select index: 0, 1, 2, else 3."""
    return torch.where((bt >= 0) & (bt <= 2), bt, torch.full_like(bt, 3)).to(torch.int64)


# --------------------------------------------------------------------------
# dequant + stereo (value mirror of ops/mp3dsp.dequantize_granule)
# --------------------------------------------------------------------------

def _dequant_math_f32(sx, scale):
    """DequantBlock's value: ``x^(4/3) * 2^(25 - scalei - scale_low/4)``.

    Mirrors the exact path's clamps where they differ from the closed form:
    scalei = min(scale >> 2, 31); the x < 4 branch shifts by clip(scalei +
    3, 0, 31), the 4 <= x < 16 branch by clip(scalei, -31, 31), and the loud
    left-shift paths saturate at INT32_MAX. Returns (signed value f32,
    magnitude f32).
    """
    xm = sx & 0x7FFFFFFF
    x = xm.to(F32)
    sl = (scale & 0x3).to(F32)
    si = torch.clamp(scale >> 2, max=31)
    si_eff = torch.where(xm < 4, (si + 3).clamp(0, 31) - 3,
                         torch.where(xm < 16, si.clamp(-31, 31), si))
    e = (25.0 - si_eff.to(F32)) - 0.25 * sl
    lx = torch.log2(torch.clamp(x, min=1.0))
    y = torch.exp2(lx * float(np.float32(4.0 / 3.0)) + e)
    y = torch.clamp(y, max=2147483647.0)
    y = torch.where(x == 0, torch.zeros_like(y), y)
    return torch.where(sx < 0, -y, y), y


def _take(tab, idx):
    """``tab[..., idx]`` along the last axis with a per-row index."""
    return torch.gather(tab, -1, idx.to(torch.int64))


def dequantize_granule_fast(huff, nzb, hp, *, nch: int):
    """f32 dequantization + joint stereo for a batch of granules: the
    ``(huff, nzb, hp)`` contract of ``ops.mp3dsp.dequantize_granule``, but
    ``x`` is f32 and there are no guard bits. The critical-band bookkeeping
    keeps the exact path's integer decisions: a sample counts as nonzero iff
    its exact value would truncate to a nonzero integer (magnitude >= 1).

    Returns dict with ``x`` f32 ``[L, C, 576]`` and ``nzb`` ``[L, C]``.
    """
    K = _consts(huff.device)
    huff = huff.to(torch.int32)
    nzb = nzb.to(torch.int32)

    dq, mag = _dequant_math_f32(huff, hp["gain"])
    processed = hp["processed"]
    dq = torch.where(processed, dq, huff.to(F32))
    mag = torch.where(processed, mag, torch.zeros_like(mag))

    # critical-band bookkeeping on the exact path's truncation predicate
    # (mag is zero where unprocessed)
    nonzero = mag >= 1.0
    band, win, is_long = hp["band_in"], hp["win_in"], hp["is_long_in"]

    def band_max(mask, init):
        b = torch.where(mask, band, torch.full_like(band, -1))
        return torch.maximum(b.max(dim=-1).values, init)

    cb_end_l = band_max(nonzero & is_long, torch.zeros_like(nzb))
    cb_start_s = hp["cb_start_s"].to(torch.int32)
    cb_end_s = torch.stack([band_max(nonzero & ~is_long & (win == w), cb_start_s)
                            for w in range(3)], dim=-1)
    has_short = hp["has_short"]
    cb_end_s = torch.where(has_short[..., None], cb_end_s, torch.zeros_like(cb_end_s))
    cb_end_smax = cb_end_s.max(dim=-1).values
    cb_type = hp["cb_type"]

    # short-block reorder: the permutation of the JAX module's rolls and
    # _section_perm, as a gather
    sb = hp["short_base"]
    idx = torch.arange(MAX_NSAMP, device=huff.device, dtype=torch.int32)
    short_mask = (idx >= sb[..., None]) & (idx < hp["out_nzb_short"][..., None]) \
        & has_short[..., None]
    x = torch.where(short_mask, _take(dq, hp["invperm"]), dq)
    new_nzb = torch.where(has_short, hp["out_nzb_short"].to(torch.int32), nzb)
    if nch == 1:
        return dict(x=x, nzb=new_nzb)

    # ---- joint stereo (value mirror; no guard-bit clip pass) ----
    mode_ext = hp["mode_ext"].to(torch.int32)
    midside_flag = mode_ext >> 1
    intensity_flag = mode_ext & 1
    sfb_l, sfb_s = hp["sfb_l"], hp["sfb_s"]

    cbi1_type = cb_type[:, 1]
    ms_n_long = _take(sfb_l, (cb_end_l[:, 1] + 1).clamp(0, 22)[:, None])[:, 0]
    i0_1 = 3 * _take(sfb_s, (cb_end_smax[:, 1] + 1).clamp(0, 13)[:, None])   # [L, 1]
    ms_n_int = torch.where(cbi1_type == 0, ms_n_long, i0_1[:, 0])
    ms_n_free = torch.maximum(new_nzb[:, 0], new_nzb[:, 1])
    ms_nsamps = torch.where(intensity_flag == 1, ms_n_int, ms_n_free)

    ms_active = (midside_flag == 1)[:, None] & (idx < ms_nsamps[:, None])
    xl, xr = x[:, 0], x[:, 1]
    x0 = torch.where(ms_active, xl + xr, xl)
    x1 = torch.where(ms_active, xl - xr, xr)

    ob_l, ob_s, ow = hp["band_out_l"], hp["band_out_s"], hp["win_out"]
    nsamps_in = new_nzb[:, 0]
    use_long = (cbi1_type == 0)[:, None]

    long_lo = (cb_end_l[:, 1] + 1)[:, None]
    long_hi = (cb_end_l[:, 0] + 1)[:, None]
    in_long = (ob_l >= long_lo) & (ob_l < long_hi) & (ob_l >= 0) & (idx < nsamps_in[:, None])

    s_lo_1 = (cb_end_smax[:, 1] + 1)[:, None]
    s_hi_1 = (cb_end_smax[:, 0] + 1)[:, None]
    trip_lim = i0_1 + 3 * torch.div(nsamps_in[:, None] - i0_1, 3, rounding_mode="floor")
    in_short_1 = (ob_s >= s_lo_1) & (ob_s < s_hi_1) & (ob_s >= 0) \
        & (idx < trip_lim) & (idx >= i0_1)
    # _sel3: the window's bounds, ow 0, 1, else 2
    ow_sel = torch.where((ow == 0) | (ow == 1), ow, torch.full_like(ow, 2)).to(torch.int64)
    lo_w = torch.gather(cb_end_s[:, 1, :] + 1, -1, ow_sel)
    hi_w = torch.gather(cb_end_s[:, 0, :] + 1, -1, ow_sel)
    in_short_2 = (ob_s >= lo_w) & (ob_s < hi_w) & (ob_s >= 0)
    ver_is_m1 = hp["ver_is_mpeg1"].to(torch.bool)[:, None]
    in_short = torch.where(ver_is_m1, in_short_1, in_short_2)
    int_active = (intensity_flag == 1)[:, None] & torch.where(use_long, in_long, in_short)

    # intensity factors: the exact path's MULSHIFT32(f, x) << 2 == x * f / 2^30
    sf_r = torch.where(use_long, hp["sf_right_l"], hp["sf_right_s"])
    il = torch.where(use_long, hp["il_out_l"], hp["il_out_s"])
    ms1 = (midside_flag.clamp(0, 1) == 1).to(torch.int64)[:, None]          # [L, 1]
    iip0, iip1 = K["iip"][ms1, 0], K["iip"][ms1, 1]
    fl_m1 = K["isf1"][ms1, sf_r.clamp(0, 6).to(torch.int64)]
    fr_m1 = K["isf1"][ms1, 6] - fl_m1
    is_iip_m1 = sf_r == 7
    fl_1 = torch.where(is_iip_m1, iip0, fl_m1)
    fr_1 = torch.where(is_iip_m1, iip1, fr_m1)

    m2_row = ((hp["intensity_scale"].to(torch.int64).clamp(0, 1) << 1) | ms1[:, 0])[:, None]
    half = ((sf_r + 1) >> 1).clamp(0, 15).to(torch.int64)
    odd = (sf_r & 1) == 1
    fl_m2 = K["isf2"][m2_row, torch.where(odd, half, torch.zeros_like(half))]
    fr_m2 = K["isf2"][m2_row, torch.where(odd, torch.zeros_like(half), half)]
    is_iip_m2 = sf_r == il
    fl_2 = torch.where(is_iip_m2, iip0, fl_m2)
    fr_2 = torch.where(is_iip_m2, iip1, fr_m2)

    fl = torch.where(ver_is_m1, fl_1, fl_2)
    fr = torch.where(ver_is_m1, fr_1, fr_2)
    x1 = torch.where(int_active, fr * x0, x1)
    x0 = torch.where(int_active, fl * x0, x0)

    nz = torch.maximum(new_nzb[:, 0], new_nzb[:, 1])
    any_stereo = mode_ext != 0
    nzb0 = torch.where(any_stereo, nz, new_nzb[:, 0])
    nzb1 = torch.where(any_stereo, nz, new_nzb[:, 1])
    return dict(x=torch.stack([x0, x1], dim=1), nzb=torch.stack([nzb0, nzb1], dim=-1))


# --------------------------------------------------------------------------
# hybrid IMDCT (value mirror of ops/mp3imdct.imdct_granule)
# --------------------------------------------------------------------------

def _antialias_f(x, nbfly):
    """The csa butterflies across the 31 block boundaries where the boundary
    index <= nbfly (MULSHIFT32(c, v) << 1 == v * c / 2^31)."""
    K = _consts(x.device)
    dev = x.device
    b_ids = torch.arange(1, NBANDS, device=dev)
    j_ids = torch.arange(8, device=dev)
    li = (18 * b_ids[:, None] - 1 - j_ids[None, :]).reshape(-1)
    ri = (18 * b_ids[:, None] + j_ids[None, :]).reshape(-1)
    a0, b0 = x[:, li], x[:, ri]
    c0, c1 = K["csa0"][None, :], K["csa1"][None, :]
    new_a = c0 * a0 - c1 * b0
    new_b = c0 * b0 + c1 * a0
    active = b_ids.repeat_interleave(8)[None, :] <= nbfly[:, None]
    out = x.clone()
    out[:, li] = torch.where(active, new_a, a0)
    out[:, ri] = torch.where(active, new_b, b0)
    return out


def _idct9_f(x):
    T = mp3_tables()
    c9_0, c9_1, c9_2, c9_3, c9_4 = (_c(T[f"c9_{k}"], 1) for k in range(5))
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
    # every (m << 1) folds its shift into the constant
    m1 = c9_0 * x3
    m3 = c9_0 * a10
    a12 = x0 + x6 * 0.5
    a13 = a12 + m1
    a14 = a12 - m1
    a15 = a1 + a11 * 0.5
    a16 = c9_1 * a5 + c9_2 * a6
    a17 = c9_1 * a8 - c9_2 * a5
    a18 = a16 + a17
    a19 = c9_3 * a9 + c9_4 * a7
    a20 = c9_3 * a3 - c9_4 * a9
    a21 = a20 - a19
    a22 = a13 + a16
    a23 = a14 + a16
    a24 = a14 + a17
    a25 = a13 + a17
    a26 = a14 - a18
    a27 = a13 - a18
    return [a22 + a19, a15 + m3, a24 + a20, a26 - a21, a1 - a11,
            a27 + a21, a25 - a20, a15 - m3, a23 - a19]


def _win_previous_f(xprev, bt_prev):
    """Value mirror of WinPrevious: xPrevWin = x * win / 2^32, [..., 9] ->
    [..., 18]; the short layout where bt_prev == 2, the long one elsewhere."""
    win = _consts(xprev.device)["win"]
    bt = _sel4_index(bt_prev)
    x = xprev
    lo = win[:, 18:27][bt] * x
    hi = win[:, 27:36].flip(-1)[bt] * x
    long_out = torch.cat([lo, hi.flip(-1)], dim=-1)

    w2 = [float(v) for v in _consts_np()["win"][2]]
    pairs = [(6, 2, 0, 6), (7, 1, 1, 7), (8, 0, 2, 8), (9, 0, 3, 8), (10, 1, 4, 7), (11, 2, 5, 6)]
    s = [w2[wa] * x[..., xa] + w2[wb] * x[..., xb] for wa, xa, wb, xb in pairs]
    s += [w2[wa] * x[..., xa] for wa, xa in ((6, 5), (7, 4), (8, 3), (9, 3), (10, 4), (11, 5))]
    short_out = torch.stack(s + [torch.zeros_like(s[0])] * 6, dim=-1)
    return torch.where((bt_prev == 2)[..., None], short_out, long_out)


def _freq_invert(y, blk):
    """FreqInvert without the rescale: odd samples of odd blocks negated."""
    odd = ((blk & 1) == 1)[..., None] & ((torch.arange(18, device=y.device) & 1) == 1)
    return torch.where(odd, -y, y)


def _imdct36_f(xs, xprev, bt_curr, bt_prev, blk):
    """IMDCT36 over [..., 18] blocks: (y [..., 18], new_xprev [..., 9])."""
    T = mp3_tables()
    xbuf_e, xbuf_o = [None] * 9, [None] * 9
    acc1 = torch.zeros_like(xs[..., 0])
    acc2 = torch.zeros_like(acc1)
    for i in range(8, -1, -1):
        acc1 = xs[..., 2 * i + 1] - acc1
        acc2 = acc1 - acc2
        acc1 = xs[..., 2 * i] - acc1
        xbuf_o[i] = acc2
        xbuf_e[i] = acc1
    xbuf_o[0] = xbuf_o[0] * 0.5
    xbuf_e[0] = xbuf_e[0] * 0.5

    even = _idct9_f(xbuf_e)
    odd = _idct9_f(xbuf_o)

    c18, fast_win = T["c18"], T["fastWin36"]
    fast = (bt_prev == 0) & (bt_curr == 0)
    win_prev = _win_previous_f(xprev, bt_prev)
    wc = _consts(xs.device)["win"][_sel4_index(bt_curr)]            # [..., 36]

    y = [None] * 18
    new_prev = [None] * 9
    for i in range(9):
        xo = _c(c18[8 - i]) * odd[8 - i]
        xe = even[8 - i] * 0.25

        s_f = -xprev[..., i]
        d_f = -(xe - xo)
        t = s_f - d_f
        # MULSHIFT32(t, w) << 2 == t * w / 2^30
        ylo_f = d_f + t * _c(fast_win[2 * i], 2)
        yhi_f = s_f + t * _c(fast_win[2 * i + 1], 2)

        d_s = xe - xo
        # (winPrev + MULSHIFT32(d, w)) << 2
        ylo_s = (win_prev[..., i] + d_s * wc[..., i]) * 4.0
        yhi_s = (win_prev[..., 17 - i] + d_s * wc[..., 17 - i]) * 4.0

        y[i] = torch.where(fast, ylo_f, ylo_s)
        y[17 - i] = torch.where(fast, yhi_f, yhi_s)
        new_prev[i] = xe + xo
    return _freq_invert(torch.stack(y, dim=-1), blk), torch.stack(new_prev, dim=-1)


def _imdct12_f(x):
    c3_0 = _c(mp3_tables()["c9_0"], 1)
    c6_0, c6_1, c6_2 = _c(0x7BA3751D, 2), _c(0x5A82799A, 2), _c(0x2120FB83, 2)
    x0, x1, x2, x3, x4, x5 = x
    x4 = x4 - x5
    x3 = x3 - x4
    x2 = x2 - x3
    x3 = x3 - x5
    x1 = x1 - x2
    x0 = x0 - x1
    x1 = x1 - x3
    x0 = x0 * 0.5
    x1 = x1 * 0.5

    a0 = c3_0 * x2
    a1 = x0 + x4 * 0.5
    a2 = x0 - x4
    o0 = a1 + a0
    o2 = a2
    o4 = a1 - a0

    a0 = c3_0 * x3
    a1 = x1 + x5 * 0.5
    a2 = x1 - x5
    o1 = c6_0 * (a1 + a0)
    o3 = c6_1 * a2
    o5 = c6_2 * (a1 - a0)
    return [o0 + o1, o2 + o3, o4 + o5, o4 - o5, o2 - o3, o0 - o1]


def _imdct12x3_f(xs, xprev, bt_prev, blk):
    """IMDCT12x3 over [..., 18] blocks: (y [..., 18], new_xprev [..., 9])."""
    xbuf = [None] * 18
    for w in range(3):
        outs = _imdct12_f([xs[..., w + 3 * k] for k in range(6)])
        for k in range(6):
            xbuf[6 * w + k] = outs[k]

    win_prev = _win_previous_f(xprev, bt_prev)
    w2 = [float(v) for v in _consts_np()["win"][2]]
    y = [None] * 18
    for i in range(3):
        y[0 + i] = win_prev[..., 0 + i] * 4.0
        y[3 + i] = win_prev[..., 3 + i] * 4.0
        y[6 + i] = win_prev[..., 6 + i] * 4.0 + w2[0 + i] * xbuf[3 + i]
        y[9 + i] = win_prev[..., 9 + i] * 4.0 + w2[3 + i] * xbuf[5 - i]
        y[12 + i] = win_prev[..., 12 + i] * 4.0 + (w2[6 + i] * xbuf[2 - i]
                                                   + w2[0 + i] * xbuf[9 + i])
        y[15 + i] = win_prev[..., 15 + i] * 4.0 + (w2[9 + i] * xbuf[0 + i]
                                                   + w2[3 + i] * xbuf[11 - i])
    new_prev = torch.stack([xbuf[i] * 0.25 for i in (6, 7, 8, 12, 13, 14, 15, 16, 17)], dim=-1)
    return _freq_invert(torch.stack(y, dim=-1), blk), new_prev


def block_counts(nzb, block_type, mixed, block_cutoff):
    """The IMDCT's block bookkeeping (reference IMDCT :2584-2603), shared by
    both relaxed tiers: (n_blocks_long, nbfly, n_blocks_total, new nzb,
    curr_win_switch), int32 ``[L]``."""
    zero = torch.zeros_like(nzb)
    is_short = block_type == 2
    n_long_all = torch.clamp(torch.div(nzb + 7, 18, rounding_mode="floor") + 1, max=32)
    n_blocks_long = torch.where(~is_short, n_long_all,
                                torch.where(mixed == 1, block_cutoff, zero))
    nbfly = torch.where(~is_short, n_blocks_long - 1,
                        torch.where(mixed == 1, block_cutoff - 1, zero))
    nzb = torch.maximum(nzb, nbfly * 18 + 8)
    n_blocks_total = torch.div(nzb + 17, 18, rounding_mode="floor")
    curr_win_switch = torch.where(mixed == 1, block_cutoff, zero)
    return n_blocks_long, nbfly, n_blocks_total, nzb, curr_win_switch


def block_windows(L, block_type, mixed, prev_type, prev_win_switch, curr_win_switch, device):
    """Per (lane, block): the block index, the current and the previous
    window type, int32 ``[L, 32]``."""
    blk = torch.arange(NBANDS, dtype=torch.int32, device=device)[None, :].expand(L, NBANDS)
    zero = torch.zeros_like(blk)
    curr_win = torch.where((mixed[:, None] == 1) & (blk < curr_win_switch[:, None]), zero,
                           block_type[:, None].expand(L, NBANDS))
    prev_win = torch.where(blk < prev_win_switch[:, None], zero,
                           prev_type[:, None].expand(L, NBANDS))
    return blk, curr_win, prev_win


def imdct_granule_fast(x, xprev, nzb, block_type, mixed, prev_type, prev_win_switch,
                       block_cutoff, n_prev):
    """f32 hybrid synthesis for one granule and channel, over lanes: the
    block-selection integer logic of ``ops.mp3imdct.imdct_granule`` (which
    carries the reference citations), no guard-bit outputs.

    x: f32 ``[L, 576]``; xprev: f32 ``[L, 32, 9]``; the rest int32 ``[L]``.
    Returns (out f32 ``[L, 18, 32]``, new_xprev f32, new_nzb, n_blocks_out,
    curr_win_switch).
    """
    x, xprev = x.to(F32), xprev.to(F32)
    nzb, block_type, mixed, prev_type, prev_win_switch, block_cutoff, n_prev = (
        v.to(torch.int32) for v in (nzb, block_type, mixed, prev_type, prev_win_switch,
                                    block_cutoff, n_prev))
    L = x.shape[0]
    n_blocks_long, nbfly, n_blocks_total, nzb, cws = block_counts(nzb, block_type, mixed,
                                                                  block_cutoff)
    x = _antialias_f(x, nbfly)
    blk, curr_win, prev_win = block_windows(L, block_type, mixed, prev_type, prev_win_switch,
                                            cws, x.device)
    xb = x.reshape(L, NBANDS, 18)
    y36, prev36 = _imdct36_f(xb, xprev, curr_win, prev_win, blk)
    y12, prev12 = _imdct12x3_f(xb, xprev, prev_win, blk)

    ypo = _freq_invert(_win_previous_f(xprev, prev_win) * 4.0, blk)
    po_nonzero = (ypo != 0).any(dim=-1)

    m_lim = torch.maximum(n_blocks_long, n_blocks_total)[:, None]
    in_long = blk < n_blocks_long[:, None]
    in_short = ~in_long & (blk < n_blocks_total[:, None])
    in_prev = ~in_long & ~in_short & (blk >= m_lim) & (blk < n_prev[:, None])

    y = torch.where(in_long[..., None], y36,
                    torch.where(in_short[..., None], y12,
                                torch.where(in_prev[..., None], ypo, torch.zeros_like(y36))))
    new_prev = torch.where(in_long[..., None], prev36,
                           torch.where(in_short[..., None], prev12,
                                       torch.where(in_prev[..., None], torch.zeros_like(prev36),
                                                   xprev)))
    ext = torch.where(in_prev & po_nonzero, blk, torch.full_like(blk, -1))
    n_blocks_out = torch.maximum(m_lim[:, 0], ext.max(dim=-1).values)
    return y.transpose(1, 2), new_prev, nzb, n_blocks_out, cws


# --------------------------------------------------------------------------
# subband synthesis (value mirror of ops/mp3subband.subband_granule)
# --------------------------------------------------------------------------

# FDCT32 butterfly shifts (ops/mp3subband._fdct32's shift table)
_FP_SHIFTS = [(1, 5, 1), (1, 3, 1), (1, 3, 1), (1, 2, 1), (1, 2, 1), (1, 1, 2), (1, 1, 2),
              (1, 1, 4)]


def _fdct32_f(x):
    """Value mirror of the exact FDCT32: MULSHIFT32(c, v) << s ==
    v * c / 2^(32 - s). x: f32 ``[..., 32]``; returns a list of 32."""
    dct = mp3_tables()["dcttab"]
    cos4_0 = _c(0x5A82799A, 1)
    buf = [x[..., i] for i in range(32)]
    c = 0
    for i in range(8):
        s0, s1, s2 = _FP_SHIFTS[i]
        a0, a3 = buf[i], buf[31 - i]
        a1, a2 = buf[15 - i], buf[16 + i]
        b0 = a0 + a3
        b3 = _c(dct[c], s0) * (a0 - a3)
        b1 = a1 + a2
        b2 = _c(dct[c + 1], s1) * (a1 - a2)
        buf[i] = b0 + b1
        buf[15 - i] = _c(dct[c + 2], s2) * (b0 - b1)
        buf[16 + i] = b2 + b3
        buf[31 - i] = _c(dct[c + 2], s2) * (b3 - b2)
        c += 3

    for g in range(4):
        o = 8 * g
        cc = 24 + 6 * g
        a0, a7, a3, a4 = buf[o + 0], buf[o + 7], buf[o + 3], buf[o + 4]
        b0 = a0 + a7
        b7 = _c(dct[cc + 0], 1) * (a0 - a7)
        b3 = a3 + a4
        b4 = _c(dct[cc + 1], 3) * (a3 - a4)
        a0 = b0 + b3
        a3 = _c(dct[cc + 2], 1) * (b0 - b3)
        a4 = b4 + b7
        a7 = _c(dct[cc + 2], 1) * (b7 - b4)

        a1, a6, a2, a5 = buf[o + 1], buf[o + 6], buf[o + 2], buf[o + 5]
        b1 = a1 + a6
        b6 = _c(dct[cc + 3], 1) * (a1 - a6)
        b2 = a2 + a5
        b5 = _c(dct[cc + 4], 1) * (a2 - a5)
        a1 = b1 + b2
        a2 = _c(dct[cc + 5], 2) * (b1 - b2)
        a5 = b5 + b6
        a6 = _c(dct[cc + 5], 2) * (b6 - b5)

        b0 = a0 + a1
        b1 = cos4_0 * (a0 - a1)
        b2 = a2 + a3
        b3 = cos4_0 * (a3 - a2)
        buf[o + 0] = b0
        buf[o + 1] = b1
        buf[o + 2] = b2 + b3
        buf[o + 3] = b3

        b4 = a4 + a5
        b5 = cos4_0 * (a4 - a5)
        b6 = a6 + a7
        b7 = cos4_0 * (a7 - a6)
        b6 = b6 + b7
        buf[o + 4] = b4 + b6
        buf[o + 5] = b5 + b7
        buf[o + 6] = b5 + b6
        buf[o + 7] = b7
    return buf


def _v33(xb_ch):
    """The 33 FIFO values one step stores for one channel, ``[..., 33]``:
    buf[0], the 16 row sums, the 16 qrow sums (the linear map the PQMF
    stores; ops/mp3mxu.py probes it)."""
    buf = _fdct32_f(xb_ch)
    vals = [buf[0]]
    for recipe in _ROWS + _QROWS:
        t = buf[recipe[0]]
        for k in recipe[1:]:
            t = t + buf[k]
        vals.append(t)
    return torch.stack(vals, dim=-1)


def _subband_scan_acc(outbuf, vbuf, vindex: int, *, nch: int):
    """The FIFO's 18 steps, returning the accumulators before quantization.

    outbuf f32 ``[L, C, 18, 32]``; vbuf f32 ``[L, 2176]`` (read as ``[L, 34,
    64]``, ops/mp3subband.py's layout); vindex the FIFO phase. Returns (acc
    f32 ``[L, 18, C, 32]`` in PCM units, new vbuf f32 ``[L, 2176]``). Shared
    by :func:`subband_granule_fast` (which quantizes) and the operator
    probes of ops/mp3mxu.py (which need the linear map unrounded).
    """
    K = _consts(outbuf.device)
    C1, C2 = K["C1"], K["C2"]
    outbuf = outbuf.to(F32)
    L = outbuf.shape[0]
    vb = vbuf.to(F32).reshape(L, 34, 64).clone()
    v = int(vindex) & 7
    accs = []
    for step in range(18):
        odd = step & 1
        row_off, qrow_off = 17 * odd, 17 * (1 - odd)
        c0 = (v - odd) & 7
        for ch in range(nch):
            v33 = _v33(outbuf[:, ch, step, :])
            cc = 32 * ch
            for col in (v + cc, v + cc + 8):
                vb[:, row_off:row_off + 16, col] = v33[:, 1:17]
            for col in (c0 + 16 + cc, c0 + 24 + cc):
                vb[:, qrow_off:qrow_off + 16, col] = v33[:, 17:33]
            for col in (c0 + cc, c0 + cc + 8):
                vb[:, qrow_off + 16, col] = v33[:, 0]
        acc_ch = []
        for ch in range(nch):
            sl = vb[:, 17 * odd:17 * odd + 17, v + 32 * ch:v + 32 * ch + 24]
            A = sl[..., 0:8]
            Bv = sl[..., 16:24].flip(-1)
            lo = (C1 * A - C2 * Bv).sum(-1)
            hi = (C2 * A + C1 * Bv).sum(-1)
            acc_ch.append(torch.cat([lo, hi[:, 1:16].flip(-1)], dim=-1))
        accs.append(torch.stack(acc_ch, dim=1))                     # [L, C, 32]
        v = (v - odd) & 7
    return torch.stack(accs, dim=1), vb.reshape(L, 2176)


def quantize_pcm(acc):
    """Value-space PCM quantization: (+ RND) >> 26 == floor(x + 0.5) in PCM
    units, then the int16 clip. acc ``[L, 18, C, 32]`` -> pcm int16
    ``[L, 18 * 32 * C]`` (slot-major, samples channel-interleaved)."""
    x = torch.floor(acc + 0.5).clamp(-32768.0, 32767.0).to(torch.int16)
    return x.transpose(2, 3).reshape(x.shape[0], -1)


def subband_granule_fast(outbuf, vbuf, vindex: int, *, nch: int):
    """f32 subband synthesis: the FIFO layout and phase protocol of the
    exact ``subband_granule`` (a carried vbuf interconverts by a cast).

    outbuf: f32 ``[L, C, 18, 32]``; vbuf: f32 ``[L, 2176]``.
    Returns (pcm int16 ``[L, 18 * 32 * nch]``, new vbuf f32).
    """
    acc, vb = _subband_scan_acc(outbuf, vbuf, vindex, nch=nch)
    return quantize_pcm(acc), vb

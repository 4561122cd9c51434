"""MP3 (Helix) dequantization and joint stereo, plain PyTorch.

The counterpart of esp_audio_libs_tpu/ops/mp3dsp.py (reference:
src/decode/mp3_decoder.cpp :550-634 DequantBlock, :657-795 DequantChannel,
:7582-7705 Dequantize, MPEG-1 :1180-1278 and MPEG-2 :1302-1422 stereo), for
a batch of granules. The per-critical-band serial loops become per-sample
parameter arrays (``models.mp3.expand_hp_device``), so every stage is one
uniform pass over ``[L, C, 576]``.

All arithmetic is int32 with two's-complement wraparound (torch's int32
ops wrap) and MULSHIFT32 = ``(int64(x) * int64(y)) >> 32``; the results are
the JAX package's integers bit for bit. Table lookups are plain indexing:
the JAX package's select trees and rolls exist only because gathers were
slow on the TPU. Every variable shift count is clamped to [0, 31], where the
JAX package clamps it too.

Sign convention: Huffman magnitudes carry their sign in the MSB
(reference ApplySign :7095); two's complement is applied here.
"""

from __future__ import annotations

import functools

import torch

from ..runtime.tables import mp3_tables

__all__ = ["dequant_block_math", "dequantize_granule", "mulshift32"]

MAX_NSAMP = 576
INT_MIN = -(2 ** 31)
INT_MAX = 2 ** 31 - 1


@functools.lru_cache(None)
def tables(device) -> dict:
    """The MP3 tables as int32 tensors on ``device`` (cached)."""
    return {k: torch.as_tensor(v, dtype=torch.int32, device=device)
            for k, v in mp3_tables().items() if v.dtype.kind == "i"}


def mulshift32(x, y):
    """int32 high-word multiply: (int64(x) * int64(y)) >> 32."""
    return ((x.to(torch.int64) * y.to(torch.int64)) >> 32).to(torch.int32)


def _clz32(x):
    """``__builtin_clz`` with lzcnt semantics (clz(0) = 32) of int32 bit
    patterns, from shifts and compares (torch has no clz)."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    r = torch.zeros_like(u)
    for s in (16, 8, 4, 2, 1):
        hit = u >= (1 << s)
        u = torch.where(hit, u >> s, u)
        r = r + hit.to(torch.int64) * s
    return (32 - r - (u > 0).to(torch.int64)).to(torch.int32)


def or_reduce(x, dim: int = -1):
    """Bitwise OR over ``dim`` (torch has no OR reduction)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] | x[..., 1::2]
    return x[..., 0]


def dequant_block_math(sx, scale, T):
    """DequantBlock (reference :550-634) for every sample at once.

    sx: int32 sign|magnitude samples. scale: int32 per-sample gainI.
    T: :func:`tables` of the samples' device.
    Returns (signed dequantized value, magnitude y for the guard-bit mask).
    """
    x = sx & 0x7FFFFFFF
    scale_low = (scale & 0x3).to(torch.int64)
    scalef = T["pow14"][scale_low]
    scalei = torch.clamp(scale >> 2, max=31)

    tab16_x = T["pow43_14"].reshape(-1)[(scale_low << 4) | x.clamp(0, 15).to(torch.int64)]

    # x < 4 (tab4 cache): tab4[x] = x==0 ? 0 : tab16[x] >> shift
    shift4 = (scalei + 3).clamp(0, 31)
    y_lt4 = torch.where(x == 0, torch.zeros_like(x), tab16_x >> shift4)

    # 4 <= x < 16
    y_lt16 = torch.where(scalei < 0, tab16_x << (-scalei).clamp(0, 31),
                         tab16_x >> scalei.clamp(0, 31))

    # 16 <= x < 64: pow43 table + fractional scale
    y_p43 = mulshift32(T["pow43"][(x - 16).clamp(0, 47).to(torch.int64)], scalef)
    shift_p43 = scalei - 3

    # x >= 64: normalize and evaluate the polynomial
    xn = x << 17
    sh = torch.zeros_like(x)
    for lim, s in ((0x08000000, 4), (0x20000000, 2), (0x40000000, 1)):
        c = xn < lim
        xn = torch.where(c, xn << s, xn)
        sh = sh + c.to(torch.int32) * s
    use_lo = xn < 0x5A82799A   # SQRTHALF
    lo, hi = T["poly43lo"], T["poly43hi"]
    y_poly = torch.where(use_lo, lo[0], hi[0])
    for k in range(1, 5):
        y_poly = mulshift32(y_poly, xn) + torch.where(use_lo, lo[k], hi[k])
    sh64 = sh.to(torch.int64)
    y_poly = mulshift32(y_poly, T["pow2frac"][sh64]) << 3
    y_poly = mulshift32(y_poly, scalef)
    shift_poly = scalei - T["pow2exp"][sh64]

    # merge the two "integer scale" paths (x in [16, 64) and x >= 64)
    y_big = torch.where(x < 64, y_p43, y_poly)
    shift_big = torch.where(x < 64, shift_p43, shift_poly)
    shn = (-shift_big).clamp(0, 31)
    clip_lim = torch.full_like(x, INT_MAX) >> shn
    y_big = torch.where(shift_big < 0,
                        torch.where(y_big > clip_lim, torch.full_like(x, INT_MAX), y_big << shn),
                        y_big >> shift_big.clamp(0, 31))

    y = torch.where(x < 4, y_lt4, torch.where(x < 16, y_lt16, y_big))
    return torch.where(sx < 0, -y, y), y


def _take(tab, idx):
    """``tab[..., idx]`` along the last axis with a per-row index."""
    return torch.gather(tab, -1, idx.to(torch.int64))


def dequantize_granule(huff, nzb, hp, *, nch: int):
    """Dequantize + stereo for a batch of granules.

    Args:
      huff: int32 ``[L, C, 576]`` sign|magnitude Huffman values.
      nzb:  int32 ``[L, C]`` input non-zero bounds.
      hp: dict of per-lane parameter tensors (``models.mp3.expand_hp_device``
        or ``granule_params``).
      nch: channels. (The JAX function's ``sfb_s`` argument drives its
        roll-based short-block reorder; here the reorder gathers through
        ``hp["invperm"]``.)

    Returns dict with ``x`` [L, C, 576] dequantized (reordered) samples,
    ``nzb`` [L, C], ``gb`` [L, C], and the cbi fields (cb_end_l [L, C],
    cb_end_s [L, C, 3], cb_end_smax [L, C], cb_type [L, C]).
    """
    T = tables(huff.device)
    huff = huff.to(torch.int32)
    nzb = nzb.to(torch.int32)

    # ---------------- per-channel dequant (reference DequantChannel) -------
    dq, mag = dequant_block_math(huff, hp["gain"], T)
    processed = hp["processed"]
    dq = torch.where(processed, dq, huff)          # unprocessed samples left as-is
    mag = torch.where(processed, mag, torch.zeros_like(mag))
    gb = _clz32(or_reduce(mag)) - 1

    # critical-band bookkeeping (in input order, before the reorder)
    nonzero = dq != 0
    band, win, is_long = hp["band_in"], hp["win_in"], hp["is_long_in"]

    def band_max(mask, init):
        b = torch.where(mask, band, torch.full_like(band, -1))
        return torch.maximum(b.max(dim=-1).values, init)

    cb_end_l = band_max(nonzero & is_long & processed, torch.zeros_like(nzb))
    cb_start_s = hp["cb_start_s"].to(torch.int32)
    cb_end_s = torch.stack(
        [band_max(nonzero & ~is_long & processed & (win == w), cb_start_s) for w in range(3)],
        dim=-1)
    has_short = hp["has_short"]
    cb_end_s = torch.where(has_short[..., None], cb_end_s, torch.zeros_like(cb_end_s))
    cb_end_smax = cb_end_s.max(dim=-1).values
    cb_type = hp["cb_type"]

    # short-block reorder (reference :714-760, window-major -> sample-major)
    sb = hp["short_base"]
    idx = torch.arange(MAX_NSAMP, device=huff.device, dtype=torch.int32)
    short_mask = (idx >= sb[..., None]) & (idx < hp["out_nzb_short"][..., None]) \
        & has_short[..., None]
    x = torch.where(short_mask, _take(dq, hp["invperm"]), dq)
    new_nzb = torch.where(has_short, hp["out_nzb_short"].to(torch.int32), nzb)

    if nch == 1:
        return dict(x=x, nzb=new_nzb, gb=gb, cb_end_l=cb_end_l, cb_end_s=cb_end_s,
                    cb_end_smax=cb_end_smax, cb_type=cb_type)

    # ---------------- joint stereo (reference Dequantize :7618-7705) -------
    mode_ext = hp["mode_ext"].to(torch.int32)
    midside_flag = mode_ext >> 1
    intensity_flag = mode_ext & 1
    sfb_l = hp["sfb_l"]                # [L, 23]
    sfb_s_t = hp["sfb_s"]              # [L, 14]
    zero = torch.zeros_like(x[:, 0])

    # rare no-guard-bit clip
    need_clip = (mode_ext != 0) & ((gb[:, 0] < 1) | (gb[:, 1] < 1))
    in_nzb = idx < new_nzb[..., None]
    x = torch.where(need_clip[:, None, None] & in_nzb, x.clamp(-0x3FFFFFFF, 0x3FFFFFFF), x)

    # ---- mid-side ----
    cbi1_type = cb_type[:, 1]
    ms_n_long = _take(sfb_l, (cb_end_l[:, 1] + 1).clamp(0, 22)[:, None])[:, 0]
    i0_1 = 3 * _take(sfb_s_t, (cb_end_smax[:, 1] + 1).clamp(0, 13)[:, None])   # [L, 1]
    ms_n_int = torch.where(cbi1_type == 0, ms_n_long, i0_1[:, 0])
    ms_n_free = torch.maximum(new_nzb[:, 0], new_nzb[:, 1])
    ms_nsamps = torch.where(intensity_flag == 1, ms_n_int, ms_n_free)

    ms_active = (midside_flag == 1)[:, None] & (idx < ms_nsamps[:, None])
    xl, xr = x[:, 0], x[:, 1]
    ms_l, ms_r = xl + xr, xl - xr
    x0 = torch.where(ms_active, ms_l, xl)
    x1 = torch.where(ms_active, ms_r, xr)
    m_out_l = or_reduce(torch.where(ms_active, ms_l.abs(), zero))
    m_out_r = or_reduce(torch.where(ms_active, ms_r.abs(), zero))

    # ---- intensity ----
    # the long structure (band via sfBand->l) when cbi[1].cbType == 0, the
    # short structure (band via 3*sfBand->s + window) otherwise
    ob_l, ob_s, ow = hp["band_out_l"], hp["band_out_s"], hp["win_out"]
    nsamps_in = new_nzb[:, 0]
    use_long = (cbi1_type == 0)[:, None]

    long_lo = (cb_end_l[:, 1] + 1)[:, None]
    long_hi = (cb_end_l[:, 0] + 1)[:, None]
    in_long = (ob_l >= long_lo) & (ob_l < long_hi) & (ob_l >= 0) & (idx < nsamps_in[:, None])

    # MPEG-1: the same bounds for every window, whole triplets only
    s_lo_1 = (cb_end_smax[:, 1] + 1)[:, None]
    s_hi_1 = (cb_end_smax[:, 0] + 1)[:, None]
    trip_lim = i0_1 + 3 * torch.div(nsamps_in[:, None] - i0_1, 3, rounding_mode="floor")
    in_short_1 = (ob_s >= s_lo_1) & (ob_s < s_hi_1) & (ob_s >= 0) \
        & (idx < trip_lim) & (idx >= i0_1)
    # MPEG-2: per-window bounds, no sample limit (:1389-1419)
    ow64 = ow.clamp(0, 2).to(torch.int64)
    lo_w = torch.gather(cb_end_s[:, 1, :] + 1, -1, ow64)
    hi_w = torch.gather(cb_end_s[:, 0, :] + 1, -1, ow64)
    in_short_2 = (ob_s >= lo_w) & (ob_s < hi_w) & (ob_s >= 0)
    ver_is_m1 = hp["ver_is_mpeg1"].to(torch.bool)[:, None]
    in_short = torch.where(ver_is_m1, in_short_1, in_short_2)
    int_active = (intensity_flag == 1)[:, None] & torch.where(use_long, in_long, in_short)

    # intensity factors fl/fr per sample
    sf_r = torch.where(use_long, hp["sf_right_l"], hp["sf_right_s"])
    il = torch.where(use_long, hp["il_out_l"], hp["il_out_s"])
    ms1 = (midside_flag.clamp(0, 1) == 1).to(torch.int64)[:, None]          # [L, 1]
    iip = T["ISFIIP"]                                                       # [2, 2]
    iip0, iip1 = iip[ms1, 0], iip[ms1, 1]                                   # [L, 1]
    isf1 = T["ISFMpeg1"]                                                    # [2, 7]
    fl_m1 = isf1[ms1, sf_r.clamp(0, 6).to(torch.int64)]
    fr_m1 = isf1[ms1, 6] - fl_m1
    is_iip_m1 = sf_r == 7
    fl_1 = torch.where(is_iip_m1, iip0, fl_m1)
    fr_1 = torch.where(is_iip_m1, iip1, fr_m1)

    isf2 = T["ISFMpeg2"].reshape(4, 16)
    m2_row = ((hp["intensity_scale"].to(torch.int64).clamp(0, 1) << 1) | ms1[:, 0])[:, None]
    half = ((sf_r + 1) >> 1).clamp(0, 15).to(torch.int64)
    odd = (sf_r & 1) == 1
    fl_m2 = isf2[m2_row, torch.where(odd, half, torch.zeros_like(half))]
    fr_m2 = isf2[m2_row, torch.where(odd, torch.zeros_like(half), half)]
    is_iip_m2 = sf_r == il
    fl_2 = torch.where(is_iip_m2, iip0, fl_m2)
    fr_2 = torch.where(is_iip_m2, iip1, fr_m2)

    fl = torch.where(ver_is_m1, fl_1, fl_2)
    fr = torch.where(ver_is_m1, fr_1, fr_2)

    xi_r = mulshift32(fr, x0) << 2
    xi_l = mulshift32(fl, x0) << 2
    x1 = torch.where(int_active, xi_r, x1)
    x0 = torch.where(int_active, xi_l, x0)
    i_out_l = or_reduce(torch.where(int_active, xi_l.abs(), zero))
    i_out_r = or_reduce(torch.where(int_active, xi_r.abs(), zero))

    # intensity overwrites mOut (reference :1275-1276, :1416-1417); mid-side
    # ORs into it (:1155-1156)
    m_l = torch.where(intensity_flag == 1, i_out_l, m_out_l)
    m_r = torch.where(intensity_flag == 1, i_out_r, m_out_r)

    # post-stereo guard bits and nzb (reference :7694-7701)
    any_stereo = mode_ext != 0
    gb0 = torch.where(any_stereo, _clz32(m_l) - 1, gb[:, 0])
    gb1 = torch.where(any_stereo, _clz32(m_r) - 1, gb[:, 1])
    nz = torch.maximum(new_nzb[:, 0], new_nzb[:, 1])
    nzb0 = torch.where(any_stereo, nz, new_nzb[:, 0])
    nzb1 = torch.where(any_stereo, nz, new_nzb[:, 1])

    return dict(x=torch.stack([x0, x1], dim=1), nzb=torch.stack([nzb0, nzb1], dim=-1),
                gb=torch.stack([gb0, gb1], dim=-1), cb_end_l=cb_end_l, cb_end_s=cb_end_s,
                cb_end_smax=cb_end_smax, cb_type=cb_type)

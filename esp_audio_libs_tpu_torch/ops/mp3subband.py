"""MP3 subband synthesis (FDCT32 + vbuf FIFO + PQMF polyphase), plain
PyTorch.

The counterpart of esp_audio_libs_tpu/ops/mp3subband.py (reference:
src/decode/mp3_decoder.cpp :7732-8019 FDCT32, :798-810 ClipToShort,
:812-1084 Polyphase{Mono,Stereo}, :1086-1120 Subband).

The reference runs 18 serial steps per granule, each a 32-point DCT per
channel into a double-sized vbuf FIFO followed by a 64-bit multiply-add
polyphase filter. The FIFO keeps the JAX package's layout, ``[L, 2176]``
int32 read as ``[L, 34, 64]`` (row = FIFO row, 17 per parity half; column =
8-phase ring slot with the Helix double copy at +8, the qrows block at +16
and channel 1 at +32), and the ``vindex`` phase, uniform over the batch, so
that state crosses between the packages. The polyphase accumulates in int64
(exact integers, so the order of the multiply-adds is free).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime.tables import mp3_tables
from .mp3dsp import mulshift32, tables

__all__ = ["fifo_cell", "subband_granule", "subband_granule_onepass"]

DEF_NFRACBITS = 25 - 2 - 2 - 15  # = 6 (reference :791-795)
CSHIFT = 12
RND = 1 << (DEF_NFRACBITS - 1 + (32 - CSHIFT))  # rndVal (reference :873)

# write-value recipes of the output shuffle (:7856-7979): index lists into
# the post-pass buf; rows = the "samples 16..31" block, qrows = "16..1"
_ROWS = [(1,), (17, 25, 29), (9, 13), (21, 25, 29), (5,), (21, 29, 27), (13, 11), (19, 29, 27),
         (3,), (19, 27, 31), (11, 15), (23, 27, 31), (7,), (23, 31), (15,), (31,)]
_QROWS = [(1,), (17, 30, 25), (14, 9), (22, 30, 25), (6,), (22, 26, 30), (10, 14), (18, 26, 30),
          (2,), (18, 28, 26), (12, 10), (20, 28, 26), (4,), (20, 24, 28), (8, 12), (16, 24, 28)]


def _clip2n(y, n):
    sign = y >> 31
    lim = (torch.ones_like(n) << n) - 1
    return torch.where(sign != (y >> n), sign ^ lim, y)


def _fdct32(x, gb, T):
    """Reference FDCT32 (:7776-7855), first and second pass.

    x: int32 [..., 32]; gb: int32 [...]. Returns (buf list of 32, es [...]).
    """
    dct = T["dcttab"]
    cos4_0 = torch.tensor(0x5A82799A, dtype=torch.int32, device=x.device)
    es = (6 - gb).clamp(min=0)
    buf = [x[..., i] >> es for i in range(32)]

    # first pass: D32FP(i, s0, s1, s2) for i = 0..7
    shifts = [(1, 5, 1), (1, 3, 1), (1, 3, 1), (1, 2, 1), (1, 2, 1), (1, 1, 2), (1, 1, 2),
              (1, 1, 4)]
    c = 0
    for i in range(8):
        s0, s1, s2 = shifts[i]
        a0, a3 = buf[i], buf[31 - i]
        a1, a2 = buf[15 - i], buf[16 + i]
        b0 = a0 + a3
        b3 = mulshift32(dct[c], a0 - a3) << s0
        b1 = a1 + a2
        b2 = mulshift32(dct[c + 1], a1 - a2) << s1
        buf[i] = b0 + b1
        buf[15 - i] = mulshift32(dct[c + 2], b0 - b1) << s2
        buf[16 + i] = b2 + b3
        buf[31 - i] = mulshift32(dct[c + 2], b3 - b2) << s2
        c += 3

    # second pass: 4 groups of 8
    for g in range(4):
        o = 8 * g
        cc = 24 + 6 * g
        a0, a7, a3, a4 = buf[o + 0], buf[o + 7], buf[o + 3], buf[o + 4]
        b0 = a0 + a7
        b7 = mulshift32(dct[cc + 0], a0 - a7) << 1
        b3 = a3 + a4
        b4 = mulshift32(dct[cc + 1], a3 - a4) << 3
        a0 = b0 + b3
        a3 = mulshift32(dct[cc + 2], b0 - b3) << 1
        a4 = b4 + b7
        a7 = mulshift32(dct[cc + 2], b7 - b4) << 1

        a1, a6, a2, a5 = buf[o + 1], buf[o + 6], buf[o + 2], buf[o + 5]
        b1 = a1 + a6
        b6 = mulshift32(dct[cc + 3], a1 - a6) << 1
        b2 = a2 + a5
        b5 = mulshift32(dct[cc + 4], a2 - a5) << 1
        a1 = b1 + b2
        a2 = mulshift32(dct[cc + 5], b1 - b2) << 2
        a5 = b5 + b6
        a6 = mulshift32(dct[cc + 5], b6 - b5) << 2

        b0 = a0 + a1
        b1 = mulshift32(cos4_0, a0 - a1) << 1
        b2 = a2 + a3
        b3 = mulshift32(cos4_0, a3 - a2) << 1
        buf[o + 0] = b0
        buf[o + 1] = b1
        buf[o + 2] = b2 + b3
        buf[o + 3] = b3

        b4 = a4 + a5
        b5 = mulshift32(cos4_0, a4 - a5) << 1
        b6 = a6 + a7
        b7 = mulshift32(cos4_0, a7 - a6) << 1
        b6 = b6 + b7
        buf[o + 4] = b4 + b6
        buf[o + 5] = b5 + b7
        buf[o + 6] = b5 + b6
        buf[o + 7] = b7
    return buf, es


def fdct_values(x, gb, T):
    """The 33 values one step stores into the FIFO for one channel,
    ``[..., 33]``: index 0 the qrows block's last row, 1..16 the rows block,
    17..32 the qrows block, with the reference's es epilogue (:7981-8005)
    applied."""
    buf, es = _fdct32(x, gb, T)
    vals = [buf[0]]
    for recipe in _ROWS + _QROWS:
        t = buf[recipe[0]]
        for k in recipe[1:]:
            t = t + buf[k]
        vals.append(t)
    v33 = torch.stack(vals, dim=-1)
    esb = es[..., None]
    return torch.where(esb > 0, _clip2n(v33, 31 - esb) << esb, v33)


@functools.lru_cache(None)
def _poly_coefs_np():
    poly = mp3_tables()["polyCoef"].astype(np.int64)
    C1 = np.zeros((17, 8), np.int64)
    C2 = np.zeros((17, 8), np.int64)
    for r in range(16):
        C1[r] = poly[16 * r: 16 * r + 16: 2]
        C2[r] = poly[16 * r + 1: 16 * r + 16: 2]
    C1[16] = poly[256:264]
    return C1, C2


def _poly_coefs(device):
    """Tap matrices C1/C2 [17, 8] int64 such that (A = window columns 0..7,
    Bv = columns 23..16, rows 0..16):
      sample n (0..16)  = sum_x C1[n, x] A[n, x] - C2[n, x] Bv[n, x]
      sample 32-r (r>0) = sum_x C2[r, x] A[r, x] + C1[r, x] Bv[r, x]
    (reference PolyphaseStereo/Mono tap pairing, :812-1084)."""
    return tuple(torch.as_tensor(c, device=device) for c in _poly_coefs_np())


def polyphase_window(win, C1, C2):
    """int16 PCM ``[..., 32]`` of one step from its FIFO window ``[..., 17, 24]``."""
    win = win.to(torch.int64)
    A = win[..., 0:8]
    Bv = win[..., 16:24].flip(-1)
    lo = (C1 * A - C2 * Bv).sum(-1)                 # samples 0..16
    hi = (C2 * A + C1 * Bv).sum(-1)                 # rows 1..15 -> samples 31..17
    acc = torch.cat([lo, hi[..., 1:16].flip(-1)], dim=-1) + RND
    x = (acc >> (32 - CSHIFT)).to(torch.int32) >> DEF_NFRACBITS
    sign = x >> 31
    return torch.where(sign != (x >> 15), sign ^ ((1 << 15) - 1), x).to(torch.int16)


def subband_granule(outbuf, gb, vbuf, vindex: int, *, nch: int):
    """Subband transform of one granule, over lanes.

    Args:
      outbuf: int32 ``[L, C, 18, 32]`` IMDCT output.
      gb: int32 ``[L, C]`` guard bits.
      vbuf: int32 ``[L, 2176]`` carried FIFO (both channels and parities).
      vindex: the FIFO phase (0..7), uniform over the batch (callers group
        streams by it).

    Returns (pcm int16 ``[L, 18*32*nch]`` interleaved, new vbuf).
    """
    T = tables(outbuf.device)
    outbuf = outbuf.to(torch.int32)
    gb = gb.to(torch.int32)
    L = outbuf.shape[0]
    C1, C2 = _poly_coefs(outbuf.device)
    vb = vbuf.to(torch.int32).reshape(L, 34, 64).clone()
    v = int(vindex) & 7
    pcm = []
    for step in range(18):
        odd = step & 1
        row_off, qrow_off = 17 * odd, 17 * (1 - odd)
        c0 = (v - odd) & 7
        for ch in range(nch):
            v33 = fdct_values(outbuf[:, ch, step, :], gb[:, ch], T)
            cc = 32 * ch
            for col in (v + cc, v + cc + 8):
                vb[:, row_off:row_off + 16, col] = v33[:, 1:17]
            for col in (c0 + 16 + cc, c0 + 24 + cc):
                vb[:, qrow_off:qrow_off + 16, col] = v33[:, 17:33]
            for col in (c0 + cc, c0 + cc + 8):
                vb[:, qrow_off + 16, col] = v33[:, 0]
        outs = [polyphase_window(vb[:, 17 * odd:17 * odd + 17, v + 32 * ch:v + 32 * ch + 24],
                                 C1, C2) for ch in range(nch)]
        pcm.append(torch.stack(outs, dim=-1).reshape(L, 32 * nch))
        v = (v - odd) & 7
    return torch.cat(pcm, dim=-1), vb.reshape(L, 2176)


# ------------------------------------------------ the FIFO as a linear history

CARRY = 15   # FIFO steps before a granule that its PQMF reads


def fifo_cell(step: int, v: int, j: int):
    """Where FIFO step ``step`` of a granule whose phase is ``v`` stores its
    value ``j`` (0..32) of channel 0 in the ``[34, 64]`` ring: (row, first
    column); the second copy is 8 columns further, channel 1 32 further.
    Steps before the granule (``step < 0``) are where the ring holds them when
    the granule starts. Step ``s`` runs at phase ``v - floor(s / 2)``: the odd
    steps before it each moved the phase back by one."""
    odd = step & 1
    vs = (v - (step >> 1)) & 7
    c0 = (vs - odd) & 7
    if j == 0:
        return 17 * (1 - odd) + 16, c0
    if j <= 16:
        return 17 * odd + j - 1, vs
    return 17 * (1 - odd) + j - 17, c0 + 16


@functools.lru_cache(None)
def _onepass_maps(v: int):
    """Index maps of :func:`subband_granule_onepass` at phase ``v``, numpy:
    the ring cells of the carried steps (first and second copy), and for each
    step s (0..17), row r (0..16) and tap k (0..7) the history entries (copy,
    step + CARRY, value) that the step-by-step FIFO reads as its window's
    columns k (A) and 23 - k (Bv)."""
    carried = np.zeros((2, CARRY, 33), np.int64)           # flat ring cell, channel 0
    for s in range(-CARRY, 0):
        for j in range(33):
            row, col = fifo_cell(s, v, j)
            carried[0, s + CARRY, j] = row * 64 + col
            carried[1, s + CARRY, j] = row * 64 + col + 8
    a_idx = np.zeros((3, 18, 17, 8), np.int64)             # (copy, step, value) of A
    b_idx = np.zeros((3, 18, 17, 8), np.int64)             # and of Bv (row 16: unused)
    for s in range(18):
        vs = (v - (s >> 1)) & 7
        for r in range(17):
            for k in range(8):
                # column vs + k: slot age k of this parity's rows block;
                # row 16 holds value 0 of the other parity's steps
                a_step, a_val = (s - 2 * k, 1 + r) if r < 16 else (s - 2 * k - 1, 0)
                a_idx[:, s, r, k] = (int(vs + k >= 8), a_step + CARRY, a_val)
                # column vs + 23 - k: slot age 7 - k of the qrows block
                b_idx[:, s, r, k] = (int(vs + 7 - k >= 8), s - 15 + 2 * k + CARRY,
                                     17 + min(r, 15))
    return carried, a_idx, b_idx


def subband_granule_onepass(outbuf, gb, vbuf, vindex: int, *, nch: int):
    """:func:`subband_granule` computed as csrc/mp3_granules.cu computes it:
    the 33 stored values of all 18 steps first, then every PQMF output in
    one pass over a linear history (the ring's 15 carried steps, then the 18
    new ones), then the ring rebuilt from the last 16 steps. Used by tests to
    pin that index map to the step-by-step FIFO; no path on the card runs it.

    A step s reads, for its window's column k, the value of step s - 2k (its
    row 16: value 0 of step s - 2k - 1) and for column 23 - k value 17 + r of
    step s - 15 + 2k. A carried value is read from the ring copy the window
    column falls on (the copies agree whenever the ring was written by this
    FIFO). Arguments and results as :func:`subband_granule`.
    """
    T = tables(outbuf.device)
    outbuf = outbuf.to(torch.int32)
    gb = gb.to(torch.int32)
    L = outbuf.shape[0]
    v = int(vindex) & 7
    C1, C2 = _poly_coefs(outbuf.device)
    carried, a_idx, b_idx = (torch.as_tensor(m, device=outbuf.device)
                             for m in _onepass_maps(v))
    vb = vbuf.to(torch.int32).reshape(L, 2176)
    new_vb = vb.clone()
    pcm = []
    for ch in range(nch):
        new = fdct_values(outbuf[:, ch], gb[:, ch, None].expand(L, 18), T)   # [L, 18, 33]
        old = vb[:, carried + 32 * ch]                                         # [L, 2, 15, 33]
        hist = torch.stack([torch.cat([old[:, c], new], dim=1) for c in range(2)], dim=1)
        # [L, 2 copies, 33 steps, 33 values]; the new steps have one value per copy
        A = hist[:, a_idx[0], a_idx[1], a_idx[2]]                              # [L, 18, 17, 8]
        Bv = hist[:, b_idx[0], b_idx[1], b_idx[2]]
        win = torch.cat([A, torch.zeros_like(A), Bv.flip(-1)], dim=-1)         # [L, 18, 17, 24]
        pcm.append(polyphase_window(win, C1, C2))                              # [L, 18, 32]
        for s in range(2, 18):
            for j in range(33):
                row, col = fifo_cell(s, v, j)
                for c in (col, col + 8):
                    new_vb[:, row * 64 + c + 32 * ch] = new[:, s, j]
    pcm = torch.stack(pcm, dim=-1).reshape(L, 18 * 32 * nch)
    return pcm, new_vb

"""The MP3 traffic generator: a pool of MPEG-1 Layer III streams (44.1 kHz,
joint stereo with mid/side, constant bitrate), made on the host from the
seed, whose frames spend their whole bit budget as a CBR encoder's do.

No encoder is at hand, so each granule and channel is coded directly: a
quantized spectrum that falls off with frequency (big values up to
``max_value`` at the bottom, a count1 region of zeros and ones above, zeros
at the top), long blocks, scalefactors of a drawn ``scalefac_compress``,
three big-value regions each with the smallest Huffman table (ISO/IEC
11172-3 Table B.7, ``mp3_huffman.json``) that holds its largest value, and
as many lines as fill the granule's share of the frame. Every frame is
self-contained (``main_data_begin`` 0: the bit reservoir is not used).
The same seed gives the same bytes.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

SF_BAND_LONG_44K = [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162, 196,
                    238, 288, 342, 418, 576]
SLEN = [(0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3),
        (3, 1), (3, 2), (3, 3), (4, 2), (4, 3)]          # scalefac_compress -> (slen1, slen2)
BITRATE_IDX = {128: 9}
REGION0_COUNT, REGION1_COUNT = 7, 7                      # regions end at lines 36 and 162
TABLES_BY_MAX = [(1, (1,)), (2, (2, 3)), (3, (5, 6)), (5, (7, 8, 9)), (7, (10, 11, 12)),
                 (15, (13, 15)), (30, (24, 25)), (8206, (31,))]


@functools.lru_cache(None)
def codebook():
    """(pair tables {id: (linbits, code [16, 16], length [16, 16])}, quad
    tables [(code [16], length [16])])."""
    d = json.loads((Path(__file__).parent / "mp3_huffman.json").read_text())
    pair = {}
    for tid, t in d["pair"].items():
        code = np.zeros((16, 16), np.int64)
        length = np.zeros((16, 16), np.int64)
        for x, y, c, n in d["codes"][t["codes_of"]]:
            code[x, y], length[x, y] = c, n
        pair[int(tid)] = (t["linbits"], code, length)
    quad = []
    for q in d["quad"]:
        code = np.zeros(16, np.int64)
        length = np.zeros(16, np.int64)
        for v, c, n in q:
            code[v], length[v] = c, n
        quad.append((code, length))
    return pair, quad


class Bits:
    """Fields appended as (value, width) and packed MSB first."""

    def __init__(self):
        self.vals, self.widths = [], []

    def put(self, value, width):
        self.vals.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.widths.append(np.broadcast_to(np.asarray(width, np.int64),
                                           self.vals[-1].shape).copy())

    def nbits(self) -> int:
        return int(sum(w.sum() for w in self.widths))

    def pack(self) -> bytes:
        v = np.concatenate(self.vals) if self.vals else np.zeros(0, np.int64)
        w = np.concatenate(self.widths) if self.widths else np.zeros(0, np.int64)
        field = np.repeat(np.arange(len(w)), w)
        start = np.cumsum(w) - w
        shift = w[field] - 1 - (np.arange(len(field)) - start[field])
        bits = (v[field] >> shift) & 1
        bits = np.concatenate([bits, np.zeros((-len(bits)) % 8, np.int64)])
        return np.packbits(bits.astype(np.uint8)).tobytes()


def _table_for(maxval: int, rng) -> int:
    for limit, ids in TABLES_BY_MAX:
        if maxval <= limit:
            return int(ids[rng.integers(len(ids))])
    raise ValueError(maxval)


def _pair_bits(tid, a, b):
    """Per pair: the Huffman code, its length, linbits fields and signs."""
    pair, _ = codebook()
    lin, code, length = pair[tid]
    ca, cb = np.minimum(a, 15), np.minimum(b, 15)
    esc_a = (ca == 15) & (lin > 0)
    esc_b = (cb == 15) & (lin > 0)
    n = length[ca, cb] + esc_a * lin + esc_b * lin + (a > 0) + (b > 0)
    return code[ca, cb], length[ca, cb], esc_a, esc_b, lin, n


def _granule(rng, sig: dict, budget: int, side_ch: bool):
    """Side-info fields and the main data (scalefactors, Huffman) of one
    granule and channel, at most ``budget`` bits."""
    scomp = int(rng.integers(16))
    slen1, slen2 = SLEN[scomp]
    sf = np.concatenate([rng.integers(0, 1 << slen1, 11), rng.integers(0, 1 << slen2, 10)])
    part2 = 11 * slen1 + 10 * slen2
    # a spectrum falling off with frequency, mid louder than side
    k = np.arange(576)
    top = sig["max_value"] * (0.5 if side_ch else 1.0)
    env = top * np.exp(-k / rng.uniform(*sig["falloff_lines"]))
    mag = np.floor(env * rng.random(576) ** 2 + rng.random(576) * 1.3).astype(np.int64)
    mag = np.minimum(mag, sig["max_value"])
    signs = rng.integers(0, 2, 576)
    # big-value regions [0, 36), [36, 162), [162, ...): tables by their largest value
    bounds = [SF_BAND_LONG_44K[REGION0_COUNT + 1],
              SF_BAND_LONG_44K[REGION0_COUNT + REGION1_COUNT + 2], 576]
    tables, start = [], 0
    for end in bounds:
        tables.append(_table_for(int(mag[start:end].max(initial=0)), rng))
        start = end
    pairs = mag.reshape(288, 2)
    region_of = np.searchsorted(np.array(bounds), np.arange(288) * 2, side="right")
    cost = np.zeros(288, np.int64)
    enc = []
    for r, tid in enumerate(tables):
        sel = region_of == r
        c, n, ea, eb, lin, bits = _pair_bits(tid, pairs[sel, 0], pairs[sel, 1])
        cost[sel] = bits
        enc.append((sel, c, n, ea, eb, lin))
    ctab = int(rng.integers(2))
    qcode, qlen = codebook()[1][ctab]
    ones = (mag > 0).astype(np.int64)                     # count1 values are 0 or 1
    quads = ones.reshape(144, 4)
    qv = quads[:, 0] * 8 + quads[:, 1] * 4 + quads[:, 2] * 2 + quads[:, 3]
    qcost = qlen[qv] + quads.sum(1)
    # fill: about 80 % of the budget to big values, the rest to count1 quads
    avail = budget - part2
    n_pairs = int(np.searchsorted(np.cumsum(cost), 0.8 * avail, side="right"))
    n_pairs = min(n_pairs, 288) & ~1                     # count1 quads start on a quad
    used = int(cost[:n_pairs].sum())
    q0 = -(-2 * n_pairs // 4)
    qc = np.cumsum(qcost[q0:])
    n_quads = int(np.searchsorted(qc, avail - used, side="right"))
    bits = Bits()
    bits.put(sf, np.repeat([slen1, slen2], [11, 10]))
    for sel, c, n, ea, eb, lin in enc:
        idx = np.flatnonzero(sel)
        take = idx < n_pairs
        idx, c_, n_, ea_, eb_ = idx[take], c[take], n[take], ea[take], eb[take]
        if not len(idx):
            continue
        a, b = pairs[idx, 0], pairs[idx, 1]
        fields = np.stack([c_, a - 15, signs[2 * idx], b - 15, signs[2 * idx + 1]], 1)
        widths = np.stack([n_, ea_ * lin, (a > 0).astype(np.int64), eb_ * lin,
                           (b > 0).astype(np.int64)], 1)
        bits.put(fields.ravel(), widths.ravel())
    q = np.arange(n_pairs // 2, n_pairs // 2 + n_quads)
    q = q[q < 144]
    if len(q):
        vals = quads[q]
        sgn = signs.reshape(144, 4)[q]
        fields = np.concatenate([qcode[qv[q]][:, None], sgn], 1)
        widths = np.concatenate([qlen[qv[q]][:, None], vals], 1)
        bits.put(fields.ravel(), widths.ravel())
    side = dict(part23=bits.nbits(), big_values=n_pairs, global_gain=int(
        rng.integers(*sig["global_gain"])), scalefac_compress=scomp, tables=tables,
        preflag=int(rng.integers(2)), scalefac_scale=int(rng.integers(2)), count1table=ctab)
    return side, bits


def frame_bytes(bitrate_kbps: int, rate: int, padding: int) -> int:
    return 144 * bitrate_kbps * 1000 // rate + padding


def make_frame(rng, sig: dict, padding: int) -> bytes:
    """One MPEG-1 Layer III joint-stereo (mid/side) frame at 44.1 kHz."""
    size = frame_bytes(sig["bitrate_kbps"], 44100, padding)
    main_bits = (size - 4 - 32) * 8
    grans = [[_granule(rng, sig, main_bits // 4, side_ch=ch == 1) for ch in range(2)]
             for _ in range(2)]
    hdr = Bits()
    hdr.put([0xFFF, 1, 1, 1, BITRATE_IDX[sig["bitrate_kbps"]], 0, padding, 0, 1, 2, 0, 0, 0],
            [12, 1, 2, 1, 4, 2, 1, 1, 2, 2, 1, 1, 2])
    si = Bits()
    si.put([0, 0, 0, 0], [9, 3, 4, 4])                   # main_data_begin, private, scfsi
    for gr in grans:
        for side, _ in gr:
            t = side["tables"]
            si.put([side["part23"], side["big_values"], side["global_gain"],
                    side["scalefac_compress"], 0, t[0], t[1], t[2], REGION0_COUNT,
                    REGION1_COUNT, side["preflag"], side["scalefac_scale"],
                    side["count1table"]],
                   [12, 9, 8, 4, 1, 5, 5, 5, 4, 3, 1, 1, 1])
    main = Bits()
    for gr in grans:
        for _, b in gr:
            main.vals += b.vals
            main.widths += b.widths
    body = hdr.pack() + si.pack() + main.pack()
    if len(body) > size:
        raise AssertionError("a frame overran its budget")
    return body + bytes(size - len(body))


def make_pool(traffic: dict, seed: int, device=None) -> list[bytes]:
    """``traffic["pool_streams"]`` streams of ``traffic["stream_frames"]``
    frames each."""
    sig = traffic["signal"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    pool = []
    for _ in range(traffic["pool_streams"]):
        frames, rest = [], 0
        for _ in range(traffic["stream_frames"]):
            rest += (144 * sig["bitrate_kbps"] * 1000) % 44100
            pad = int(rest >= 44100)
            rest -= 44100 * pad
            frames.append(make_frame(rng, sig, pad))
        pool.append(b"".join(frames))
    return pool

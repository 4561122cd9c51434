"""Plain reference of the MP3 -> 16 kHz chain: a floating-point MPEG-1
Layer III decoder written from ISO/IEC 11172-3 (2.4.3.4), and the exact
resampler of ``art_resampler_ref.py`` for the 16 kHz stage.

It imports nothing of the program under test. Its tables are the
standard's: the Huffman codes of Table B.7 (``generators/mp3_huffman.json``,
shared with the traffic generator), the synthesis window D of Table B.3
(``mp3_synthesis_window.json``), the scalefactor bands of Table B.8, the
alias-reduction coefficients of Table B.9; the IMDCT window and the
matrixing are computed. The decoder covers what the traffic uses:
MPEG-1 Layer III at 44.1 kHz, long blocks, mid/side stereo, no bit
reservoir (``main_data_begin`` 0); anything else raises.

``precision="float64"`` is the reference; ``"bfloat16"`` computes every
operation of the synthesis in bfloat16, the control that the comparison
has to reject.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SF_BAND_LONG_44K = [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162, 196,
                    238, 288, 342, 418, 576]
PRETAB = [0] * 11 + [1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0]
SLEN = [(0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3),
        (3, 1), (3, 2), (3, 3), (4, 2), (4, 3)]
ALIAS_C = [-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037]
BITRATES_KBPS = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]


@functools.lru_cache(None)
def tables():
    """The Huffman decoders ({table: ({(length, code): (x, y)}, linbits)},
    [{(length, code): vwxy}] for count1 A and B) and D[512] (float64)."""
    h = json.loads((HERE.parent / "generators" / "mp3_huffman.json").read_text())
    pair = {}
    for tid, t in h["pair"].items():
        pair[int(tid)] = ({(n, c): (x, y) for x, y, c, n in h["codes"][t["codes_of"]]},
                          t["linbits"])
    quad = [{(n, c): v for v, c, n in q} for q in h["quad"]]
    w = json.loads((HERE / "mp3_synthesis_window.json").read_text())
    return pair, quad, np.array(w["D_times_65536"], np.float64) / 65536.0


class BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | b
        if self.pos + n > len(self.bits):
            raise ValueError("read past the end of the data")
        self.pos += n
        return v

    def code(self, book: dict):
        """One Huffman symbol of ``book`` ({(length, code): value})."""
        c, n = 0, 0
        while n < 20:
            c = (c << 1) | self.bits[self.pos + n]
            n += 1
            if (n, c) in book:
                self.pos += n
                return book[n, c]
        raise ValueError("no Huffman code matches")


def parse_frame(data: bytes, pos: int):
    """(frame bytes, side info) of the frame at ``pos``."""
    h = BitReader(data[pos:pos + 4])
    sync, mpeg1, layer, no_crc = h.read(12), h.read(1), h.read(2), h.read(1)
    br, sr, pad = h.read(4), h.read(2), h.read(1)
    _priv, mode, mode_ext = h.read(1), h.read(2), h.read(2)
    if (sync, mpeg1, layer, no_crc, sr, mode) != (0xFFF, 1, 1, 1, 0, 1) or not mode_ext & 2:
        raise ValueError("not an MPEG-1 Layer III 44.1 kHz mid/side frame without CRC")
    size = 144 * BITRATES_KBPS[br] * 1000 // 44100 + pad
    si = BitReader(data[pos + 4:pos + 36])
    mdb, _priv, scfsi = si.read(9), si.read(3), [si.read(4), si.read(4)]
    if mdb or any(scfsi) or mode_ext & 1:
        raise ValueError("the bit reservoir, scfsi and intensity stereo are not covered")
    gr = []
    for _ in range(2):
        chans = []
        for _ in range(2):
            g = dict(part23=si.read(12), big_values=si.read(9), global_gain=si.read(8),
                     scalefac_compress=si.read(4), window_switching=si.read(1))
            if g["window_switching"]:
                raise ValueError("short and switched blocks are not covered")
            g.update(tables=[si.read(5), si.read(5), si.read(5)], region0=si.read(4),
                     region1=si.read(3), preflag=si.read(1), scalefac_scale=si.read(1),
                     count1table=si.read(1))
            chans.append(g)
        gr.append(chans)
    return size, gr


def granule_lines(r: BitReader, g: dict):
    """Scalefactors and Huffman data of one granule and channel: (the
    quantized lines q[576], the requantized lines xr[576] in float64, the
    number of lines the Huffman data spans)."""
    pair, quad, _ = tables()
    start = r.pos
    slen1, slen2 = SLEN[g["scalefac_compress"]]
    sf = [r.read(slen1) for _ in range(11)] + [r.read(slen2) for _ in range(10)] + [0]
    end = start + g["part23"]
    q = np.zeros(576, np.int64)
    b1 = SF_BAND_LONG_44K[g["region0"] + 1]
    b2 = SF_BAND_LONG_44K[min(g["region0"] + g["region1"] + 2, 22)]
    i = 0
    while i < 2 * g["big_values"]:
        tid = g["tables"][0 if i < b1 else 1 if i < b2 else 2]
        book, lin = pair[tid]
        x, y = r.code(book)
        vals = []
        for v in (x, y):
            if lin and v == 15:
                v += r.read(lin)
            if v and r.read(1):
                v = -v
            vals.append(v)
        q[i], q[i + 1] = vals
        i += 2
    book = quad[g["count1table"]]
    while r.pos < end and i + 4 <= 576:
        v = r.code(book)
        for k, bit in enumerate((8, 4, 2, 1)):
            if v & bit:
                q[i + k] = -1 if r.read(1) else 1
        i += 4
    if r.pos != end:
        raise ValueError("a granule's Huffman data overran its part2_3_length")
    # requantize (2.4.3.4.7.1, long blocks)
    mult = 1.0 if g["scalefac_scale"] else 0.5
    band = np.searchsorted(SF_BAND_LONG_44K, np.arange(576), side="right") - 1
    sfv = np.array(sf)[band] + g["preflag"] * np.array(PRETAB)[band]
    gain = 2.0 ** (0.25 * (g["global_gain"] - 210) - mult * sfv)
    return q, np.sign(q) * np.abs(q) ** (4.0 / 3.0) * gain, i


def frame_stats(data: bytes, n_frames: int) -> np.ndarray:
    """Per frame, granule and channel of a stream: (quantized lines with
    magnitude 1-15, 16-63, 64 and up, the lines the Huffman data spans),
    int64 [n_frames, 2, 2, 4]: what the granule synthesis has to work on."""
    out = np.zeros((n_frames, 2, 2, 4), np.int64)
    pos = 0
    for f in range(n_frames):
        size, side = parse_frame(data, pos)
        r = BitReader(data[pos + 36:pos + size])
        for g in range(2):
            for ch in range(2):
                q, _, span = granule_lines(r, side[g][ch])
                m = np.abs(q)
                out[f, g, ch] = ((m > 0) & (m < 16)).sum(), ((m >= 16) & (m < 64)).sum(), \
                    (m >= 64).sum(), span
        pos += size
    return out


@functools.lru_cache(None)
def _synthesis_consts():
    k = np.arange(18)
    i = np.arange(36)
    imdct = np.cos(math.pi / 72 * (2 * i[:, None] + 1 + 18) * (2 * k[None, :] + 1))   # [36, 18]
    win = np.sin(math.pi / 36 * (i + 0.5))
    n = np.arange(64)
    matrix = np.cos((16 + n[:, None]) * (2 * np.arange(32)[None, :] + 1) * math.pi / 64)
    c = np.array(ALIAS_C)
    return imdct * win[:, None], matrix, 1 / np.sqrt(1 + c * c), c / np.sqrt(1 + c * c)


def decode(streams: list[bytes], n_frames: int, precision: str = "float64") -> np.ndarray:
    """Decode the first ``n_frames`` frames of each stream (all of one
    format) to int16 PCM [S, n_frames * 1152, 2]."""
    dt = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    imdct, matrix, cs, ca = (torch.as_tensor(a, dtype=dt) for a in _synthesis_consts())
    D = torch.as_tensor(tables()[2], dtype=dt)
    S = len(streams)
    overlap = torch.zeros((S, 2, 32, 18), dtype=dt)
    V = torch.zeros((S, 2, 1024), dtype=dt)
    pos = [0] * S
    out = np.zeros((S, n_frames * 1152, 2), np.int16)
    ui = np.concatenate([np.arange(128 * m, 128 * m + 32) for m in range(8)]
                        + [np.arange(128 * m + 96, 128 * m + 128) for m in range(8)])
    uj = np.concatenate([np.arange(64 * m, 64 * m + 32) for m in range(8)]
                        + [np.arange(64 * m + 32, 64 * m + 64) for m in range(8)])
    u_of_v = torch.as_tensor(ui[np.argsort(uj)])          # U[k] = V[u_of_v[k]]
    for f in range(n_frames):
        xr = np.zeros((S, 2, 2, 576))
        for s, data in enumerate(streams):
            size, side = parse_frame(data, pos[s])
            r = BitReader(data[pos[s] + 36:pos[s] + size])
            for g in range(2):
                for ch in range(2):
                    xr[s, g, ch] = granule_lines(r, side[g][ch])[1]
            pos[s] += size
        x = torch.as_tensor(xr, dtype=dt)
        for g in range(2):
            m, sd = x[:, g, 0], x[:, g, 1]
            inv = torch.as_tensor(1 / math.sqrt(2), dtype=dt)
            lr = torch.stack([(m + sd) * inv, (m - sd) * inv], 1).reshape(S, 2, 32, 18)
            # alias reduction between adjacent subbands (2.4.3.4.9): L[i] is line
            # 17 - i of subband sb - 1, U[i] line i of subband sb
            L, U = lr[..., :-1, 10:].flip(-1), lr[..., 1:, :8]
            new_l, new_u = L * cs - U * ca, U * cs + L * ca
            lr = lr.clone()
            lr[..., :-1, 10:] = new_l.flip(-1)
            lr[..., 1:, :8] = new_u
            z = lr @ imdct.T                                 # [S, 2, 32, 36]
            y = z[..., :18] + overlap
            overlap = z[..., 18:]
            y[..., 1::2, 1::2] = -y[..., 1::2, 1::2]         # frequency inversion
            for t in range(18):
                V = torch.cat([y[..., t] @ matrix.T, V[..., :-64]], -1)
                w = V[..., u_of_v] * D                       # [S, 2, 512]
                pcm = w.reshape(S, 2, 16, 32).sum(-2) * 32768.0
                q = torch.clamp(torch.floor(pcm.double() + 0.5), -32768, 32767)
                base = (f * 2 + g) * 576 + t * 32
                out[:, base:base + 32, :] = q.numpy().astype(np.int16).transpose(0, 2, 1)
    return out

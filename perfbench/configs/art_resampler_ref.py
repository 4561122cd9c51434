"""Plain reference of the exact resampling chain, written from the C
library's semantics (esp-audio-libs: src/resample/resampler.cpp,
art_resampler.cpp, art_biquad.cpp, src/quantization_utils.cpp).

It imports nothing of the program under test and takes nothing the program
made: the biquad coefficients, the windowed-sinc filterbank and the phase
schedule are worked out again here. The only state it may be handed is a
stream's carried state at a call boundary (history, biquad states, phase),
for calls in the middle of a run; the first calls of a run start from the
zero state and chain their own.

Every f32 operation is its own IEEE operation in the C library's order:
numpy and eager PyTorch ops never contract a multiply and an add. The
exact mode's rule for subnormals (each result below 2**-126 flushed to a
zero of its sign) is applied wherever a value that small appears; on the
benchmark's traffic none does, so the fast path checks for it and takes
the flushing path only then.

``precision="bfloat16"`` computes the same chain with every value and every
operation rounded to bfloat16: the control that the comparison has to
reject.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

F32 = np.float32
TINY = 2.0 ** -126
SMALL = 2.0 ** -100                 # below this a value may lead to a subnormal product
SUBSAMPLE_INTERPOLATE, INCLUDE_LOWPASS = 0x1, 0x4


@functools.lru_cache(None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    lib.powf.restype, lib.powf.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return lib


# ---------------------------------------------------------------- rounding
def _bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 values to the nearest bfloat16 (ties to even), kept as f32
    (no NaN reaches it)."""
    u = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((u + (0x7FFF + ((u >> 16) & 1))) & 0xFFFF0000).view(F32)


def _ftz(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, F32)
    return np.where(np.abs(a) < TINY, a * F32(0.0), a)


class Arith:
    """The rounding of one precision: ``r(x)`` after every operation."""

    def __init__(self, precision: str, flush: bool):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision!r}")
        self.precision, self.flush = precision, flush
        self.torch_dtype = torch.float32 if precision == "float32" else torch.bfloat16

    def r(self, a):
        if self.precision == "bfloat16":
            a = _bf16(a)
        return _ftz(a) if self.flush else a

    @property
    def identity(self) -> bool:
        return self.precision == "float32" and not self.flush


# ------------------------------------------------------------ design (host)
def biquad_lowpass(frequency: float) -> np.ndarray:
    """art_biquad.cpp lowpass, Q = sqrt(0.5): double math, f32 fields
    {a0, a1, a2, b1, b2}; a1 = 2 * (f32) a0 and a2 = (f32) a0."""
    Q = math.sqrt(0.5)
    K = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + K / Q + K * K)
    a0 = F32(K * K * norm)
    return np.array([a0, F32(2) * a0, a0, F32(2.0 * (K * K - 1.0) * norm),
                     F32((1.0 - K / Q + K * K) * norm)], F32)


def filterbank(taps: int, filters: int, lowpass: float, flags: int) -> np.ndarray:
    """art_resampler.cpp init_filter: [filters + 1, taps] windowed sinc
    (Hann window) with unity-DC normalization and error diffusion, in C's
    f32 order with the C library's sinf/cosf."""
    lm = _libm()
    center = taps // 2
    visit = [center]
    for k in range(1, center):
        visit += [center - k, center + k]
    visit.append(0)
    lp = F32(lowpass)
    bank = np.zeros((filters + 1, taps), F32)
    for row in range(filters + 1):
        frac = F32(F32(row) / F32(filters))
        mag = np.zeros(taps, F32)
        dc = F32(0.0)
        for t in range(taps):
            dist = F32(float(abs(F32(F32(center - 1) + frac) - F32(t))) * math.pi)
            m = F32(1.0)
            if dist != 0.0:
                arg = F32(dist * lp)
                m = F32(F32(lm.sinf(arg)) / arg)
                u = F32(dist / F32(center))
                m = F32(m * F32(F32(0.5) * F32(F32(1.0) + F32(lm.cosf(u)))))
            mag[t] = m
            dc = F32(dc + m)
        scale = F32(F32(1.0) / dc)
        diffusion = F32(0.0)
        for t in visit:
            scaled = F32(mag[t] * scale)
            emitted = F32(scaled - diffusion)
            bank[row, t] = emitted
            diffusion = F32(diffusion + F32(emitted - scaled))
    return bank


@dataclasses.dataclass
class Design:
    """What resampler.cpp's initialize works out from the configuration."""

    ratio: np.float32
    taps: int
    filters: int
    flags: int
    pre_filter: bool
    post_filter: bool
    coeffs: np.ndarray | None
    bank: np.ndarray


def design(cfg: dict, src: float, dst: float) -> Design:
    """resampler.cpp:21-98 for one rate pair; ``cfg`` holds the
    configuration file's ``resampler`` keys."""
    taps, nf = cfg["number_of_taps"], cfg["number_of_filters"]
    ratio = F32(F32(dst) / F32(src))
    lowpass = F32(1.0)
    flags = SUBSAMPLE_INTERPOLATE if cfg["subsample_interpolate"] else 0
    if ratio < 1.0:
        lowpass = F32(lowpass - F32(F32(10.24) / F32(taps)))
        lowpass = max(lowpass, F32(0.84))
        lowpass = max(lowpass, ratio)
    pre = post = False
    coeffs = None
    if F32(lowpass * ratio) < F32(0.98) and cfg["use_pre_or_post_filter"]:
        coeffs = biquad_lowpass(float(F32(F32(lowpass * ratio) / F32(2.0))))
        pre = True
    if F32(lowpass / ratio) < F32(0.98) and cfg["use_pre_or_post_filter"] and not pre:
        coeffs = biquad_lowpass(float(F32(F32(lowpass / ratio) / F32(2.0))))
        post = True
    if ratio < 1.0:
        bank_lp, flags = F32(ratio * lowpass), flags | INCLUDE_LOWPASS
    elif lowpass < 1.0:
        bank_lp, flags = lowpass, flags | INCLUDE_LOWPASS
    else:
        bank_lp = F32(1.0)
    return Design(ratio, taps, nf, flags, pre, post, coeffs,
                  filterbank(taps, nf, float(bank_lp), flags))


# ------------------------------------------------------------ phase (host)
@dataclasses.dataclass
class Phase:
    """art_resampler.cpp's outputOffset and inputIndex (shared by a batch)."""

    offset: np.float32
    input_index: int

    @classmethod
    def start(cls, taps: int) -> "Phase":
        """resampleInit (offset taps/2, index taps), then initialize's
        advance by taps/2 that cancels the filter's latency."""
        return cls(F32(F32(taps // 2) + F32(taps / 2.0)), taps)


def schedule(ph: Phase, d: Design, n_in: int, n_out: int):
    """The outputs of one chunk of ``n_in`` inputs (at most ``n_out``), as
    art_resampler.cpp:167-202 interleaves them: per output the window start
    relative to the chunk's first new sample, the two filter rows, the lerp
    weight and the mode (0 copy, 1 one row, 2 two rows and a lerp).
    Advances ``ph``; returns (win0, idx1, idx2, weight, mode, inputs used)."""
    half, ring = d.taps // 2, d.taps * 16
    step = F32(F32(1.0) / d.ratio)
    nf = F32(d.filters)
    interp, lowpass = d.flags & SUBSAMPLE_INTERPOLATE, d.flags & INCLUDE_LOWPASS
    off, idx, used = ph.offset, ph.input_index, 0
    win0, i1s, i2s, ws, modes = [], [], [], [], []
    while len(win0) < n_out:
        if off >= F32(idx - half):
            if used == n_in:
                break
            if idx == ring:
                off = F32(off - F32(ring - d.taps))
                idx -= ring - d.taps
            idx += 1
            used += 1
            continue
        fl = F32(math.floor(off))
        frac = F32(off - fl)
        win0.append(int(fl) - idx + used - half + 1)
        if frac == 0.0 and not lowpass:
            mode, i1, i2, w = 0, 0, 0, F32(0.0)
        elif not interp:
            mode, i1, i2, w = 1, int(math.floor(F32(F32(frac * nf) + F32(0.5)))), 0, F32(0.0)
        else:
            o = F32(frac * nf)
            i1 = int(math.floor(o))
            w = F32(o - F32(i1))
            mode, i2 = (1, 0) if (w == 0.0 and not lowpass) else (2, i1 + 1)
        i1s.append(i1)
        i2s.append(i2)
        ws.append(w)
        modes.append(mode)
        off = F32(off + step)
    ph.offset, ph.input_index = off, idx
    return (np.array(win0, np.int64), np.array(i1s, np.int64), np.array(i2s, np.int64),
            np.array(ws, F32), np.array(modes, np.int8), used)


# --------------------------------------------------------------- the chain
def history_len(d: Design) -> int:
    """Samples carried left of a chunk: a window reaches back at most
    taps + 2 samples; 6 more are slack."""
    return d.taps + 8


def biquad(x: np.ndarray, c: np.ndarray, st, ar: Arith):
    """art_biquad.cpp:84-90 over the last axis of f32 ``x`` [lanes, T]:
    y = ((((x*a0) + i1*a1) + i2*a2) - b1*o1) - b2*o2, each op rounded.
    ``st`` = (in_d1, in_d2, out_d1, out_d2), each [lanes]. Returns (y, state)."""
    r = ar.r
    a0, a1, a2, b1, b2 = (F32(v) for v in r(c))
    i1, i2, o1, o2 = (r(s).astype(F32) for s in st)
    x = r(x)
    ext = np.concatenate([i2[:, None], i1[:, None], x], axis=1)
    acc = r(r(r(x * a0) + r(ext[:, 1:-1] * a1)) + r(ext[:, :-2] * a2))
    accT = np.ascontiguousarray(acc.T)
    yT = np.empty_like(accT)
    if ar.identity:
        t1, t2 = np.empty_like(o1), np.empty_like(o1)
        for t in range(accT.shape[0]):
            np.multiply(b1, o1, out=t1)
            np.multiply(b2, o2, out=t2)
            y = yT[t]
            np.subtract(accT[t], t1, out=y)
            np.subtract(y, t2, out=y)
            o2, o1 = o1, y
    else:
        for t in range(accT.shape[0]):
            y = r(r(accT[t] - r(b1 * o1)) - r(b2 * o2))
            yT[t] = y
            o2, o1 = o1, y
    y = np.ascontiguousarray(yT.T)
    T = x.shape[1]
    outs = np.concatenate([st[3][:, None].astype(F32), st[2][:, None].astype(F32), y], axis=1)
    return y, (ext[:, T + 1].copy(), ext[:, T].copy(), outs[:, T + 1].copy(), outs[:, T].copy())


def polyphase(xext: np.ndarray, bank: np.ndarray, win, i1, i2, w, mode, half: int,
              ar: Arith, device) -> np.ndarray:
    """art_resampler.cpp:421-458 for every output of a chunk, over the
    rows of ``xext`` [lanes, L] (``win`` indexes xext): each dot from +0 in
    tap order, one rounded product and one rounded sum a tap; mode 2 takes
    acc2*w + acc1*(1 - w) with 1 - w rounded first; mode 0 copies
    x[win + half - 1]. Returns f32 [lanes, n]."""
    dt = ar.torch_dtype

    def t(a, dtype=dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    def fz(v):
        return torch.where(v.abs() < TINY, v * 0.0, v) if ar.flush else v

    raw, fb = t(ar.r(xext)), fz(t(ar.r(bank)))
    x = fz(raw)
    win_t = t(win, torch.int64)
    f1, f2 = fb[t(i1, torch.int64)], fb[t(i2, torch.int64)]        # [n, taps]
    acc1 = torch.zeros((x.shape[0], len(win)), dtype=dt, device=device)
    acc2 = acc1.clone()
    for k in range(bank.shape[1]):
        xg = x[:, win_t + k]
        acc1 = fz(acc1 + fz(xg * f1[:, k]))
        acc2 = fz(acc2 + fz(xg * f2[:, k]))
    wt = fz(t(ar.r(w)))
    one = torch.ones((), dtype=dt, device=device)
    lerp = fz(fz(acc2 * wt) + fz(acc1 * fz(one - wt)))
    mode_t = t(mode, torch.int64)
    out = torch.where(mode_t == 0, raw[:, win_t + (half - 1)],
                      torch.where(mode_t == 1, acc1, lerp))
    return out.float().cpu().numpy()


def quantize16(y: np.ndarray):
    """quantization_utils.cpp:50-94 at 16 bits: floorf(y*32768 + 0.5) with
    the product rounded first, NaN or out of int32 range to INT_MIN, clip to
    [-32768, 32767] and count the clipped samples. Returns (int16, clipped)."""
    v = np.floor((y.astype(F32) * F32(32768.0)).astype(F32) + F32(0.5)).astype(np.float64)
    ok = np.isfinite(v) & (v >= -2.0 ** 31) & (v < 2.0 ** 31)
    iv = np.where(ok, v, -2.0 ** 31)
    clipped = (iv > 32767) | (iv < -32768)
    return np.clip(iv, -32768, 32767).astype(np.int16), clipped


@dataclasses.dataclass
class State:
    """The carried state of the reference's streams at a call boundary."""

    history: np.ndarray              # f32 [S, ch, history_len]: the last inputs of the dots
    biquad: list                     # two stages of (in_d1, in_d2, out_d1, out_d2), [S, ch]
    phase: Phase

    @classmethod
    def zero(cls, d: Design, streams: int, ch: int) -> "State":
        z = np.zeros((streams, ch), F32)
        return cls(np.zeros((streams, ch, history_len(d)), F32),
                   [(z, z, z, z), (z, z, z, z)], Phase.start(d.taps))


def resample_call(d: Design, st: State, pcm: np.ndarray, chunk_frames: int, chunks: int,
                  ch: int, precision: str = "float32", device="cpu"):
    """One ``resample_stream(pcm, chunk_frames, chunks)`` of the exact mode
    for the streams of ``pcm`` (int16 [S, chunks * chunk_frames * ch],
    interleaved), from state ``st``. Returns (per chunk int16 [S, gen, ch],
    per chunk clipped counts [S], per chunk generated counts, new state, the
    generated outputs' counts by mode)."""
    S = pcm.shape[0]
    out_max = math.ceil(chunk_frames * float(d.ratio)) + 8
    factor = F32(F32(_libm().powf(F32(10.0), F32(0.0))) / F32(32768.0))
    lanes = S * ch
    x_all = pcm.reshape(S, chunks * chunk_frames, ch).transpose(0, 2, 1).astype(F32) * factor
    x_all = x_all.reshape(lanes, -1)
    hist = st.history.reshape(lanes, -1)
    stages = [tuple(s.reshape(lanes) for s in stage) for stage in st.biquad]
    ph = dataclasses.replace(st.phase)
    outs, clips, gens = [], [], []
    modes = np.zeros(3, np.int64)
    for c in range(chunks):
        xc = x_all[:, c * chunk_frames:(c + 1) * chunk_frames]
        win, i1, i2, w, mode, used = schedule(ph, d, chunk_frames, out_max)
        if used != chunk_frames:
            raise AssertionError(f"chunk consumed {used} of {chunk_frames} inputs")
        for flush in (False, True):
            ar = Arith(precision, flush)
            xc_f, st_f = xc, list(stages)
            if d.pre_filter:
                for s in range(2):
                    xc_f, st_f[s] = biquad(xc_f, d.coeffs, st_f[s], ar)
            xext = np.concatenate([hist, xc_f], axis=1)
            H = hist.shape[1]
            if (win + H).min() < 0:
                raise AssertionError("a window reaches past the carried history")
            y = polyphase(xext, d.bank, win + H, i1, i2, w, mode, d.taps // 2, ar, device)
            if d.post_filter:
                for s in range(2):
                    y, st_f[s] = biquad(y, d.coeffs, st_f[s], ar)
            seen = np.concatenate([xext.ravel(), y.ravel()])
            tiny = (seen != 0) & (np.abs(seen) < SMALL)
            if flush or not tiny.any():
                break
        stages = st_f
        hist = xext[:, -H:]
        q, clipped = quantize16(y)
        outs.append(q.reshape(S, ch, -1).transpose(0, 2, 1))
        clips.append(clipped.reshape(S, -1).sum(1))
        gens.append(len(win))
        modes += np.bincount(mode, minlength=3)
    new = State(hist.reshape(S, ch, -1).copy(),
                [tuple(s.reshape(S, ch).copy() for s in stage) for stage in stages], ph)
    return outs, clips, gens, new, modes

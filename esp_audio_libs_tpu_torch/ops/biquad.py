"""ART biquad filters, host half: RBJ-style design and the impulse-response
helpers the fast resampler folds into its filterbank.

Numpy copies of esp_audio_libs_tpu/ops/biquad.py:37-151 (reference:
src/resample/art_biquad.cpp:16-51). Coefficient layout matches the reference
struct ``BiquadCoefficients`` {a0, a1, a2, b1, b2}. The device-side
``biquad_apply`` belongs to exact mode and is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["biquad_lowpass", "biquad_init", "fir_len_for", "biquad_impulse",
           "fold_biquad_into_filterbank"]


def biquad_lowpass(frequency: float) -> np.ndarray:
    """2nd-order lowpass design, Q = sqrt(0.5)
    (reference src/resample/art_biquad.cpp:16-25). Returns f32[5] {a0,a1,a2,b1,b2}.

    Design math runs in float64 exactly as the C double math, truncating to
    f32 on store (the C struct fields are float).
    """
    Q = math.sqrt(0.5)
    K = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + K / Q + K * K)
    a0 = K * K * norm
    # a1 = 2 * filter->a0 AFTER a0 was truncated to float (art_biquad.cpp:21-22)
    return np.array([a0, 2 * float(np.float32(a0)), a0, 2.0 * (K * K - 1.0) * norm,
                     (1.0 - K / Q + K * K) * norm], dtype=np.float32)


def biquad_init(coeffs: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Fold gain into the numerator (reference art_biquad.cpp:43-51)."""
    c = np.asarray(coeffs, np.float32).copy()
    g = np.float32(gain)
    c[0] = np.float32(c[0] * g)
    c[1] = np.float32(c[1] * g)
    c[2] = np.float32(c[2] * g)
    return c


def fir_len_for(coeffs: np.ndarray, tol: float = 1e-9, cap: int = 2048) -> int | None:
    """Impulse-response truncation length for the folded fast path.

    The IIR tail decays like r^k with r the pole radius (r = sqrt(b2) for a
    complex pair). Returns a multiple of 128, or None when the poles are too
    close to the unit circle for truncation to be profitable.
    """
    b2 = float(abs(coeffs[4]))
    b1 = float(abs(coeffs[3]))
    r = max(np.sqrt(b2) if b2 > 0 else 0.0, b1 / 2.0)
    r = min(max(r, 1e-6), 0.999999)
    k = int(np.ceil(np.log(tol) / np.log(r))) if r > tol else 64
    k = ((max(k, 64) + 127) // 128) * 128
    return k if k <= cap else None


def biquad_impulse(coeffs, K: int) -> np.ndarray:
    """f64 impulse response of the DF-I biquad, truncated at K taps.

    Coefficients are first rounded to f32 (the reference stores them as
    float, include/art_biquad.h), then the recurrence runs in f64.
    """
    a0, a1, a2, b1, b2 = (float(np.float32(c)) for c in np.asarray(coeffs).reshape(-1)[:5])
    h = np.zeros(K, np.float64)
    x1 = x2 = y1 = y2 = 0.0
    xin = 1.0
    for i in range(K):
        y = a0 * xin + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
        h[i] = y
        x2, x1, xin = x1, xin, 0.0
        y2, y1 = y1, y
    return h


def fold_biquad_into_filterbank(filters_np, coeffs, fir_len: int, *, half: int,
                                stages: int = 2):
    """Compose a pre-filter biquad cascade with the sinc filterbank (LTI).

    ``out[t] = sum_j h[j] x[n-j]`` feeding ``sum_k f[k] x'[win0+k]``
    collapses to ``sum_m g[m] x[win0 - (Lh-1) + m]`` with
    ``g = convolve(f, reversed(h))``, so the polyphase contraction does the
    lowpassing and the biquad stages vanish.

    Returns (folded f32 ``[F+1, taps + Lh - 1]``, direct_row f32 — the mode-0
    "copy" output must itself be lowpassed — and the window-start offset
    Lh - 1 to subtract from win0 / add to the history length).
    """
    h1 = biquad_impulse(coeffs, fir_len)
    h = h1
    for _ in range(stages - 1):
        h = np.convolve(h, h1)
    Lh = len(h)
    rows = np.asarray(filters_np, np.float64)
    folded = np.stack([np.convolve(r, h[::-1]) for r in rows]).astype(np.float32)
    direct = np.zeros(folded.shape[1], np.float32)
    direct[half - 1: half - 1 + Lh] = h[::-1].astype(np.float32)
    return folded, direct, Lh - 1

"""Windowed-sinc filterbank flags, parameter checks and the numpy design.

The resampler's filterbank is designed by the shared native library
(runtime/native.py::design_filterbank_native), bit-for-bit the reference's
``resampleInit``/``init_filter`` (src/resample/art_resampler.cpp:78-139,
:379-419). :func:`design_filterbank` re-derives the same math in vectorized
numpy, a copy of the JAX package's cross-check of the native design.
"""

from __future__ import annotations

import numpy as np

# flag bits, reference include/art_resampler.h:21-23
SUBSAMPLE_INTERPOLATE = 0x1
BLACKMAN_HARRIS = 0x2
INCLUDE_LOWPASS = 0x4

__all__ = ["SUBSAMPLE_INTERPOLATE", "BLACKMAN_HARRIS", "INCLUDE_LOWPASS",
           "design_filterbank", "normalize_lowpass", "validate_params"]


def validate_params(num_taps: int, num_filters: int) -> None:
    """Parameter envelope checks (reference art_resampler.cpp:89-97)."""
    if (num_taps & 3) or num_taps <= 0 or num_taps > 1024:
        raise ValueError("must 4-1024 filter taps, and a multiple of 4!")
    if num_filters < 2 or num_filters > 1024:
        raise ValueError("must be 2-1024 filters!")


def design_filterbank(num_taps: int, num_filters: int, lowpass_ratio: float, flags: int) -> np.ndarray:
    """Build the ``[num_filters + 1, num_taps]`` f32 filterbank.

    ``lowpass_ratio``/``flags`` follow resampleInit's normalization
    (art_resampler.cpp:82-87): a ratio outside (0,1) clears INCLUDE_LOWPASS
    and snaps to 1.0. Callers should pass the already-normalized values via
    :func:`normalize_lowpass`.
    """
    validate_params(num_taps, num_filters)
    f32 = np.float32
    fractions = (np.arange(num_filters + 1, dtype=f32) / f32(num_filters)).astype(f32)  # (float)i / numFilters

    # --- per-tap magnitudes, vectorized over [F+1, taps] ------------------
    # float dist = fabs((numTaps/2 - 1) + fraction - i) * M_PI      (:394)
    base = f32(num_taps // 2 - 1)
    i_taps = np.arange(num_taps, dtype=f32)
    t1 = (base + fractions).astype(f32)[:, None]          # f32 add
    t2 = (t1 - i_taps[None, :]).astype(f32)               # f32 sub
    dist = (np.abs(t2.astype(np.float64)) * np.pi).astype(f32)  # double mul -> float store

    # float ratio = dist / (numTaps / 2)                            (:395)
    ratio = (dist / f32(num_taps // 2)).astype(f32)

    # value = sin(dist*lowpass) / (dist*lowpass)  [f64 sin/div of the f32
    # product], windowed in f64, stored f32                        (:398-406)
    lp = f32(lowpass_ratio)
    prod = (dist * lp).astype(f32)
    prod64 = prod.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        value = (np.sin(prod64) / prod64).astype(f32)

    r64 = ratio.astype(np.float64)
    if flags & BLACKMAN_HARRIS:
        a0, a1, a2, a3 = f32(0.35875), f32(0.48829), f32(0.14128), f32(0.01168)
        two_r = (np.int32(2) * ratio).astype(f32).astype(np.float64)   # 2*ratio in f32
        three_r = (np.int32(3) * ratio).astype(f32).astype(np.float64)  # 3*ratio in f32 (rounds)
        win = np.float64(a0) + np.float64(a1) * np.cos(r64) \
            + np.float64(a2) * np.cos(two_r) + np.float64(a3) * np.cos(three_r)
    else:
        win = np.float64(f32(0.5)) * (np.float64(f32(1.0)) + np.cos(r64))
    value = (value.astype(np.float64) * win).astype(f32)
    value = np.where(dist != f32(0.0), value, f32(1.0))

    # --- sequential f32 sum for unity-DC normalization ---------------------
    # filter_sum += tempFilter[i] = value                           (:408)
    filter_sum = np.add.accumulate(value, axis=1, dtype=f32)[:, -1]

    # --- error-diffusion normalization in ping-pong tap order -------------
    # (art_resampler.cpp:413-418): i starts at taps/2 and bounces outward
    scaler = (f32(1.0) / filter_sum).astype(f32)          # [F+1]
    error = np.zeros(num_filters + 1, f32)
    temp = value.copy()
    out = np.zeros_like(value)
    order = []
    i = num_taps // 2
    while i < num_taps:
        order.append(i)
        i = num_taps - i - (1 if i >= num_taps // 2 else 0)
    for i in order:
        temp[:, i] = (temp[:, i] * scaler).astype(f32)
        out[:, i] = (temp[:, i] - error).astype(f32)
        error = (error + (out[:, i] - temp[:, i]).astype(f32)).astype(f32)
    return out


def normalize_lowpass(lowpass_ratio: float, flags: int) -> tuple[np.float32, int]:
    """resampleInit's flag/lowpass normalization (art_resampler.cpp:82-87)."""
    lowpass_ratio = np.float32(lowpass_ratio)
    if 0.0 < lowpass_ratio < 1.0:
        flags |= INCLUDE_LOWPASS
    else:
        flags &= ~INCLUDE_LOWPASS
        lowpass_ratio = np.float32(1.0)
    return lowpass_ratio, flags

"""Windowed-sinc filterbank flags and parameter checks.

The filterbank itself is designed by the shared native library
(runtime/native.py::design_filterbank_native), bit-for-bit the reference's
``resampleInit``/``init_filter`` (src/resample/art_resampler.cpp:78-139,
:379-419).
"""

from __future__ import annotations

# flag bits, reference include/art_resampler.h:21-23
SUBSAMPLE_INTERPOLATE = 0x1
BLACKMAN_HARRIS = 0x2
INCLUDE_LOWPASS = 0x4

__all__ = ["SUBSAMPLE_INTERPOLATE", "BLACKMAN_HARRIS", "INCLUDE_LOWPASS",
           "validate_params"]


def validate_params(num_taps: int, num_filters: int) -> None:
    """Parameter envelope checks (reference art_resampler.cpp:89-97)."""
    if (num_taps & 3) or num_taps <= 0 or num_taps > 1024:
        raise ValueError("must 4-1024 filter taps, and a multiple of 4!")
    if num_filters < 2 or num_filters > 1024:
        raise ValueError("must be 2-1024 filters!")

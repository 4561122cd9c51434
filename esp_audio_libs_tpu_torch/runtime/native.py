"""ctypes loader for the native host library (libeal_host.so).

The same library the JAX package loads (esp_audio_libs_tpu/runtime/native.py),
built from ``native/`` by ``native/build_host.sh``: filter design with exact
glibc f32 libm semantics and the serial f32 phase-grid recurrence come from
one C++ source for both packages. Only the resampler's four entry points are
bound here. The library is built at first use if it is missing.
"""

from __future__ import annotations

import ctypes as C
import functools
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
LIB_PATH = REPO / "build" / "libeal_host.so"


@functools.lru_cache(None)
def host_lib() -> C.CDLL:
    if not LIB_PATH.exists():
        subprocess.run([str(REPO / "native" / "build_host.sh")], check=True, capture_output=True)
    lib = C.CDLL(str(LIB_PATH))
    f32p = C.POINTER(C.c_float)
    i32p = C.POINTER(C.c_int32)
    i8p = C.POINTER(C.c_int8)
    lib.eal_design_filterbank.restype = C.c_int
    lib.eal_design_filterbank.argtypes = [C.c_int, C.c_int, C.c_float, C.c_int, f32p]
    lib.eal_phase_grid.restype = None
    lib.eal_phase_grid.argtypes = [
        C.c_int, C.c_int, C.c_int, C.c_float,       # config
        C.c_int, C.c_int,                           # chunk
        f32p, i32p,                                 # state io
        i32p, i32p, i32p, f32p, i8p,                # schedule
        i32p, i32p,                                 # results
    ]
    lib.eal_required_samples.restype = C.c_uint
    lib.eal_required_samples.argtypes = [C.c_int, C.c_float, C.c_int, C.c_int, C.c_float]
    lib.eal_expected_output.restype = C.c_uint
    lib.eal_expected_output.argtypes = [C.c_int, C.c_float, C.c_int, C.c_int, C.c_float]
    return lib


def design_filterbank_native(num_taps: int, num_filters: int, lowpass_ratio: float,
                             flags: int) -> np.ndarray:
    """Bit-exact ``[num_filters + 1, num_taps]`` f32 filterbank design."""
    out = np.zeros((num_filters + 1, num_taps), np.float32)
    rc = host_lib().eal_design_filterbank(
        num_taps, num_filters, np.float32(lowpass_ratio), flags,
        out.ctypes.data_as(C.POINTER(C.c_float)))
    if rc == 1:
        raise ValueError("must 4-1024 filter taps, and a multiple of 4!")
    if rc == 2:
        raise ValueError("must be 2-1024 filters!")
    return out

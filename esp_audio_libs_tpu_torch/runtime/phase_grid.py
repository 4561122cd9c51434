"""Resampler phase-grid generation (host control plane).

A jax-free copy of esp_audio_libs_tpu/runtime/phase_grid.py (the JAX
package's ``__init__`` imports jax, so its host modules cannot be imported
here). The f32 phase recurrence runs once per chunk in the shared native
library (native/src/eal_host.cpp); it depends only on (config, counts,
carried phase), never on audio, and emits the dense schedule that the device
contraction (ops/polyphase.py) applies to every stream of a batch.
"""

from __future__ import annotations

import ctypes as C
import dataclasses

import numpy as np

from .native import host_lib

__all__ = ["HISTORY_MARGIN", "PhaseState", "PhaseGrid", "phase_grid",
           "required_samples", "expected_output"]

# History samples the device keeps to the left of each chunk. The emission
# invariant bounds the window reach-back by num_taps + 2; +6 is slack,
# asserted per chunk.
HISTORY_MARGIN = 8

# the dtypes of a grid's win0, idx1, idx2, weight and mode
_DTYPES = (np.int32, np.int32, np.int32, np.float32, np.int8)


@dataclasses.dataclass
class PhaseState:
    """Carried resampler phase (reference Resample.outputOffset/inputIndex,
    include/art_resampler.h:27-29). Shared by all streams in a batch."""

    num_taps: int
    offset: np.float32
    input_index: int

    @classmethod
    def initial(cls, num_taps: int) -> "PhaseState":
        # reference resampleInit: outputOffset = taps/2, inputIndex = taps
        # (art_resampler.cpp:135-136); history implicitly silence.
        return cls(num_taps=num_taps, offset=np.float32(num_taps // 2), input_index=num_taps)

    def advance(self, delta: float) -> None:
        """resampleAdvancePosition (art_resampler.cpp:313-318)."""
        if delta < 0.0:
            raise ValueError("resampleAdvancePosition() can only advance forward!")
        self.offset = np.float32(self.offset + np.float32(delta))

    @property
    def position(self) -> float:
        """resampleGetPosition (art_resampler.cpp:348)."""
        return float(np.float32(self.offset + np.float32(self.num_taps / 2.0) - np.float32(self.input_index)))

    def reset(self) -> None:
        self.offset = np.float32(self.num_taps // 2)
        self.input_index = self.num_taps


@dataclasses.dataclass
class PhaseGrid:
    """Per-output schedule for one chunk (all arrays length output_generated)."""

    input_used: int
    output_generated: int
    win0: np.ndarray    # int32: window start rel. to chunk's first new sample
    idx1: np.ndarray    # int32: filterbank row
    idx2: np.ndarray    # int32: second row (mode 2)
    weight: np.ndarray  # f32: lerp weight (mode 2)
    mode: np.ndarray    # int8: 0 direct, 1 single, 2 lerp


def phase_grid(
    state: PhaseState,
    num_filters: int,
    flags: int,
    ratio: float,
    num_input_frames: int,
    num_output_frames: int,
    out=None,
) -> PhaseGrid:
    """Generate the schedule for one chunk, advancing ``state`` in place.

    ``out``: optional ``(win0, idx1, idx2, weight, mode)`` arrays to write
    the schedule into instead of fresh ones: each contiguous, of length
    ``num_output_frames``, int32, int32, int32, f32 and int8. Entries past
    the generated count are zeroed, as in fresh arrays."""
    n = int(num_output_frames)
    if out is None:
        out = tuple(np.zeros(n, t) for t in _DTYPES)
    elif any(a.dtype != t or a.shape != (n,) or not a.flags.c_contiguous
             for a, t in zip(out, _DTYPES)):
        raise ValueError(f"phase_grid: out must be contiguous {_DTYPES} arrays of length {n}")
    win0, idx1, idx2, weight, mode = out
    off = C.c_float(float(state.offset))
    idx = C.c_int32(state.input_index)
    used = C.c_int32(0)
    gen = C.c_int32(0)
    host_lib().eal_phase_grid(
        state.num_taps, num_filters, flags, np.float32(ratio),
        int(num_input_frames), n,
        C.byref(off), C.byref(idx),
        win0.ctypes.data_as(C.POINTER(C.c_int32)),
        idx1.ctypes.data_as(C.POINTER(C.c_int32)),
        idx2.ctypes.data_as(C.POINTER(C.c_int32)),
        weight.ctypes.data_as(C.POINTER(C.c_float)),
        mode.ctypes.data_as(C.POINTER(C.c_int8)),
        C.byref(used), C.byref(gen),
    )
    state.offset = np.float32(off.value)
    state.input_index = idx.value
    g = gen.value
    for a in out:
        a[g:] = 0
    if g and win0[:g].min() < -(state.num_taps + HISTORY_MARGIN):
        raise AssertionError("phase grid window reached past history margin")
    return PhaseGrid(used.value, g, win0, idx1, idx2, weight, mode)


def required_samples(state: PhaseState, num_output_frames: int, ratio: float) -> int:
    """Dry-run: inputs needed for N outputs (art_resampler.cpp:257-279)."""
    return int(host_lib().eal_required_samples(
        state.num_taps, np.float32(state.offset), state.input_index,
        int(num_output_frames), np.float32(ratio)))


def expected_output(state: PhaseState, num_input_frames: int, ratio: float) -> int:
    """Dry-run: outputs generated from N inputs (art_resampler.cpp:281-306)."""
    return int(host_lib().eal_expected_output(
        state.num_taps, np.float32(state.offset), state.input_index,
        int(num_input_frames), np.float32(ratio)))

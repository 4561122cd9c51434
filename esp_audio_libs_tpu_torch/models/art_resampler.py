"""Batched windowed-sinc resampler: the ART resampler lifted to stream
batches, in PyTorch.

The counterpart of esp_audio_libs_tpu/models/art_resampler.py (reference:
include/art_resampler.h:36-46, src/resample/art_resampler.cpp): the same
filterbank, phase accumulator, ring-buffer timing, dry-run queries and
latency behaviour, but one instance processes ``[..., T]`` batches of
streams, with the control plane on the host (runtime/phase_grid.py) and
all dot products on the device (ops/polyphase.py::polyphase_apply: the
ordered-dot kernel in exact mode, one dense f32 matmul in fast mode).

Carried state per instance:
  * phase (offset, input_index), shared by every stream in the batch, since
    all streams advance in lockstep (same chunk sizes and ratio);
  * ``history`` f32 ``[..., H]`` on the device: the last H = taps + 8 input
    samples per stream (only taps + 2 are ever reachable by a window).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import sinc
from ..ops.polyphase import polyphase_apply
from ..runtime.kernels import entry_device
from ..runtime.native import design_filterbank_native
from ..runtime.phase_grid import (HISTORY_MARGIN, PhaseState, expected_output, phase_grid,
                                  required_samples)

__all__ = ["BatchedResample", "ResampleResult"]


class ResampleResult:
    """Mirror of the reference ResampleResult (include/art_resampler.h:31-33)."""

    def __init__(self, input_used: int, output_generated: int):
        self.input_used = input_used
        self.output_generated = output_generated


def _chunk_kernel(x, hist, filters, win0, idx1, idx2, weight, mode, used: int, *,
                  hist_len: int, half: int, exact: bool, compute_second: bool):
    """One chunk: concatenate the history, apply the schedule, roll the
    history forward to the last consumed sample. Returns (out, new history)."""
    xext = torch.cat([hist, x.to(torch.float32)], dim=-1)
    out = polyphase_apply(xext, filters, win0 + hist_len, idx1, idx2, weight, mode,
                          half=half, exact=exact, compute_second=compute_second)
    return out, xext[..., used:used + hist_len].clone()


class BatchedResample:
    """Batched equivalent of ``resampleInit``/``resampleProcess*``.

    Args:
      batch_shape: leading dims of the stream tensors, e.g. ``(B,)`` or
        ``(B, C)``: channels are just another batch dim here.
      num_taps / num_filters / lowpass_ratio / flags: reference parameters
        (art_resampler.cpp:78-103). Flags: SUBSAMPLE_INTERPOLATE,
        BLACKMAN_HARRIS, INCLUDE_LOWPASS from ops/sinc.py.
      exact: bit-exact ordered dot products, or the dense-matmul fast form.
      dtype: the history's dtype (``torch.float32`` by default), as the JAX
        package's ``dtype`` argument sets it.
      device: ``"cuda"`` (the default: the kernels) or ``"cpu"`` (their
        plain versions); ``"cuda"`` without a card raises.
    """

    def __init__(self, batch_shape, num_taps: int, num_filters: int, lowpass_ratio: float,
                 flags: int, *, exact: bool = True, dtype=torch.float32, device="cuda"):
        lowpass_ratio, flags = sinc.normalize_lowpass(lowpass_ratio, flags)
        sinc.validate_params(num_taps, num_filters)
        self.device = entry_device(device, "BatchedResample")
        self.batch_shape = tuple(batch_shape)
        self.num_taps = num_taps
        self.num_filters = num_filters
        self.lowpass_ratio = lowpass_ratio
        self.flags = int(flags)
        self.exact = exact
        self.hist_len = num_taps + HISTORY_MARGIN
        self.filters = torch.as_tensor(np.asarray(design_filterbank_native(
            num_taps, num_filters, float(lowpass_ratio), self.flags), np.float32),
            device=self.device)
        self.state = PhaseState.initial(num_taps)
        self.history = torch.zeros(self.batch_shape + (self.hist_len,), dtype=dtype,
                                   device=self.device)

    # ------------------------------------------------------------ queries
    def get_required_samples(self, num_output_frames: int, ratio: float) -> int:
        """reference resampleGetRequiredSamples (art_resampler.cpp:257-279)."""
        return required_samples(self.state, num_output_frames, ratio)

    def get_expected_output(self, num_input_frames: int, ratio: float) -> int:
        """reference resampleGetExpectedOutput (art_resampler.cpp:281-306)."""
        return expected_output(self.state, num_input_frames, ratio)

    def advance_position(self, delta: float) -> None:
        """reference resampleAdvancePosition (art_resampler.cpp:313-318)."""
        self.state.advance(delta)

    def get_position(self) -> float:
        """reference resampleGetPosition (art_resampler.cpp:348)."""
        return self.state.position

    def reset(self) -> None:
        """reference resampleReset (art_resampler.cpp:144-152)."""
        self.state.reset()
        self.history = torch.zeros_like(self.history)

    # ------------------------------------------------------------ process
    def process(self, x, num_output_frames: int, ratio: float):
        """Resample a chunk.

        Args:
          x: f32 ``batch_shape + (n_in,)`` new input samples per stream
            (a tensor, or numpy: copied to the instance's device).
          num_output_frames: max outputs to generate (space available).
          ratio: output/input rate ratio (the reference passes it per call).

        Returns: (out ``batch_shape + (generated,)``, ResampleResult).
        Samples beyond ``result.input_used`` were not consumed; the caller
        resends them (the reference's contract).
        """
        x = torch.as_tensor(x, device=self.device)
        if tuple(x.shape[: len(self.batch_shape)]) != self.batch_shape:
            raise ValueError(f"expected batch shape {self.batch_shape}, got {tuple(x.shape)}")
        n_in = x.shape[-1]
        # the schedule computes on a scratch phase, committed only after the
        # kernel call was issued: phase_grid advances its state in place, and
        # a failed call must leave self.state aligned with self.history
        state = dataclasses.replace(self.state)
        grid = phase_grid(state, self.num_filters, self.flags, ratio, n_in, num_output_frames)
        gi = torch.as_tensor(np.stack([grid.win0, grid.idx1, grid.idx2,
                                       grid.mode.astype(np.int32)]), device=self.device)
        weight = torch.as_tensor(grid.weight, device=self.device)
        out, self.history = _chunk_kernel(
            x, self.history, self.filters, gi[0], gi[1], gi[2], weight, gi[3], grid.input_used,
            hist_len=self.hist_len, half=self.num_taps // 2, exact=self.exact,
            compute_second=bool(self.flags & sinc.SUBSAMPLE_INTERPOLATE))
        self.state = state
        return out[..., : grid.output_generated], ResampleResult(grid.input_used,
                                                                grid.output_generated)

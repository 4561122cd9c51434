"""Driver of the cells that time the fast tier of ``Resampler.resample_stream``
(``exact=False``: the pre-filter folded into the filterbank, the weight tiles
built on the device, the banded contraction on the tensor cores).

The set-up, the window and the drawn calls are those of
``resample_stream.py``: this driver runs that module's ``drive`` from a
private copy of it, with this file's cell, launch counter and check in place
of the exact ones.

What is checked, once the window has closed and the program is freed (the
traffic's ``check`` numbers, as there): the first ``setup_calls`` set-up
calls, the reference chaining its own state from the zero state, and
``window_calls`` calls of the window drawn from the seed. The reference's
state before a window call is its own zero state run over the last chunk of
the call before, with the program's phase: its biquads and history forget
the zero start within a few hundred samples. The compared numbers, with
their limits from the configuration's ``limits``:

* ``max_output_gap_lsb``: the largest |program - reference| over the kept
  calls' PCM; a chunk whose generated count differs counts 65535;
* ``differing_state_words``: after the first set-up call, the f32 words of
  the program's carried history that differ from its input times the 0 dB
  gain factor (the tier carries its input unfiltered, the pre-filter being
  folded into the filterbank), and the phase against the reference's;
* ``clip_count_excess``: per stream and chunk, the amount by which the clip
  counts differ beyond the reference's samples at the four codes before the
  clip that a 1-LSB gap can carry across the threshold, summed.

With ``spec.control`` the reference in that precision stands in the
program's place: its outputs, its clip counts, its phase, and as its
history its input rounded to that precision, as it computes with it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from perfbench import banded_work, harness, yardstick

_loop = harness.load_module(harness.ROOT / "drivers" / "resample_stream.py",
                            "perfbench_resample_fast_loop")

KERNELS = {"polyphase_banded": ("polyphase_banded_kernel", "band_ranges_kernel")}
EDGE_CODES = (32767.0, 32768.0, -32768.0, -32769.0)
GAIN_0DB = np.float32(1.0) / np.float32(32768.0)     # quantization_utils.cpp at 16 bits


def launch_counts() -> dict:
    """The program's own launch counter of the banded contraction's wrapper."""
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels
    return {"polyphase_banded": polyphase_kernels.polyphase_banded_cuda.launches}


class Cell(_loop.Cell):
    def __init__(self, spec: harness.Spec):
        if spec.config["resampler"]["exact"]:
            raise ValueError("resample_fast drives the fast tier: the configuration's exact "
                             "must be false")
        if os.environ.get("EAL_RESAMPLE_FUSED16", "") in ("1", "true"):
            raise ValueError("EAL_RESAMPLE_FUSED16 selects the fused int16 tier; this "
                             "configuration runs the f32 fast tier")
        super().__init__(spec)

    def state(self):
        st = self.res.get_state()
        return {"history": st["history"][self.check_streams],
                "phase": (np.float32(st["phase_offset"]), int(st["phase_input_index"]))}

    def launches(self, gens_per_call):
        """(bytes, operations, peak) of every banded contraction the calls
        launched, one a chunk (downsampling: no post-filter conv), over the
        slab, weight tiles and output width the program launches with; none
        where the program does not expose that geometry."""
        res = self.res
        try:
            K, taps_p, L = res._K, res._taps_p, res._slab_len(self.cf)
        except AttributeError:
            return {"polyphase_banded": []}
        M, T = self.B * self.ch, self.out_max
        nt = -(-T // banded_work.TILE)
        return {"polyphase_banded": [
            banded_work.polyphase_banded_work(M, L, nt, nt, K, T, gen, taps_p)
            + (yardstick.PEAK_FP32,) for gens in gens_per_call for gen in gens]}


def drive(spec: harness.Spec) -> harness.Record:
    _loop.Cell, _loop.KERNELS = Cell, KERNELS
    _loop.launch_counts, _loop.check = launch_counts, check
    return _loop.drive(spec)


@contextlib.contextmanager
def _edge_counts(ref, sink: list):
    """While open, each ``quantize16`` of the reference appends to ``sink``
    per row the count of its samples whose code before the clip
    (floorf(y * 32768 + 0.5), as the reference computes it) is one of
    ``EDGE_CODES``."""
    quantize16 = ref.quantize16

    def counting(y):
        f32 = np.float32
        code = np.floor((y.astype(f32) * f32(32768.0)).astype(f32) + f32(0.5))
        sink.append(np.isin(code, EDGE_CODES).sum(-1))
        return quantize16(y)

    ref.quantize16 = counting
    try:
        yield
    finally:
        ref.quantize16 = quantize16


def _warm_state(ref, d, pcm_before, phase, cell, precision, device):
    """The reference's state before a window call: its zero state run over
    the last chunk of the call before, then the program's phase."""
    st = ref.State.zero(d, pcm_before.shape[0], cell.ch)
    st.phase = ref.Phase(*phase)
    last = np.ascontiguousarray(pcm_before[:, -cell.cf * cell.ch:])
    warm = ref.resample_call(d, st, last, cell.cf, 1, cell.ch, precision=precision,
                             device=device)[3]
    warm.phase = ref.Phase(*phase)
    return warm


def check(spec: harness.Spec, cell: Cell, state_after_1) -> dict:
    """Hold the kept calls to the reference (module docstring); returns the
    compared numbers with their limits."""
    # the reference's f32 on the card is IEEE f32, also in any matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, lim = spec.reference, spec.config["limits"]
    d = ref.design(spec.config["resampler"], cell.src, cell.dst)
    S, ch = len(cell.check_streams), cell.ch
    sel = torch.as_tensor(cell.check_streams, device=cell.pool[0].device)

    def pcm_of(i):
        return cell.pool[i % len(cell.pool)][sel].cpu().numpy().view(np.int16)

    gap = excess = state_words = at_one = compared = 0
    chained, control_chained = ref.State.zero(d, S, ch), ref.State.zero(d, S, ch)
    for label in sorted(cell.kept, key=lambda k: cell.kept[k][1]):
        start, i, out, gens, clips = cell.kept[label]
        pcm = pcm_of(i)
        if start is None:
            st, cst = chained, control_chained
        else:
            st = _warm_state(ref, d, pcm_of(i - 1), start["phase"], cell, "float32",
                             spec.device)
            if spec.control:
                cst = _warm_state(ref, d, pcm_of(i - 1), start["phase"], cell, spec.control,
                                  spec.device)
        edges = []
        with _edge_counts(ref, edges):
            r_out, r_clip, r_gen, r_state, _ = ref.resample_call(d, st, pcm, cell.cf, cell.nc,
                                                                 ch, device=spec.device)
        if start is None:
            chained = r_state
        prog_state = state_after_1
        if spec.control:
            out, clips, gens, cst_new = _loop._as_program(ref, d, cst, pcm, cell, spec)
            prog_state = {"history": ref.Arith(spec.control, False).r(
                              _input_history(pcm, state_after_1, ch)),
                          "phase": (cst_new.phase.offset, cst_new.phase.input_index)}
            if start is None:
                control_chained = cst_new
        for c in range(cell.nc):
            if gens[c] != r_gen[c]:
                gap = 65535
                continue
            n = gens[c]
            prog = out[c][:, :n * ch * 2].view(np.int16).reshape(S, n, ch).astype(np.int64)
            diff = np.abs(prog - r_out[c].astype(np.int64))
            gap = max(gap, int(diff.max(initial=0)))
            at_one += int((diff == 1).sum())
            compared += diff.size
            edge = edges[c].reshape(S, ch).sum(1)
            clip_gap = np.abs(np.asarray(clips[c], np.int64) - np.asarray(r_clip[c], np.int64))
            excess += int(np.maximum(clip_gap - edge, 0).sum())
        if label == "setup_1":
            state_words = _state_words(prog_state, _input_history(pcm, state_after_1, ch),
                                       r_state.phase)
    print(f"perfbench: samples 1 LSB from the reference: {at_one} of {compared}",
          file=spec.log)
    return {"max_output_gap_lsb": (gap, lim["max_output_gap_lsb"]),
            "differing_state_words": (state_words, lim["differing_state_words"]),
            "clip_count_excess": (excess, lim["clip_count_excess"])}


def _input_history(pcm, state_after_1, ch: int) -> np.ndarray:
    """f32 [S, ch, H]: the last H input frames of a call from the zero
    state (zeros before its first) times the 0 dB gain factor, H the
    program's history length."""
    H = state_after_1["history"].shape[-1]
    x = pcm.reshape(pcm.shape[0], -1, ch)
    x = np.concatenate([np.zeros_like(x[:, :H]), x], 1)[:, -H:, :].transpose(0, 2, 1)
    return x.astype(np.float32) * GAIN_0DB


def _state_words(prog: dict, want_history, want_phase) -> int:
    """f32 words of the history and the phase that differ in their bits."""
    def words(a):
        return np.ascontiguousarray(a, np.float32).view(np.uint32)

    n = int((words(prog["history"]) != words(want_history)).sum())
    n += int(np.float32(prog["phase"][0]) != want_phase.offset)
    n += int(prog["phase"][1] != want_phase.input_index)
    return n

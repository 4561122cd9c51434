"""The port's fast resampler tier against the benchmark's plain reference of
the exact chain (``perfbench/configs/art_resampler_ref.py``, NumPy and
PyTorch, no JAX), on the CPU at a small size: 4 stereo streams, two calls of
2 x 1024 frames, 44.1 -> 16 kHz, one stream hot enough to clip.

The tier promises every output within 1 LSB of the exact order, the same
generated counts, and a carried state that is exact: its history is its
input times the gain factor (the pre-filter is folded into the filterbank),
its phase host arithmetic. A planted fault that rounds the contraction's
operands to TF32, one pass, has to break the 1-LSB limit: the limit catches
a precision below the tier's."""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.models import resampler as resampler_module
from esp_audio_libs_tpu_torch.ops.polyphase import polyphase_banded

REF_PATH = Path(__file__).resolve().parents[1] / "perfbench" / "configs" / "art_resampler_ref.py"
STREAMS, CH, FRAMES, CHUNKS, CALLS = 4, 2, 1024, 2, 2
CONFIG = {"number_of_taps": 64, "number_of_filters": 32, "subsample_interpolate": True,
          "use_pre_or_post_filter": True}
GAIN_0DB = np.float32(1.0) / np.float32(32768.0)


@functools.lru_cache(None)
def _ref():
    spec = importlib.util.spec_from_file_location("art_resampler_ref_for_tests", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _pcm() -> np.ndarray:
    """int16 [STREAMS, CALLS * CHUNKS * FRAMES * CH]: per stream and channel
    three tones over noise; stream 0 raised by 18 dB so that it clips."""
    rng = np.random.default_rng(20240)
    n = CALLS * CHUNKS * FRAMES
    t = np.arange(n)
    freq = np.exp(rng.uniform(np.log(40.0), np.log(16000.0), (STREAMS, CH, 3, 1))) / 44100.0
    amp = 10.0 ** (rng.uniform(-45, -15, (STREAMS, CH, 3, 1)) / 20.0)
    x = (amp * np.sin(2 * np.pi * (freq * t + rng.uniform(0, 1, (STREAMS, CH, 3, 1))))).sum(2)
    x += 10.0 ** (-50 / 20.0) * rng.standard_normal(x.shape)
    x[0] *= 10.0 ** (18 / 20.0)
    x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(STREAMS, -1)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, ties away from zero), as
    ``cvt.rna.tf32.f32`` rounds."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _one_pass_tf32(xext, Wt, starts, *, T):
    return polyphase_banded(_tf32(xext), _tf32(Wt), starts, T=T)


@functools.lru_cache(None)
def _compare(fault: str):
    """Run the port's fast tier (with ``fault`` planted) and the reference
    chained from the zero state over the same calls; returns (largest
    output gap in LSB, generated counts equal, history words that differ,
    phase words that differ)."""
    ref = _ref()
    pcm = _pcm()
    mp = pytest.MonkeyPatch()
    if fault == "one_pass_tf32":
        mp.setattr(resampler_module, "polyphase_banded_cuda", _one_pass_tf32)
    try:
        res = Resampler(STREAMS, exact=False, device="cpu")
        res.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, CH, True, True, 64, 32))
        d = ref.design(CONFIG, 44100.0, 16000.0)
        st = ref.State.zero(d, STREAMS, CH)
        gap, gens_equal = 0, True
        per_call = CHUNKS * FRAMES * CH
        for k in range(CALLS):
            call = np.ascontiguousarray(pcm[:, k * per_call:(k + 1) * per_call])
            out, gens, _ = res.resample_stream(call.view(np.uint8), FRAMES, CHUNKS)
            r_out, _, r_gen, st, _ = ref.resample_call(d, st, call, FRAMES, CHUNKS, CH)
            gens_equal &= list(gens) == list(r_gen)
            for c, n in enumerate(gens):
                got = out[c].numpy()[:, :n * CH * 2].view(np.int16).reshape(STREAMS, n, CH)
                gap = max(gap, int(np.abs(got.astype(np.int64) - r_out[c]).max()))
        state = res.get_state()
    finally:
        mp.undo()
    H = state["history"].shape[-1]
    want = (pcm.reshape(STREAMS, -1, CH)[:, -H:, :].transpose(0, 2, 1).astype(np.float32)
            * GAIN_0DB)
    hist_words = int((np.ascontiguousarray(state["history"], np.float32).view(np.uint32)
                      != want.view(np.uint32)).sum())
    phase_words = (int(np.float32(state["phase_offset"]) != st.phase.offset)
                   + int(state["phase_input_index"] != st.phase.input_index))
    return gap, gens_equal, hist_words, phase_words


def test_input_clips():
    """The hot stream reaches past full scale, so the quantizer clips."""
    assert np.abs(_pcm()[0].astype(np.int64)).max() >= 32767


@pytest.mark.parametrize("fault, within_1_lsb", [("none", True), ("one_pass_tf32", False)])
def test_fast_tier_within_1_lsb_of_the_reference(fault, within_1_lsb):
    gap, gens_equal, hist_words, phase_words = _compare(fault)
    assert (gap <= 1) is within_1_lsb, gap
    assert gens_equal
    assert hist_words == 0 and phase_words == 0

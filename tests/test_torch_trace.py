"""The port's spans (``runtime/trace.py``): a shared no-op with no profiler
running, and under a CPU ``torch.profiler.profile`` the layer spans of the
exact resampler and of its fast tier, each nested in time inside its call's
span, with the schedule built at the head of a shape's first two calls and
taken over from the call before from the third on."""

import functools

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.runtime import trace

FRAMES, CHUNKS = 256, 3
RATES = {"down": (44100.0, 16000.0), "up": (16000.0, 44100.0)}


def _resampler(direction: str, exact: bool = True) -> Resampler:
    r = Resampler(4, exact=exact, device="cpu")
    r.initialize(ResamplerConfiguration(*RATES[direction], 16, 16, 2, True, True, 64, 32))
    return r


def _pcm(frames: int) -> np.ndarray:
    pcm = np.random.default_rng(7).integers(-32768, 32768, (4, frames * 2)).astype(np.int16)
    return pcm.view(np.uint8).reshape(4, -1)


def test_span_without_profiler_is_one_shared_noop(monkeypatch):
    """With no profiler, every span is the same object and no
    ``record_function`` is built, also along a whole call."""
    def boom(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    first = trace.span("eal.a")
    assert trace.span("eal.b") is first
    with first as entered:
        assert entered is first
    _resampler("down").resample_stream(_pcm(FRAMES * CHUNKS), FRAMES, CHUNKS)


@functools.lru_cache(None)
def _traced(direction: str, method: str, exact: bool = True, calls_before: int = 0):
    """The host events ``(start_ns, end_ns, name)`` of one traced call, made
    after ``calls_before`` untraced calls of the same shape."""
    r = _resampler(direction, exact)
    data = _pcm(FRAMES * CHUNKS)
    for _ in range(calls_before):
        r.resample_stream(data, FRAMES, CHUNKS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if method == "resample_stream":
            r.resample_stream(data, FRAMES, CHUNKS)
        else:
            r.resample(data, FRAMES, FRAMES)
    return [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()), e.name())
            for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("name, per_call, per_chunk", [
    ("eal.schedule", 1, 0), ("eal.unpack", 0, 1), ("eal.biquad", 0, 1),
    ("eal.polyphase", 0, 1), ("eal.quantize", 0, 1), ("eal.launch", 0, 0)])
@pytest.mark.parametrize("method", ["resample_stream", "resample"])
@pytest.mark.parametrize("direction", ["down", "up"])
def test_call_emits_layer_spans_inside_its_span(direction, method, name, per_call, per_chunk):
    """One call span (``eal.<method>``) holds ``per_call`` + ``per_chunk``
    per chunk of the spans ``name``; the plain kernels launch nothing."""
    _assert_spans(_traced(direction, method), method, name, per_call, per_chunk)


@pytest.mark.parametrize("name, per_chunk", [
    ("eal.weights", {"down": 1, "up": 1}), ("eal.polyphase", {"down": 1, "up": 1}),
    ("eal.post", {"down": 0, "up": 1}), ("eal.unpack", {"down": 1, "up": 1}),
    ("eal.quantize", {"down": 1, "up": 1}), ("eal.biquad", {"down": 0, "up": 0})])
@pytest.mark.parametrize("method", ["resample_stream", "resample"])
@pytest.mark.parametrize("direction", ["down", "up"])
def test_fast_call_emits_layer_spans_inside_its_span(direction, method, name, per_chunk):
    """The fast tier's call span holds, per chunk, one weight build and one
    banded contraction, the post-filter conv only when upsampling, and no
    biquad (its filters are folded into the banded weights)."""
    _assert_spans(_traced(direction, method, exact=False), method, name, 0, per_chunk[direction])


@pytest.mark.parametrize("calls_before, builds, hits", [(1, 2, 0), (2, 1, 1), (4, 1, 1)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("direction", ["down", "up"])
def test_stream_call_takes_over_the_schedule_built_before(direction, exact, calls_before,
                                                          builds, hits):
    """The second call of a shape builds its schedule at its head and the
    next call's at its tail: two ``eal.schedule``, no hit. Each later call
    takes its schedule over at its head (``eal.schedule.hit``, before the
    first chunk) and builds the next one after its last chunk. All inside
    the call span."""
    events = _traced(direction, "resample_stream", exact, calls_before)
    _assert_spans(events, "resample_stream", "eal.schedule", builds, 0)
    _assert_spans(events, "resample_stream", "eal.schedule.hit", hits, 0)
    chunk_spans = [s for s, _, n in events if n in ("eal.unpack", "eal.quantize")]
    tail = max(s for s, _, n in events if n == "eal.schedule")
    assert tail > max(chunk_spans)
    if hits:
        (head, _, _), = [e for e in events if e[2] == "eal.schedule.hit"]
        assert head < min(chunk_spans)


def _assert_spans(events, method: str, name: str, per_call: int, per_chunk: int) -> None:
    calls = [e for e in events if e[2] == f"eal.{method}"]
    assert len(calls) == 1
    (cs, ce, _), = calls
    chunks = CHUNKS if method == "resample_stream" else 1
    spans = [e for e in events if e[2] == name]
    assert len(spans) == per_call + per_chunk * chunks
    assert all(cs <= s and e <= ce for s, e, _ in spans)

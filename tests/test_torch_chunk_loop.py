"""The resampler's chunk path (``models/resampler.py``): both entry points,
``resample_stream`` and ``resample``, run one chunk loop
(``Resampler._run_chunks``), and every history carry of every tier goes
through one helper (``Resampler._carry``)."""

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration

torch.set_num_threads(2)

B, FRAMES, CHUNKS = 4, 256, 3
RATES = {"down": (44100.0, 16000.0), "up": (16000.0, 44100.0)}
CASES = [("resample_stream", "down", "exact"), ("resample_stream", "up", "exact"),
         ("resample_stream", "down", "fast"), ("resample_stream", "up", "fast"),
         ("resample_stream", "down", "fused"),
         ("resample", "down", "exact"), ("resample", "up", "exact"),
         ("resample", "down", "fast"), ("resample", "up", "fast"),
         # the fused tier on: resample() still takes the f32 body
         ("resample", "down", "fused")]


@pytest.mark.parametrize("entry, direction, tier", CASES)
def test_one_loop_and_one_extend_per_chunk(entry, direction, tier, monkeypatch):
    """Each call enters the chunk loop once, with all its chunks. The
    history carry runs once per chunk, plus once per chunk for the fast
    tier's upsampling post-filter conv; it carries raw int16 in the fused
    tier of ``resample_stream`` and f32 everywhere else."""
    if tier == "fused":
        monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    r = Resampler(B, exact=tier == "exact", device="cpu")
    r.initialize(ResamplerConfiguration(*RATES[direction], 16, 16, 2, True, True, 64, 32))
    loops, carried = [], []
    run, carry = r._run_chunks, Resampler._carry
    monkeypatch.setattr(r, "_run_chunks",
                        lambda chunks, *a, **k: loops.append(len(chunks)) or run(chunks, *a, **k))
    monkeypatch.setattr(Resampler, "_carry", staticmethod(
        lambda xext, *a: carried.append(xext.dtype) or carry(xext, *a)))

    stream = entry == "resample_stream"
    chunks = CHUNKS if stream else 1
    per_chunk = 2 if tier == "fast" and direction == "up" else 1
    assert r.post_filter == (direction == "up")
    rng = np.random.default_rng(5)
    for call in range(1, 3):
        pcm = rng.integers(-20000, 20000, (B, FRAMES * chunks * 2)).astype(np.int16)
        data = pcm.view(np.uint8).reshape(B, -1)
        if stream:
            r.resample_stream(data, FRAMES, CHUNKS)
        else:
            r.resample(data, FRAMES, int(FRAMES * float(r.sample_ratio) * 0.8))
        assert loops == [chunks] * call
        assert len(carried) == call * chunks * per_chunk
    want = torch.int16 if stream and tier == "fused" else torch.float32
    assert set(carried) == {want}

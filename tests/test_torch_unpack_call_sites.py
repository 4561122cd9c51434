"""Where the resampler's chunk bodies take the unpack-gain-extend kernel
(``ops/quantization_kernels.py::unpack16_extend_cuda``).

Stereo s16 input goes through the wrapper once a chunk, in one helper
(``Resampler._unpack``) that the bodies share: the exact tier without a
pre-filter and the fast tier get the whole slab, history in front and (fast)
padded to the slab's length; the exact tier with a pre-filter gets the
chunk's frames alone (H = 0), since the biquads run before the extend.
Other formats (mono, 24-bit) keep the torch ops and never call it. On the
CPU the wrapper runs its plain version, and the outputs, clip counts and
carried state equal those of the parent's chain of torch ops (unpack,
``int_to_float``, then ``Resampler._extend``), under both entry points.
"""

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.models import resampler as rs
from esp_audio_libs_tpu_torch.ops import quantization as q
from esp_audio_libs_tpu_torch.runtime import kernels

torch.set_num_threads(2)

B, FRAMES, CHUNKS = 3, 200, 3
RATES = {"down": (44100.0, 16000.0), "up": (16000.0, 44100.0)}
# (tier, direction): the body and whether a pre-filter runs before the extend
BODIES = [("exact", "up"), ("exact", "down"), ("fast", "down"), ("fast", "up")]
ENTRIES = ["resample_stream", "resample"]


def make(tier, direction, channels=2, bits=16):
    r = Resampler(B, exact=tier == "exact", device="cpu")
    r.initialize(ResamplerConfiguration(*RATES[direction], bits, 16, channels, True, True,
                                        64, 32))
    return r


def pcm_bytes(rng, channels, bits, frames):
    nbytes = q.bytes_per_sample(bits)
    return rng.integers(0, 256, (B, frames * channels * nbytes), dtype=np.uint8)


def run(r, entry, data, gain_db):
    """One call of ``entry``: (packed bytes, generated counts, clip counts)."""
    if entry == "resample_stream":
        packed, gens, clips = r.resample_stream(data, FRAMES, CHUNKS, gain_db)
        return packed, list(gens), clips
    packed, res = r.resample(data, FRAMES, int(FRAMES * float(r.sample_ratio)) + 8, gain_db)
    return packed, [res.frames_generated, res.frames_used], res.clipped_samples


def spy(monkeypatch):
    """Record (H, L) of every call of the wrapper the resampler makes."""
    calls, real = [], rs.unpack16_extend_cuda

    def wrapper(data, frames, factor, hist=None, length=None):
        out = real(data, frames, factor, hist, length)
        calls.append((0 if hist is None else hist.shape[2], out.shape[2]))
        return out
    monkeypatch.setattr(rs, "unpack16_extend_cuda", wrapper)
    return calls


def parent_unpack(self, data, factor, frames, hist=None, start=0, length=None):
    """The parent's unpack of stereo s16, as torch ops, then its extend."""
    x = q.int_to_float(q.unpack_pcm16_planar2(data), factor)
    return x if hist is None else self._extend(hist, x, start, length)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("tier, direction", BODIES)
def test_stereo_s16_unpacks_once_a_chunk(tier, direction, entry, monkeypatch):
    calls = spy(monkeypatch)
    r = make(tier, direction)
    chunks = CHUNKS if entry == "resample_stream" else 1
    data = pcm_bytes(np.random.default_rng(1), 2, 16, FRAMES * CHUNKS)
    for call in range(1, 3):
        run(r, entry, data, 0.0)
        assert len(calls) == call * chunks
    H = r.hist_len
    if tier == "exact" and r.pre_filter:
        want = (0, FRAMES)                       # unpacked alone: the biquads come next
    elif tier == "exact":
        want = (H, H + FRAMES)                   # the whole slab, unpadded
    else:
        want = (H, r._slab_len(FRAMES))          # the whole slab, padded
    assert set(calls) == {want}


@pytest.mark.parametrize("channels, bits", [(1, 16), (2, 24)])
@pytest.mark.parametrize("tier, direction", BODIES)
def test_other_formats_keep_the_torch_ops(tier, direction, channels, bits, monkeypatch):
    calls = spy(monkeypatch)
    r = make(tier, direction, channels, bits)
    data = np.random.default_rng(2).integers(
        0, 256, (B, FRAMES * CHUNKS * channels * q.bytes_per_sample(bits)), dtype=np.uint8)
    r.resample_stream(data, FRAMES, CHUNKS)
    r.resample(data, FRAMES, int(FRAMES * float(r.sample_ratio)) + 8)
    assert calls == []


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("tier, direction", BODIES)
def test_outputs_and_state_equal_the_parent_chain(tier, direction, entry, monkeypatch):
    """Three calls with gains of 0, -6.02 and +12 dB: bytes, generated
    counts, clip counts and every word of the carried state as the parent's
    torch ops give them."""
    rng = np.random.default_rng(3)
    calls = [pcm_bytes(rng, 2, 16, FRAMES * CHUNKS) for _ in range(3)]
    new, old = make(tier, direction), make(tier, direction)
    got = [run(new, entry, d, g) for d, g in zip(calls, (0.0, -6.02, 12.0))]
    monkeypatch.setattr(Resampler, "_unpack", parent_unpack)
    want = [run(old, entry, d, g) for d, g in zip(calls, (0.0, -6.02, 12.0))]
    for (pg, gg, cg), (pw, gw, cw) in zip(got, want):
        assert gg == gw and torch.equal(pg, pw)
        np.testing.assert_array_equal(cg, cw)
    a, b = new.get_state(), old.get_state()
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(np.atleast_1d(a[k]), np.atleast_1d(b[k])):
            assert np.array_equal(np.asarray(x, np.float32).view(np.uint32),
                                  np.asarray(y, np.float32).view(np.uint32)), k


def test_glue_reader_counts_the_kernel_as_a_hand_kernel():
    """perfbench's glue reader takes every __global__ of csrc/*.cu for a hand
    kernel, so the unpack kernel's time leaves ``glue_ms_per_call``."""
    from perfbench import yardstick
    hand = yardstick.hand_kernels(kernels.CSRC)
    assert "unpack16_extend_kernel" in hand
    assert yardstick.is_hand("(anonymous namespace)::unpack16_extend_kernel(unsigned char "
                             "const*, long long, int, float)", hand)

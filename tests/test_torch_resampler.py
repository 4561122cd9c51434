"""Port parity, the slice as a whole: the PyTorch fast-mode Resampler against
the JAX fast-mode Resampler on the CPU, on the same numpy inputs.

Tolerances: packed s16 within 1 LSB (the fast path's contract: the f32
contraction sums in another order, so a value on a rounding boundary may
land on either side); generated counts and phase state equal; carried
history bit-exact (it is sliced input, not contraction output); the
post-filter tail within rtol 2e-6 (it is contraction output).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, FRAMES, CHUNKS, FILTERS = 4, 1024, 3, 32


def _pair(src, dst, ch, taps, bits=(16, 16)):
    args = (src, dst, bits[0], bits[1], ch, True, True, taps, FILTERS)
    j = JaxResampler(batch=B, exact=False)
    j.initialize(JaxConfig(*args))
    t = Resampler(batch=B, exact=False, device="cpu")
    t.initialize(ResamplerConfiguration(*args))
    return j, t


def _pcm(seed, n_frames, ch, scale=32768):
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-scale, scale, (B, n_frames * ch)).astype(np.int16)
    return pcm.view(np.uint8).reshape(B, -1)


def _assert_s16_close(packed_j, packed_t):
    a = np.asarray(packed_j).view(np.int16).astype(np.int32)
    b = packed_t.cpu().numpy().view(np.int16).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1
    return int((d > 0).sum())


def _assert_state_equal(j, t):
    sj, st = j.get_state(), t.get_state()
    assert set(sj) == set(st)
    assert sj["phase_offset"].view(np.uint32) == st["phase_offset"].view(np.uint32)
    assert sj["phase_input_index"] == st["phase_input_index"]
    assert st["history"].dtype == np.float32
    np.testing.assert_array_equal(sj["history"], st["history"])
    assert sj["hist_gain_zero"] == st["hist_gain_zero"]
    if "post_hist" in sj:
        np.testing.assert_allclose(st["post_hist"], sj["post_hist"], rtol=2e-6, atol=1e-7)
    if "biquad" in sj:
        for stage_j, stage_t in zip(sj["biquad"], st["biquad"]):
            for a, b in zip(stage_j, stage_t):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("taps", [16, 64])
@pytest.mark.parametrize("src,dst,ch", [
    (44100.0, 16000.0, 2), (44100.0, 16000.0, 1), (16000.0, 44100.0, 2)])
def test_resample_stream_matches_jax(src, dst, ch, taps):
    j, t = _pair(src, dst, ch, taps)
    assert (t.pre_filter, t.post_filter, t.hist_len) == (j.pre_filter, j.post_filter, j.hist_len)
    data = _pcm(taps + ch, FRAMES * CHUNKS, ch)
    for call in range(2):   # a second call continues from the carried state
        pj, gj, cj = j.resample_stream(data, FRAMES, CHUNKS)
        pt, gt, ct = t.resample_stream(torch.from_numpy(data), FRAMES, CHUNKS)
        assert list(gj) == list(gt)
        assert pt.dtype == torch.uint8 and ct.dtype == np.uint32
        ndiff = _assert_s16_close(pj, pt)
        # a clip decision can differ only where a sample differs
        assert np.abs(np.asarray(cj).astype(np.int64) - ct.astype(np.int64)).sum() <= ndiff
        _assert_state_equal(j, t)


def test_resample_per_call_matches_jax():
    j, t = _pair(44100.0, 16000.0, 2, 64)
    data = _pcm(1, 900, 2)
    out_free = 300
    for frames_avail in (900, 517, 64, 900):
        pj, rj = j.resample(data, frames_avail, out_free)
        pt, rt = t.resample(data, frames_avail, out_free)
        assert (rt.frames_used, rt.frames_generated, rt.predicted_frames_used) == \
            (rj.frames_used, rj.frames_generated, rj.predicted_frames_used)
        assert rt.clipped_samples.dtype == np.uint32
        ndiff = _assert_s16_close(pj, pt)
        assert np.abs(rj.clipped_samples.astype(np.int64)
                      - rt.clipped_samples.astype(np.int64)).sum() <= ndiff
        _assert_state_equal(j, t)


def test_resample_upsample_per_call_matches_jax():
    j, t = _pair(16000.0, 44100.0, 1, 16)
    data = _pcm(2, 400, 1)
    for _ in range(3):
        pj, rj = j.resample(data, 400, 1200)
        pt, rt = t.resample(data, 400, 1200)
        assert (rt.frames_used, rt.frames_generated) == (rj.frames_used, rj.frames_generated)
        _assert_s16_close(pj, pt)
        _assert_state_equal(j, t)


@pytest.mark.parametrize("bits", [(16, 16), (24, 16), (16, 8), (32, 24)])
def test_passthrough_matches_jax(bits):
    j, t = _pair(44100.0, 44100.0, 2, 64, bits=bits)
    rng = np.random.default_rng(bits[0] + bits[1])
    data = rng.integers(0, 256, (B, 500 * 2 * (bits[0] // 8)), dtype=np.uint8)
    for gain in (0.0, 6.0):
        pj, rj = j.resample(data, 500, 400, gain_db=gain)
        pt, rt = t.resample(data, 500, 400, gain_db=gain)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(rt.clipped_samples, rj.clipped_samples)
        assert rt.frames_used == rj.frames_used == 400


@pytest.mark.parametrize("ch", [1, 2])
def test_fused_tier_matches_jax_fast_stream(monkeypatch, ch):
    """With EAL_RESAMPLE_FUSED16=1 the port's stream runs the fused int16
    tier (its plain version on the CPU); it must match the JAX package's
    XLA fast stream within 1 LSB, with the carried f32 history bit-exact."""
    j, _ = _pair(44100.0, 16000.0, ch, 64)
    data = _pcm(5 + ch, FRAMES * CHUNKS, ch, scale=8192)
    ref = [j.resample_stream(data, FRAMES, CHUNKS) for _ in range(2)]

    monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    calls = []
    real = pk.polyphase_fused16_plain
    monkeypatch.setattr(pk, "polyphase_fused16_plain", lambda *a: calls.append(1) or real(*a))
    t = Resampler(batch=B, exact=False, device="cpu")
    t.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, ch, True, True, 64, FILTERS))
    for pj, gj, cj in ref:
        pt, gt, ct = t.resample_stream(data, FRAMES, CHUNKS)
        assert list(gj) == list(gt)
        _assert_s16_close(pj, pt)
        assert np.asarray(cj).sum() == 0 and ct.sum() == 0
    assert len(calls) == 2 * CHUNKS, "the fused tier did not run"
    np.testing.assert_array_equal(np.asarray(j.history), t.history.numpy())


def test_fused_tier_gain_change_routes_to_f32_body(monkeypatch):
    """A call with gain != 0, and the first gain-0 call after it, must take
    the f32 body: the raw-int16 history round-trip is exact only under the
    same gain factor."""
    j, _ = _pair(44100.0, 16000.0, 2, 64)
    data = _pcm(9, FRAMES, 2, scale=8192)
    gains = [0.0, 12.0, 0.0, 0.0]
    ref = [j.resample_stream(data, FRAMES, 1, gain_db=g) for g in gains]

    monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    t = Resampler(batch=B, exact=False, device="cpu")
    t.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, FILTERS))
    fused = []
    real = t._fused_stream
    monkeypatch.setattr(t, "_fused_stream", lambda *a: fused.append(1) or real(*a))
    for g, (pj, gj, _) in zip(gains, ref):
        pt, gt, _ = t.resample_stream(data, FRAMES, 1, gain_db=g)
        assert list(gj) == list(gt)
        _assert_s16_close(pj, pt)
    assert len(fused) == 2          # calls 0 and 3 only
    np.testing.assert_array_equal(np.asarray(j.history), t.history.numpy())


@pytest.mark.parametrize("src,dst", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_state_carries_from_jax_to_port(src, dst):
    """A stream started in JAX continues in the port: JAX get_state() ->
    port set_state(), then both continue on the same input."""
    j, t = _pair(src, dst, 2, 64)
    data = _pcm(13, FRAMES * CHUNKS, 2)
    j.resample_stream(data, FRAMES, CHUNKS)
    j.resample(data, FRAMES, int(FRAMES * dst / src))
    t.set_state(j.get_state())
    _assert_state_equal(j, t)
    pj, gj, _ = j.resample_stream(data, FRAMES, CHUNKS)
    pt, gt, _ = t.resample_stream(data, FRAMES, CHUNKS)
    assert list(gj) == list(gt)
    _assert_s16_close(pj, pt)
    _assert_state_equal(j, t)


def test_failed_call_leaves_state_uncommitted(monkeypatch):
    """The phase, history and gain flag commit only after the chunk loop
    ran: a call that raises leaves the Resampler where it was."""
    _, t = _pair(44100.0, 16000.0, 2, 64)
    data = _pcm(17, FRAMES * CHUNKS, 2)
    t.resample_stream(data, FRAMES, 1)
    before = t.get_state()

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    import esp_audio_libs_tpu_torch.models.resampler as rmod
    monkeypatch.setattr(rmod, "polyphase_banded_cuda", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.resample_stream(data, FRAMES, CHUNKS, gain_db=6.0)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.resample(data, FRAMES, 400)
    after = t.get_state()
    assert after["phase_offset"] == before["phase_offset"]
    assert after["phase_input_index"] == before["phase_input_index"]
    assert after["hist_gain_zero"] == before["hist_gain_zero"]
    np.testing.assert_array_equal(after["history"], before["history"])


def test_exact_mode_and_missing_cuda_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Resampler(batch=B, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: Resampler(device='cuda') is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Resampler(batch=B, exact=False, device="cuda")


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import esp_audio_libs_tpu_torch\n"
            "import esp_audio_libs_tpu_torch.models.resampler\n"
            "import esp_audio_libs_tpu_torch.ops.polyphase_kernels\n"
            "import esp_audio_libs_tpu_torch.runtime.kernels\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'esp_audio_libs_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

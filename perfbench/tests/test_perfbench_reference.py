"""The plain reference against the program's CPU path (the plain versions
of its kernels) at a tiny size: every output bit, clip count, generated
count and the carried state, over three calls in both directions; and the
bfloat16 control differs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench import harness

from .conftest import REPO

ref = harness.load_module(REPO / "perfbench" / "configs" / "art_resampler_ref.py",
                          "test_art_resampler_ref")


@pytest.mark.parametrize("rates", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_reference_matches_the_port(rates):
    from esp_audio_libs_tpu_torch.models.resampler import Resampler, ResamplerConfiguration
    cfg = json.loads((REPO / "perfbench/configs/pcm_resample_exact.json").read_text())["resampler"]
    B, CF, NC, ch = 3, 300, 2, 2
    r = Resampler(B, exact=True, device="cpu")
    r.initialize(ResamplerConfiguration(*rates, 16, 16, ch, True, True, 64, 32))
    d = ref.design(cfg, *rates)
    assert np.array_equal(d.bank.view(np.uint32), r._filters.numpy().view(np.uint32))
    rng = np.random.default_rng(5)
    st = ref.State.zero(d, B, ch)
    for call in range(3):
        pcm = (rng.standard_normal((B, CF * NC * ch)) * 6000).clip(-32768, 32767).astype(np.int16)
        pcm[0, :40] = 32767                                     # clipping in stream 0
        out, gens, clips = r.resample_stream(torch.as_tensor(pcm.view(np.uint8)), CF, NC)
        start = st
        r_out, r_clips, r_gens, st, modes = ref.resample_call(d, st, pcm, CF, NC, ch)
        assert list(gens) == r_gens and modes.sum() == sum(r_gens)
        for c in range(NC):
            prog = out[c].numpy()[:, :gens[c] * 4].view(np.int16).reshape(B, gens[c], ch)
            assert np.array_equal(prog, r_out[c])
            assert np.array_equal(clips[c], r_clips[c])
        gs = r.get_state()
        assert np.array_equal(gs["history"].view(np.uint32), st.history.view(np.uint32))
        for s in range(2):
            for k in range(4):
                assert np.array_equal(gs["biquad"][s][k].view(np.uint32),
                                      st.biquad[s][k].view(np.uint32))
        assert np.float32(gs["phase_offset"]) == st.phase.offset
        assert gs["phase_input_index"] == st.phase.input_index
        c_out = ref.resample_call(d, start, pcm, CF, NC, ch, precision="bfloat16")[0]
        differing = sum(int((a != b).sum()) for a, b in zip(c_out, r_out))
        assert differing > 0.5 * sum(a.size for a in r_out)


def test_subnormal_rule():
    """Where a value falls below 2**-100 the reference flushes subnormal
    results, as the program's exact mode does: a stream that goes silent
    decays into the flush range."""
    from esp_audio_libs_tpu_torch.models.resampler import Resampler, ResamplerConfiguration
    cfg = json.loads((REPO / "perfbench/configs/pcm_resample_exact.json").read_text())["resampler"]
    rates = (44100.0, 16000.0)
    B, CF, NC, ch = 2, 1024, 2, 2
    r = Resampler(B, exact=True, device="cpu")
    r.initialize(ResamplerConfiguration(*rates, 16, 16, ch, True, True, 64, 32))
    d = ref.design(cfg, *rates)
    pcm = np.zeros((B, CF * NC * ch), np.int16)
    pcm[:, :8] = 1000                                           # a click, then silence
    out, gens, _ = r.resample_stream(torch.as_tensor(pcm.view(np.uint8)), CF, NC)
    r_out, _, _, st, _ = ref.resample_call(d, ref.State.zero(d, B, ch), pcm, CF, NC, ch)
    for c in range(NC):
        prog = out[c].numpy()[:, :gens[c] * 4].view(np.int16).reshape(B, gens[c], ch)
        assert np.array_equal(prog, r_out[c])
    gs = r.get_state()
    for s in range(2):
        for k in range(4):
            assert np.array_equal(gs["biquad"][s][k].view(np.uint32),
                                  st.biquad[s][k].view(np.uint32))


def test_mp3_reference_matches_the_port():
    """The float reference decoder against the program's exact tier (the
    Helix fixed point) on generated frames: within 1 LSB; its bfloat16
    control is far off."""
    from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder
    mref = harness.load_module(REPO / "perfbench" / "configs" / "mp3_ref.py", "test_mp3_ref")
    gen = harness.load_module(REPO / "perfbench" / "generators" / "mp3.py", "test_mp3_gen")
    tr = json.loads((REPO / "perfbench/traffic/mp3_128k_js_b2048.json").read_text())
    tr.update(pool_streams=2, stream_frames=3)
    pool = gen.make_pool(tr, 2 ** 31 + 77)
    fleet = BatchedMP3Decoder(2, device="cpu")
    pcm = fleet.decode_run([np.frombuffer(p, np.uint8) for p in pool], 3, to_device=True)[0]
    prog = pcm.numpy().reshape(2, -1, 2).astype(np.int64)
    ref_pcm = mref.decode(pool, 3).astype(np.int64)
    assert np.abs(prog).mean() > 300                      # audible, not silence
    assert np.abs(prog - ref_pcm).max() <= 1
    ctrl = mref.decode(pool, 3, "bfloat16").astype(np.int64)
    assert np.abs(ctrl - ref_pcm).max() > 20
    stats = mref.frame_stats(pool[0], 3)
    assert stats.shape == (3, 2, 2, 4) and (stats[..., 3] <= 576).all()
    assert (stats[..., :3].sum(-1) <= stats[..., 3]).all()

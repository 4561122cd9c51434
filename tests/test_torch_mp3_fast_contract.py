"""The contract of the port's MP3 relaxed tiers against the port's exact
tier, on the CPU: tests/test_mp3_fast.py on the port, for ``fast="mirror"``
and ``fast="mxu"``.

Within 1 LSB of the exact tier on decodable streams (MPEG-2 at three
sample rates, a stream whose main data lives in the bit reservoir), at most
4 LSB on under 0.5 % of samples on content that clips hard (the exact tier
truncates guard bits there; the relaxed tiers keep the value), errors,
consumed bytes and ``next_pos`` identical; a fleet against per-stream
decodes within 1 LSB; checkpoints that cross between the exact and the
relaxed tier by value; the reference-UB flag inert (True); the escape
sideband crossed with every tier at densities -1.0 (off) and 1.0 (forced);
and the fleet's other entry points under a relaxed tier: ``decode`` frame by
frame, ``decode_run(to_device=True)``, ``decode_run_pipelined``,
``reset_stream`` and a stream mesh. The port's tiers against JAX's are
tests/test_torch_mp3_fast.py.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import mp3_pipeline as tpipe
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder
from esp_audio_libs_tpu_torch.parallel.mesh import Sharded, stream_mesh
from tests.test_torch_mp3_fast import TIERS, TOL, _assert_tol, run_pcm, windows_stream

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mp3frames as mf  # noqa: E402

torch.set_num_threads(2)

MPEG2 = [(2, 0, dict(mode=0, mode_ext=0)),
         (2, 1, dict(mode=1, mode_ext=1)),     # MPEG-2 intensity (ISFMpeg2 path)
         (2, 2, dict(mode=3, mode_ext=0))]
RESERVOIR = [dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)] * 5


def fleet(n, tier, **kw):
    return BatchedMP3Decoder(n, device="cpu", fast=False if tier == "exact" else tier, **kw)


@functools.lru_cache(None)
def stream_of(kind, arg):
    if kind == "mpeg2":
        ver_bits, sr_idx, mm = MPEG2[arg]
        cfg = dict(ver_bits=ver_bits, bitrate_idx=7, sr_idx=sr_idx, **mm)
        return windows_stream(cfg, seed=99 + sr_idx)
    if kind == "reservoir":    # moderate gains: the PCM does not saturate
        return mf.craft_reservoir_stream(RESERVOIR, np.random.default_rng(7), gains=(150, 180))
    if kind == "hot":          # so hot that most of the PCM saturates
        return mf.craft_reservoir_stream(RESERVOIR, np.random.default_rng(7), gains=(230, 250))
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0)
    return windows_stream(cfg, seed=arg)


@functools.lru_cache(None)
def decode(kind, arg, tier):
    return run_pcm(fleet(1, tier), stream_of(kind, arg))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", range(len(MPEG2)), ids=["stereo", "intensity", "mono"])
def test_tier_mpeg2(case, tier):
    pcm, errs, cons, nxt = decode("mpeg2", case, tier)
    pcm_e, errs_e, cons_e, nxt_e = decode("mpeg2", case, "exact")
    assert errs == errs_e and cons == cons_e and nxt == nxt_e
    _assert_tol(pcm, pcm_e, f"mpeg2 case {case} {tier}")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_reservoir(tier):
    """Real main-data back-references across frames (the reservoir slack
    protocol exercises next_pos too)."""
    pcm, errs, cons, nxt = decode("reservoir", 0, tier)
    pcm_e, errs_e, cons_e, nxt_e = decode("reservoir", 0, "exact")
    assert errs == errs_e and cons == cons_e and nxt == nxt_e
    assert len(pcm_e) > 0
    _assert_tol(pcm, pcm_e, f"reservoir {tier}")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_hot_clipping_bound(tier):
    """On content where most PCM saturates, the exact tier truncates guard
    bits in the hybrid IMDCT and the relaxed tiers keep the value: at most 4
    LSB apart, on under 0.5 % of samples."""
    pcm, errs, *_ = decode("hot", 0, tier)
    pcm_e, errs_e, *_ = decode("hot", 0, "exact")
    assert errs == errs_e
    assert np.mean(np.abs(pcm_e.astype(np.int32)) >= 32767) > 0.5
    d = np.abs(pcm_e.astype(np.int32) - pcm.astype(np.int32))
    assert d.max(initial=0) <= 4, int(d.max())
    assert np.mean(d > TOL) < 0.005, float(np.mean(d > TOL))


@pytest.mark.parametrize("tier", TIERS)
def test_tier_fleet_matches_per_stream(tier):
    """Two streams of two stereo modes in one fleet against each alone."""
    cfgs = [dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0),
            dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=2)]
    streams = [windows_stream(c, i + 1) for i, c in enumerate(cfgs)]
    res = fleet(2, tier).decode_run(streams, 16)
    for i, s in enumerate(streams):
        solo, *_ = run_pcm(fleet(1, tier), s)
        got = np.concatenate([p for (e, p, c) in res[i] if p is not None])
        _assert_tol(solo, got, f"stream {i} fleet vs alone")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_checkpoint_interconverts(tier):
    """Exact state restored into a relaxed fleet (cast to f32) and relaxed
    state into an exact fleet (rounded to int32) keep decoding within 1 LSB
    of the exact tier's uninterrupted run."""
    rng = np.random.default_rng(5)
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0)
    frames = [mf.craft_tonal_frame(cfg, rng) for _ in range(6)]
    head, tail = b"".join(frames[:3]), b"".join(frames[3:])
    exact = fleet(1, "exact")
    exact.decode_run([head], 3)
    snap = exact.get_state()
    assert snap["vbuf"].dtype == np.int32
    pcm_ref, *_ = run_pcm(exact, tail, 3)

    fast = fleet(1, tier)
    fast.set_state(snap)
    assert fast._vbuf.dtype == fast._over.dtype == torch.float32
    np.testing.assert_array_equal(fast._vbuf.numpy(), snap["vbuf"].astype(np.float32))
    pcm_fast, *_ = run_pcm(fast, tail, 3)
    _assert_tol(pcm_ref, pcm_fast, "exact -> fast restore")

    fast2 = fleet(1, tier)
    fast2.decode_run([head], 3)
    snap_f = fast2.get_state()
    assert snap_f["vbuf"].dtype == np.float32
    exact2 = fleet(1, "exact")
    exact2.set_state(snap_f)
    assert exact2._vbuf.dtype == torch.int32
    np.testing.assert_array_equal(exact2._vbuf.numpy(), np.rint(snap_f["vbuf"]).astype(np.int32))
    pcm_back, *_ = run_pcm(exact2, tail, 3)
    _assert_tol(pcm_ref, pcm_back, "fast -> exact restore")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_ref_undef_inert(tier):
    dec = fleet(1, tier)
    dec.decode_run([stream_of("windows", 3)], 16)
    assert dec.last_frame_reference_defined == [True]


@pytest.mark.parametrize("tier", ["exact"] + TIERS)
@pytest.mark.parametrize("density", [-1.0, 1.0])
def test_esc_sideband_every_tier(tier, density, monkeypatch):
    """The int8 + escape-sideband transport crossed with every tier:
    density 1.0 forces the sideband on every run, -1.0 turns it off (0.0
    would not: zero-escape content passes ``0 > 0 * size``). Both decode as
    the exact tier's int16 baseline: bit for bit for the exact tier, within
    1 LSB for the relaxed ones."""
    stream = windows_stream(dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0), 42)
    monkeypatch.setattr(tpipe, "ESC_MAX_DENSITY", -1.0)
    pcm_ref, errs_ref, cons_ref, np_ref = run_pcm(fleet(1, "exact"), stream)

    monkeypatch.setattr(tpipe, "ESC_MAX_DENSITY", density)
    calls = {"pack": 0}
    real = tpipe._pack_huff8_sharded

    def counting(*a, **k):
        out = real(*a, **k)
        calls["pack"] += out is not None
        return out

    monkeypatch.setattr(tpipe, "_pack_huff8_sharded", counting)
    pcm, errs, cons, nxt = run_pcm(fleet(1, tier), stream)
    assert (calls["pack"] >= 1) if density == 1.0 else (calls["pack"] == 0)
    assert errs == errs_ref and cons == cons_ref and nxt == np_ref
    if tier == "exact":
        np.testing.assert_array_equal(pcm, pcm_ref)
    else:
        _assert_tol(pcm, pcm_ref, f"esc x {tier}")


def _tonal(n, frames, seed):
    """``n`` mid-side streams of tonal frames at moderate global gains: the
    1 LSB contract's content (tools/mp3frames.py's default gains saturate
    much of the PCM, the hot-clipping case above)."""
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=2)
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        out.append(b"".join(mf.craft_tonal_frame(cfg, rng, gains=(140, 175))
                            for _ in range(frames)))
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_tier_decode_frame_by_frame(tier):
    """``decode`` (one frame per stream and call, a stream skipped on one
    call) within 1 LSB of the exact fleet, errors and consumed identical."""
    streams = _tonal(2, 4, 60)
    dec, ref = fleet(2, tier), fleet(2, "exact")
    pos = [0, 0]
    for step in range(4):
        bufs = [s[p:] for s, p in zip(streams, pos)]
        if step == 1:
            bufs[1] = None
        got, want = dec.decode(bufs), ref.decode(bufs)
        for s, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
                continue
            assert (int(g[0]), g[2]) == (int(w[0]), w[2])
            _assert_tol(g[1], w[1], f"step {step} stream {s}")
            pos[s] += w[2]
    assert dec._vindex == ref._vindex


@pytest.mark.parametrize("tier", TIERS)
def test_tier_to_device_pipelined_and_reset(tier):
    """``decode_run(to_device=True)`` equals the host path byte for byte,
    ``decode_run_pipelined`` equals sequential runs byte for byte (the same
    arithmetic), both within 1 LSB of the exact tier; ``reset_stream``
    zeroes one slot in f32 and leaves the others."""
    streams = _tonal(3, 6, 70)
    host = fleet(3, tier).decode_run(streams, 6)
    dev = fleet(3, tier).decode_run(streams, 6, to_device=True)
    pcm_host = np.stack([np.concatenate([p for _, p, _ in r]) for r in host])
    np.testing.assert_array_equal(dev[0].numpy(), pcm_host)
    exact = fleet(3, "exact").decode_run(streams, 6, to_device=True)
    assert np.any(exact[0].numpy()) and np.mean(np.abs(exact[0].numpy()) >= 32767) < 0.01
    _assert_tol(dev[0].numpy(), exact[0].numpy(), "to_device vs exact")
    assert dev[1] == exact[1] and dev.next_pos == exact.next_pos

    seq, piped = fleet(3, tier), fleet(3, tier)
    want, pos = [], [0, 0, 0]
    for _ in range(2):
        r = seq.decode_run([s[p:] for s, p in zip(streams, pos)], 3)
        want.append(r)
        pos = [p + n for p, n in zip(pos, r.next_pos)]
    got = list(piped.decode_run_pipelined(streams, 3, 2))
    assert len(got) == 2
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            assert [(int(e), c) for e, _, c in gs] == [(int(e), c) for e, _, c in ws]
            for (_, p, _), (_, q, _) in zip(gs, ws):
                np.testing.assert_array_equal(p, q)
    for a, b in zip(piped._state(), seq._state()):
        assert torch.equal(a, b)

    piped.reset_stream(1)
    assert piped._vbuf.dtype == torch.float32 and piped._vindex[1] == 0
    assert not piped._vbuf[1].any() and not piped._over[1].any()
    assert piped._vbuf[0].any() and torch.equal(piped._vbuf[2], seq._vbuf[2])


@pytest.mark.parametrize("tier", TIERS)
def test_tier_on_a_mesh(tier):
    """A fleet on ``stream_mesh(["cpu"] * 2)``: one scan per shard with
    block-local escape sidebands (forced on), the carried f32 state split,
    within 1 LSB of the fleet without a mesh, errors and consumed equal."""
    streams = _tonal(4, 4, 80)
    mesh = stream_mesh(["cpu"] * 2)
    want = fleet(4, tier).decode_run(streams, 4)
    dec = fleet(4, tier, mesh=mesh)
    old = tpipe.ESC_MAX_DENSITY
    tpipe.ESC_MAX_DENSITY = 1.0
    try:
        got = dec.decode_run(streams, 4)
    finally:
        tpipe.ESC_MAX_DENSITY = old
    assert isinstance(dec._vbuf, Sharded) and dec._vbuf.parts[0].dtype == torch.float32
    for gs, ws in zip(got, want):
        assert [(int(e), c) for e, _, c in gs] == [(int(e), c) for e, _, c in ws]
        _assert_tol(np.concatenate([p for _, p, _ in gs]), np.concatenate([p for _, p, _ in ws]),
                    "mesh vs one device")
    assert got.next_pos == want.next_pos

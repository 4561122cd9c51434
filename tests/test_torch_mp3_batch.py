"""Port parity of the MP3 fleet: ``BatchedMP3Decoder`` (``decode``,
``decode_run``, ``to_device``, ``reset_stream``) against the JAX package's
on homogeneous and mixed fleets, byte for byte, with its carried state; the
dispatch slicing, a skipped stream and the escape tier forced on and off;
every committed corpus/independent_mp3 file against its oracle-anchored
signature; and the composed MP3 -> 16 kHz chain (device PCM straight into
the fast ``Resampler``), byte-identical to its host round trip and within 1
output LSB of JAX's chain.

Streams come from tools/mp3frames.py: crafted tonal frames (nonzero PCM),
window-type frames and fuzz frames, in the JAX package's batched-decoder
formats.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models import mp3_pipeline as jpipe
from esp_audio_libs_tpu.models.batch import BatchedMP3Decoder as JaxBatched
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu_torch.models import (BatchedMP3Decoder, MP3Decoder, Resampler,
                                             ResamplerConfiguration)
from esp_audio_libs_tpu_torch.models import mp3_pipeline as tpipe
from esp_audio_libs_tpu_torch.runtime import transport
from esp_audio_libs_tpu_torch.utils.errors import MP3Error

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import mp3frames as mf  # noqa: E402

torch.set_num_threads(2)

CORPUS = REPO / "corpus" / "independent_mp3"
FILES = sorted(CORPUS.glob("*.mp3"))
SIGS = json.loads((CORPUS / "signatures.json").read_text())
STEREO = mf.BATCH_CFGS[1]


def homogeneous_streams(n_frames=3):
    return [mf.mixed_stream(STEREO, 40 + i, n_frames, fuzz=False) for i in range(4)]


def mixed_streams(n_frames=3):
    return [mf.mixed_stream(c, 60 + i, n_frames) for i, c in enumerate(mf.BATCH_CFGS)]


def _same_results(got, want, label=""):
    assert len(got) == len(want), label
    for s, (rg, rw) in enumerate(zip(got, want)):
        if rw is None:
            assert rg is None
            continue
        if isinstance(rw, tuple):        # one frame (decode)
            rg, rw = [rg], [rw]
        assert len(rg) == len(rw), f"{label} stream {s}: frame count"
        for f, ((eg, pg, cg), (ew, pw, cw)) in enumerate(zip(rg, rw)):
            assert (int(eg), cg) == (int(ew), cw), f"{label} stream {s} frame {f}"
            assert (pg is None) == (pw is None), f"{label} stream {s} frame {f}"
            if pw is not None:
                np.testing.assert_array_equal(np.asarray(pg).reshape(-1),
                                              np.asarray(pw).reshape(-1),
                                              err_msg=f"{label} stream {s} frame {f}")


def _same_state(port, jax_dec):
    for a, b in zip(port._state(), (jax_dec._over, jax_dec._pt, jax_dec._pws, jax_dec._npv,
                                    jax_dec._vbuf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port._vindex == jax_dec._vindex
    assert port.last_frame_reference_defined == jax_dec.last_frame_reference_defined


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's decode_run of the homogeneous fleet (two runs of 3 frames, the
    second from ``next_pos``) and of the mixed fleet (one run), computed
    once: each run shape is one JAX compile."""
    hom = homogeneous_streams(6)
    jb = JaxBatched(4)
    first = jb.decode_run(hom, 3)
    second = jb.decode_run([s[p:] for s, p in zip(hom, first.next_pos)], 3)
    mixed = mixed_streams(4)
    jm = JaxBatched(4)
    return dict(hom=hom, hom_runs=(first, second), hom_dec=jb, mixed=mixed,
                mixed_run=jm.decode_run(mixed, 4), mixed_dec=jm)


def test_decode_run_homogeneous_matches_jax(jax_runs):
    """Two consecutive runs of a uniform fleet: results, ``next_pos``, the
    device state and the FIFO phases equal JAX's."""
    hom = jax_runs["hom"]
    bat = BatchedMP3Decoder(4, device="cpu")
    first = bat.decode_run(hom, 3)
    second = bat.decode_run([s[p:] for s, p in zip(hom, first.next_pos)], 3)
    for got, want in zip((first, second), jax_runs["hom_runs"]):
        _same_results(got, want)
        assert got.next_pos == want.next_pos
    assert any(np.any(p) for r in first for _, p, _ in r)
    _same_state(bat, jax_runs["hom_dec"])


@pytest.mark.parametrize("tier", ["forced", "off"])
def test_decode_run_escape_tier_matches_jax(jax_runs, monkeypatch, tier):
    """The int8 + escape transport forced on (fuzz spectra carry escapes)
    and off: both give JAX's results."""
    monkeypatch.setattr(tpipe, "ESC_MAX_DENSITY", 1.0 if tier == "forced" else 0.0)
    bat = BatchedMP3Decoder(4, device="cpu")
    _same_results(bat.decode_run(jax_runs["mixed"], 4), jax_runs["mixed_run"])
    _same_state(bat, jax_runs["mixed_dec"])


def test_decode_run_mixed_fleet_matches_jax_and_decode(jax_runs):
    """Four formats (one group each): decode_run equals JAX's, and equals
    repeated ``decode`` calls of the port with the run's stopping rule
    (a stream stops at its first error)."""
    mixed = jax_runs["mixed"]
    bat = BatchedMP3Decoder(4, device="cpu")
    run = bat.decode_run(mixed, 4)
    _same_results(run, jax_runs["mixed_run"])
    assert run.next_pos == jax_runs["mixed_run"].next_pos

    ref = BatchedMP3Decoder(4, device="cpu")
    expected, pos, stopped = [[] for _ in mixed], [0] * 4, [False] * 4
    for _ in range(4):
        bufs = [None if stopped[i] or pos[i] >= len(s) else s[pos[i]:]
                for i, s in enumerate(mixed)]
        for i, r in enumerate(ref.decode(bufs)):
            if r is not None:
                expected[i].append(r)
                pos[i] += r[2]
                stopped[i] |= r[0] != MP3Error.NONE
    _same_results(run, expected)
    for a, b in zip(bat._state(), ref._state()):
        assert torch.equal(a, b)


def test_decode_matches_jax_and_singles():
    """Lockstep ``decode`` of a uniform fleet against JAX's, and of a mixed
    fleet against single ``MP3Decoder``s, frame by frame; a skipped stream
    keeps its state."""
    hom = homogeneous_streams(2)
    bat, jb = BatchedMP3Decoder(4, device="cpu"), JaxBatched(4)
    pos = [0] * 4
    for step in range(2):
        bufs = [s[p:] for s, p in zip(hom, pos)]
        got, want = bat.decode(bufs), jb.decode(bufs)
        _same_results(got, want, f"step {step}")
        pos = [p + r[2] for p, r in zip(pos, want)]
    _same_state(bat, jb)

    mixed = mixed_streams(3)
    bat = BatchedMP3Decoder(4, device="cpu")
    singles = [MP3Decoder(device="cpu") for _ in mixed]
    pos = [0] * 4
    for step in range(3):
        skip = step == 1
        bufs = [None if skip and i == 2 else s[p:] for i, (s, p) in enumerate(zip(mixed, pos))]
        got = bat.decode(bufs)
        assert (got[2] is None) == skip
        for i, b in enumerate(bufs):
            if b is None:
                continue
            want = singles[i].decode(b)
            _same_results([got[i]], [want], f"step {step} stream {i}")
            assert bat.last_frame_reference_defined[i] == singles[i].last_frame_reference_defined
            pos[i] += want[2]


def test_sliced_dispatch_and_reset_stream(monkeypatch):
    """Tiny dispatch slices (every group split, a ragged tail) give the
    whole-group results over two runs; ``reset_stream`` recycles one slot
    (fresh front-end, zero state, phase 0) and leaves the others as they
    were."""
    streams = homogeneous_streams(4) + [mf.tonal_stream(STEREO, 90, 4)]

    def two_runs():
        bat = BatchedMP3Decoder(5, device="cpu")
        first = bat.decode_run(streams, 2)
        return bat, first, bat.decode_run([s[p:] for s, p in zip(streams, first.next_pos)], 2)

    whole = two_runs()
    monkeypatch.setattr(transport, "MP3_SLICE_PCM_BYTES", 2 * 4 * 576 * 2 * 2)
    sliced = two_runs()
    for a, b in zip(whole[1:], sliced[1:]):
        _same_results(b, a)
    for a, b in zip(whole[0]._state(), sliced[0]._state()):
        assert torch.equal(a, b)

    bat = sliced[0]
    before = [a.clone() for a in bat._state()]
    bat.reset_stream(3)
    assert bat._vindex[3] == 0 and bat.last_frame_reference_defined[3]
    for a, b in zip(bat._state(), before):
        assert not a[3].any()
        assert torch.equal(a[:3], b[:3]) and torch.equal(a[4:], b[4:])
    fresh = BatchedMP3Decoder(1, device="cpu").decode_run([streams[3]], 2)
    _same_results([bat.decode_run([None, None, None, streams[3], None], 2)[3]], fresh)


def test_to_device_matches_host_and_rolls_back():
    """``to_device`` leaves the run's PCM on the device, byte-identical to the
    host-returning run, with the consumed bytes and ``next_pos``; a fleet of
    two formats raises ``ValueError`` and is left as it was."""
    hom = homogeneous_streams(3)
    host = BatchedMP3Decoder(4, device="cpu").decode_run(hom, 3)
    bat = BatchedMP3Decoder(4, device="cpu")
    res = bat.decode_run(hom, 3, to_device=True)
    pcm_dev, consumed = res
    assert pcm_dev.dtype == torch.int16 and pcm_dev.shape == (4, 3 * 1152 * 2)
    np.testing.assert_array_equal(
        pcm_dev.numpy(), np.stack([np.concatenate([p for _, p, _ in r]) for r in host]))
    assert consumed == [sum(c for *_, c in r) for r in host]
    assert res.next_pos == host.next_pos

    mixed = mixed_streams(2)
    bat = BatchedMP3Decoder(4, device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        bat.decode_run(mixed, 2, to_device=True)
    _same_results(bat.decode_run(mixed, 2), BatchedMP3Decoder(4, device="cpu").decode_run(mixed, 2))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_corpus_signature(path):
    """Every corpus/independent_mp3 file: the per-frame error and consumed
    ladder and the PCM SHA256 pinned by the reference decoder
    (tests/test_independent_mp3_corpus.py holds the JAX package to the same)."""
    sig = SIGS[path.name]
    data = path.read_bytes()
    dec = MP3Decoder(device="cpu")
    h, errs, consumed, n_pcm, pos = hashlib.sha256(), [], [], 0, 0
    for _ in range(64):
        err, pcm, c = dec.decode(data[pos:])
        errs.append(int(err))
        consumed.append(int(c))
        if err == MP3Error.NONE and pcm is not None:
            h.update(np.asarray(pcm, dtype="<i2").tobytes())
            n_pcm += len(pcm)
        pos += c
        if pos >= len(data):
            break
    assert errs == sig["frame_errs"] and consumed == sig["frame_consumed"]
    assert n_pcm == sig["pcm_samples"] > 0
    assert h.hexdigest() == sig["pcm_sha256"]


def test_composed_chain_matches_jax_and_host_roundtrip(jax_runs):
    """4 streams x 3 frames of 44.1 kHz stereo -> device PCM -> fast
    Resampler -> 16 kHz: the device chain equals the host-roundtrip chain
    byte for byte and JAX's chain within 1 LSB, with equal generated counts."""
    hom = [s[: len(s) // 2] for s in jax_runs["hom"]]          # the first 3 frames
    args = (44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)
    pcm_dev, consumed = BatchedMP3Decoder(4, device="cpu").decode_run(hom, 3, to_device=True)
    pcm_host = np.stack([np.concatenate([p for _, p, _ in r])
                         for r in BatchedMP3Decoder(4, device="cpu").decode_run(hom, 3)])
    frames = pcm_dev.shape[1] // 2
    outs = []
    for pcm in (pcm_dev, torch.from_numpy(pcm_host)):
        r = Resampler(batch=4, exact=False, device="cpu")
        r.initialize(ResamplerConfiguration(*args))
        outs.append(r.resample_stream(pcm.view(torch.uint8), frames, 1))
    (od, gd, cd), (oh, gh, ch) = outs
    assert gd == gh and torch.equal(od, oh) and np.array_equal(cd, ch)

    import jax
    import jax.numpy as jnp
    jpcm, jconsumed = JaxBatched(4).decode_run(hom, 3, to_device=True)
    np.testing.assert_array_equal(pcm_dev.numpy(), np.asarray(jpcm))
    assert jconsumed == consumed
    jr = JaxResampler(batch=4, exact=False)
    jr.initialize(JaxConfig(*args))
    oj, gj, _ = jr.resample_stream(jax.lax.bitcast_convert_type(jpcm, jnp.uint8).reshape(4, -1),
                                   frames, 1)
    assert list(gj) == list(gd)
    a = np.asarray(oj).view(np.int16).astype(np.int32)
    b = od.numpy().view(np.int16).astype(np.int32)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert np.abs(b).max() > 0


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    for make in (MP3Decoder, lambda: BatchedMP3Decoder(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert jpipe.ESC_MAX_DENSITY == tpipe.ESC_MAX_DENSITY

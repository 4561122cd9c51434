"""Port parity of MP3 checkpoint/resume and pipelined runs: ``MP3Decoder``
and ``BatchedMP3Decoder`` ``get_state``/``set_state`` exchanged both ways
with the JAX package's decoders mid-stream (on a stream whose bit reservoir
carries main data across the checkpoint, and on tonal streams) and
continued byte for byte; a JAX ``fast=True`` fleet snapshot loaded by value
into an exact fleet, and a JAX snapshot of each relaxed tier loaded as it is
into a port fleet of that tier;
a width mismatch and a bad native image rejected; a restored FIFO ring whose
two copies disagree (exact and mirror tier); ``decode_run_pipelined`` against sequential
``decode_run`` calls and against JAX's generator, host and ``to_device``;
and the retry recipe after a transport failure mid-run.

Contracts: tests/test_checkpoint.py (``test_mp3_save_restore_with_reservoir``,
``test_batched_mp3_save_restore``, ``test_bad_state_blob_rejected``; the
``port_to_port`` cases are those contracts on the port, and
tests/test_torch_checkpoint.py holds the others),
tests/test_mp3_fast.py (``test_fast_tier_checkpoint_interconverts``) and
tests/test_batch.py (``test_mp3_pipelined_runs_match_sequential``,
``test_mp3_pipelined_to_device_matches_sequential``,
``test_mp3_sliced_run_transport_failure_leaves_state_consistent``).
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models.batch import BatchedMP3Decoder as JaxBatched
from esp_audio_libs_tpu.models.mp3 import MP3Decoder as JaxMP3
from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder, MP3Decoder
from esp_audio_libs_tpu_torch.models import batch as batch_mod
from esp_audio_libs_tpu_torch.runtime import transport
from tests.test_checkpoint import _mp3_stream
from tests.test_torch_mp3_fast import _assert_tol, jax_fleet, run_pcm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import mp3frames as mf  # noqa: E402

torch.set_num_threads(2)

B, SPLIT, FRAMES = 4, 3, 6
STEREO = mf.BATCH_CFGS[1]
TONAL = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)


def _frames(dec, stream, pos, n):
    """``n`` single-stream decode calls from ``pos``: (results, new pos)."""
    out = []
    for _ in range(n):
        err, pcm, con = dec.decode(stream[pos:])
        out.append((int(err), None if pcm is None else np.asarray(pcm).copy(), int(con)))
        pos += con
    return out, pos


def _fleet_frames(dec, streams, pos, n):
    """``n`` fleet decode calls from ``pos``: (per-call results, new pos)."""
    out = []
    for _ in range(n):
        got = dec.decode([s[p:] for s, p in zip(streams, pos)])
        pos = [p + int(g[2]) for p, g in zip(pos, got)]
        out.append([(int(g[0]), None if g[1] is None else np.asarray(g[1]).copy(), int(g[2]))
                    for g in got])
    return out, pos


def _same(got, want, label):
    """Frame results equal: error, consumed and PCM bytes."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, list):
            _same(g, w, f"{label} [{i}]")
            continue
        assert (g[0], g[2]) == (w[0], w[2]), f"{label} frame {i}"
        assert (g[1] is None) == (w[1] is None), f"{label} frame {i}"
        if w[1] is not None:
            np.testing.assert_array_equal(g[1].reshape(-1), w[1].reshape(-1),
                                          err_msg=f"{label} frame {i}")


def _run_results(run):
    """A decode_run result as comparable per-stream frame lists."""
    return [[(int(e), None if p is None else np.asarray(p).copy(), int(c)) for e, p, c in r]
            for r in run]


# ------------------------------------------------------------ single stream


@pytest.fixture(scope="module")
def single_streams():
    """The reservoir stream of the JAX contract and a tonal stream, each
    with JAX's uninterrupted decode of all its frames."""
    out = {}
    for kind, stream in (("reservoir", _mp3_stream(FRAMES, seed=71)),
                         ("tonal", mf.tonal_stream(TONAL, 5, FRAMES))):
        out[kind] = (stream, _frames(JaxMP3(), stream, 0, FRAMES)[0])
    return out


DIRECTIONS = ["jax_to_port", "port_to_jax", "port_to_port"]


@pytest.mark.parametrize("kind", ["reservoir", "tonal"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_mp3_decoder_state_exchange(single_streams, kind, direction):
    """Decode 3 frames in one package, pass the state (pickled) to a fresh
    decoder of the other (or of the port again: the checkpoint contract),
    decode 3 more: equal to JAX's uninterrupted run."""
    stream, want = single_streams[kind]
    first, second = {"jax_to_port": (JaxMP3(), MP3Decoder(device="cpu")),
                     "port_to_jax": (MP3Decoder(device="cpu"), JaxMP3()),
                     "port_to_port": (MP3Decoder(device="cpu"),
                                      MP3Decoder(device="cpu"))}[direction]
    head, pos = _frames(first, stream, 0, SPLIT)
    second.set_state(pickle.loads(pickle.dumps(first.get_state())))
    tail, _ = _frames(second, stream, pos, FRAMES - SPLIT)
    _same(head + tail, want, f"{kind} {direction}")
    if kind == "tonal":
        assert any(np.any(p) for _, p, _ in tail if p is not None)


def test_bad_state_blob_rejected():
    """A truncated native image raises RuntimeError (single decoder and
    fleet); a fleet snapshot of another width raises ValueError."""
    dec = MP3Decoder(device="cpu")
    st = dec.get_state()
    st["native"] = st["native"][:-8]
    with pytest.raises(RuntimeError):
        dec.set_state(st)
    fleet = BatchedMP3Decoder(2, device="cpu")
    snap = fleet.get_state()
    bad = dict(snap, native=[snap["native"][0], b"garbage"])
    with pytest.raises(RuntimeError):
        BatchedMP3Decoder(2, device="cpu").set_state(bad)
    with pytest.raises(ValueError):
        BatchedMP3Decoder(3, device="cpu").set_state(snap)
    with pytest.raises(ValueError):
        JaxBatched(3).set_state(snap)


# -------------------------------------------------------------------- fleet


def _fleet_streams(kind):
    if kind == "reservoir":
        return [_mp3_stream(FRAMES, seed=100 + s) for s in range(B)]
    return [mf.tonal_stream(TONAL, 300 + s, FRAMES) for s in range(B)]


@pytest.fixture(scope="module")
def fleet_runs():
    """JAX's uninterrupted fleet decode of each stream kind."""
    return {kind: (streams, _fleet_frames(JaxBatched(B), streams, [0] * B, FRAMES)[0])
            for kind in ("reservoir", "tonal") for streams in [_fleet_streams(kind)]}


def _same_fleet_state(port, jax_dec):
    for a, b in zip(port._state(), (jax_dec._over, jax_dec._pt, jax_dec._pws, jax_dec._npv,
                                    jax_dec._vbuf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port._vindex == list(jax_dec._vindex)
    assert port.last_frame_reference_defined == list(jax_dec.last_frame_reference_defined)


@pytest.mark.parametrize("kind", ["reservoir", "tonal"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_fleet_state_exchange(fleet_runs, kind, direction):
    """A fleet snapshot after 3 frames, pickled, restored into a fresh fleet
    of the other package (or of the port again): the next 3 frames equal
    JAX's uninterrupted run, and the restored state equals the snapshot's."""
    streams, want = fleet_runs[kind]
    first, second = {"jax_to_port": (JaxBatched(B), BatchedMP3Decoder(B, device="cpu")),
                     "port_to_jax": (BatchedMP3Decoder(B, device="cpu"), JaxBatched(B)),
                     "port_to_port": (BatchedMP3Decoder(B, device="cpu"),
                                      BatchedMP3Decoder(B, device="cpu"))}[direction]
    head, pos = _fleet_frames(first, streams, [0] * B, SPLIT)
    snap = pickle.loads(pickle.dumps(first.get_state()))
    assert all(isinstance(snap[k], np.ndarray) for k in ("over", "pt", "pws", "npv", "vbuf"))
    second.set_state(snap)
    if direction == "jax_to_port":
        _same_fleet_state(second, first)
    elif direction == "port_to_jax":
        _same_fleet_state(first, second)
    else:
        for a, b in zip(first._state(), second._state()):
            assert torch.equal(a, b)
        assert second._vindex == first._vindex
    tail, _ = _fleet_frames(second, streams, pos, FRAMES - SPLIT)
    _same(head + tail, want, f"{kind} {direction}")


def test_fleet_loads_jax_fast_tier_snapshot_by_value():
    """A JAX ``fast=True`` fleet's snapshot (f32 overlap and FIFO) loads into
    the port rounded to int32 by value, and the port continues exactly as
    JAX's exact fleet continues from the same snapshot."""
    rng = np.random.default_rng(5)
    frames = [mf.craft_tonal_frame(TONAL, rng) for _ in range(6)]
    head, tail = b"".join(frames[:3]), b"".join(frames[3:])
    fast = JaxBatched(1, fast=True)
    fast.decode_run([head], 3)
    snap = fast.get_state()
    assert snap["vbuf"].dtype == np.float32 and snap["over"].dtype == np.float32
    exact = JaxBatched(1)
    exact.set_state(snap)
    port = BatchedMP3Decoder(1, device="cpu")
    port.set_state(snap)
    np.testing.assert_array_equal(port._vbuf.numpy(), np.rint(snap["vbuf"]).astype(np.int32))
    _same_fleet_state(port, exact)
    want = exact.decode_run([tail], 3)
    got = port.decode_run([tail], 3)
    _same(_run_results(got), _run_results(want), "fast snapshot")
    assert got.next_pos == want.next_pos
    _same_fleet_state(port, exact)


@pytest.mark.parametrize("tier", ["mirror", "mxu"])
def test_fast_fleet_loads_jax_fast_tier_snapshot(tier):
    """A JAX fleet of a relaxed tier snapshots mid-stream; a port fleet of
    the same tier loads it without rounding (f32 kept as it is) and both
    continue within 1 LSB, with identical errors, consumed bytes and
    next_pos."""
    rng = np.random.default_rng(5)
    frames = [mf.craft_tonal_frame(TONAL, rng) for _ in range(6)]
    head, tail = b"".join(frames[:3]), b"".join(frames[3:])
    jd = jax_fleet(1, tier)
    jd.decode_run([head], 3)
    snap = jd.get_state()
    assert snap["vbuf"].dtype == np.float32 and snap["over"].dtype == np.float32
    port = BatchedMP3Decoder(1, device="cpu", fast=tier)
    port.set_state(snap)
    assert port._vbuf.dtype == torch.float32
    np.testing.assert_array_equal(port._vbuf.numpy(), snap["vbuf"])
    np.testing.assert_array_equal(port._over.numpy(), snap["over"])
    pcm_j, errs_j, cons_j, nxt_j = run_pcm(jd, tail, 3)
    pcm, errs, cons, nxt = run_pcm(port, tail, 3)
    assert errs == errs_j and cons == cons_j and nxt == nxt_j
    assert np.any(pcm)
    _assert_tol(pcm, pcm_j, f"JAX {tier} snapshot -> port")


def test_restored_ring_copies_disagree_mirror():
    """The mirror tier reads a restored ring whose two copies disagree as
    JAX's mirror FIFO does: within 1 LSB of JAX's mirror fleet from the
    same snapshot."""
    streams = [mf.tonal_stream(TONAL, 500 + s, 4) for s in range(2)]
    seed = jax_fleet(2, "mirror")
    tails = [s[p:] for s, p in zip(streams, seed.decode_run(streams, 1).next_pos)]
    snap = seed.get_state()
    snap["vbuf"] = (np.random.default_rng(9).standard_normal(snap["vbuf"].shape) * 1e5
                    ).astype(np.float32)
    jb, pb = jax_fleet(2, "mirror"), BatchedMP3Decoder(2, device="cpu", fast="mirror")
    jb.set_state(snap)
    pb.set_state(snap)
    want, got = _run_results(jb.decode_run(tails, 2)), _run_results(pb.decode_run(tails, 2))
    for g, w in zip(got, want):
        assert [(e, c) for e, _, c in g] == [(e, c) for e, _, c in w]
        _assert_tol(np.concatenate([p for _, p, _ in g]), np.concatenate([p for _, p, _ in w]),
                    "fleet, disagreeing ring, mirror tier")
    np.testing.assert_allclose(pb._vbuf.numpy(), np.asarray(jb._vbuf), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jb._vbuf)).max()))


def test_restored_ring_copies_disagree():
    """A restored FIFO ring whose two copies disagree (random vbuf): the
    port reads the copy JAX's FIFO reads, in the fleet and in the single
    decoder."""
    streams = [mf.tonal_stream(TONAL, 500 + s, 4) for s in range(2)]
    seed = JaxBatched(2)
    tails = [s[p:] for s, p in zip(streams, seed.decode_run(streams, 1).next_pos)]
    snap = seed.get_state()
    snap["vbuf"] = np.random.default_rng(9).integers(-(1 << 20), 1 << 20, snap["vbuf"].shape,
                                                     dtype=np.int64).astype(np.int32)
    jb, pb = JaxBatched(2), BatchedMP3Decoder(2, device="cpu")
    jb.set_state(snap)
    pb.set_state(snap)
    want, got = jb.decode_run(tails, 2), pb.decode_run(tails, 2)
    _same(_run_results(got), _run_results(want), "fleet, disagreeing ring")
    _same_fleet_state(pb, jb)
    assert any(np.any(p) for r in _run_results(got) for _, p, _ in r if p is not None)

    state = {"native": snap["native"][0], "over": snap["over"][0], "prev_type": snap["pt"][0],
             "prev_win_switch": snap["pws"][0], "num_prev": snap["npv"][0],
             "vbuf": snap["vbuf"][0], "vindex": snap["vindex"][0]}
    jd, pd = JaxMP3(), MP3Decoder(device="cpu")
    jd.set_state(state)
    pd.set_state(state)
    _same(_frames(pd, tails[0], 0, 2)[0], _frames(jd, tails[0], 0, 2)[0],
          "single decoder, disagreeing ring")


# ------------------------------------------------------------ pipelined runs


@pytest.fixture(scope="module")
def pipelined_streams():
    """Host-path fleet (window-type and tonal frames, one fuzz stream whose
    run ends early) and a to_device fleet (tonal), 9 frames each."""
    host = [mf.mixed_stream(STEREO, 90 + i, 9, fuzz=i == 3) for i in range(B)]
    dev = [mf.tonal_stream(TONAL, 120 + i, 9) for i in range(B)]
    return host, dev


@pytest.mark.parametrize("to_device", [False, True])
def test_pipelined_matches_sequential_and_jax(pipelined_streams, to_device):
    """decode_run_pipelined's runs equal sequential decode_run calls from
    each run's next_pos, and JAX's generator on the same buffers; next_pos
    is absolute within the buffers given."""
    streams = pipelined_streams[1 if to_device else 0]
    n_frames, n_runs = 3, 3
    ref = BatchedMP3Decoder(B, device="cpu")
    pos, expected = [0] * B, []
    for _ in range(n_runs):
        r = ref.decode_run([s[p:] for s, p in zip(streams, pos)], n_frames, to_device=to_device)
        pos = [p + q for p, q in zip(pos, r.next_pos)]
        expected.append((r, list(pos)))
    got = list(BatchedMP3Decoder(B, device="cpu").decode_run_pipelined(
        streams, n_frames, n_runs, to_device=to_device))
    jax_got = list(JaxBatched(B).decode_run_pipelined(streams, n_frames, n_runs,
                                                       to_device=to_device))
    assert len(got) == len(expected) == len(jax_got)
    for k, ((want, abs_pos), g, j) in enumerate(zip(expected, got, jax_got)):
        assert g.next_pos == abs_pos == list(j.next_pos), f"run {k}"
        if to_device:
            np.testing.assert_array_equal(g[0].numpy(), want[0].numpy(), err_msg=f"run {k}")
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(j[0]), err_msg=f"run {k}")
            assert list(g[1]) == list(want[1]) == list(j[1]), f"run {k}"
        else:
            _same(_run_results(g), _run_results(want), f"run {k}")
            _same(_run_results(g), _run_results(j), f"run {k} vs JAX")
    assert any(np.any(np.asarray(g[0])) if to_device else
               any(np.any(p) for r in _run_results(g) for _, p, _ in r if p is not None)
               for g in got)


def test_pipelined_stops_when_streams_end(pipelined_streams):
    """Asked for more runs than the buffers hold, the generator stops after
    the last run with frames, as JAX's does."""
    streams = [s[:len(s) // 3] for s in pipelined_streams[1]]
    got = list(BatchedMP3Decoder(B, device="cpu").decode_run_pipelined(streams, 2, 5))
    want = list(JaxBatched(B).decode_run_pipelined(streams, 2, 5))
    assert len(got) == len(want) < 5
    for g, w in zip(got, want):
        assert g.next_pos == list(w.next_pos)
        _same(_run_results(g), _run_results(w), "short buffers")


# ---------------------------------------------------------------- retry recipe


def test_retry_after_transport_failure(monkeypatch):
    """A download failing mid-slices surfaces, and leaves the fleet's state
    coherent: the pre-run snapshot restored into a fresh fleet repeats the
    run exactly, and the failed fleet's next run equals an unbroken
    control's."""
    streams = [mf.tonal_stream(TONAL, 30 + i, 5) for i in range(B)]
    control = BatchedMP3Decoder(B, device="cpu")
    r1c = control.decode_run(streams, 3)
    r2c = control.decode_run([s[p:] for s, p in zip(streams, r1c.next_pos)], 2)

    monkeypatch.setattr(transport, "MP3_SLICE_PCM_BYTES", 1)      # one stream a slice
    calls = []
    real = batch_mod._to_host

    def flaky(t):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected transport failure")
        return real(t)

    monkeypatch.setattr(batch_mod, "_to_host", flaky)
    bat = BatchedMP3Decoder(B, device="cpu")
    snap = bat.get_state()
    with pytest.raises(RuntimeError, match="injected transport failure"):
        bat.decode_run(streams, 3)
    monkeypatch.setattr(batch_mod, "_to_host", real)

    retry = BatchedMP3Decoder(B, device="cpu")
    retry.set_state(snap)
    r1 = retry.decode_run(streams, 3)
    _same(_run_results(r1), _run_results(r1c), "retried run")
    assert r1.next_pos == r1c.next_pos
    r2 = bat.decode_run([s[p:] for s, p in zip(streams, r1c.next_pos)], 2)
    _same(_run_results(r2), _run_results(r2c), "run after the failure")
    assert r2.next_pos == r2c.next_pos

"""Port parity of the sharded serving layer: ``BatchedFLACDecoder`` and
``BatchedMP3Decoder`` on a stream mesh, the contracts of
tests/test_batch_sharded.py held against the JAX package's sharded fleets.

The JAX fleets run on ``stream_mesh(jax.devices()[:8])`` (the 8 virtual CPU
devices of tests/conftest.py), the port's on ``stream_mesh(["cpu"] * 8)``,
with the same input bytes, 8 streams of 2-3 frames as in the JAX tests.
Tolerances: FLAC and MP3 PCM, frame results and consumed bytes byte-equal
(to the JAX mesh fleet and to the port's unsharded fleet); the composed FLAC
-> 16 kHz chain byte-equal to the port's unsharded chain in both modes, and
against JAX's mesh chain within 1 LSB in fast mode
(tests/test_batch_sharded.py:284-290) and in exact mode within 1 LSB in
under 2 % of samples (the contract of tests/test_torch_exact_resampler.py:
XLA on the CPU contracts the subsample lerp into an FMA). The carried MP3 state and the device PCM
stay split over the mesh (a :class:`Sharded` holder, one block per shard).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esp_audio_libs_tpu.models.batch import BatchedFLACDecoder as JaxFLACFleet
from esp_audio_libs_tpu.models.batch import BatchedMP3Decoder as JaxMP3Fleet
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu.parallel.mesh import stream_mesh as jax_stream_mesh
from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.models import flac as flac_model
from esp_audio_libs_tpu_torch.models import mp3_pipeline as pipe
from esp_audio_libs_tpu_torch.models.batch import BatchedFLACDecoder, BatchedMP3Decoder
from esp_audio_libs_tpu_torch.parallel.mesh import Sharded, stream_mesh
from esp_audio_libs_tpu_torch.utils.errors import MP3Error

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mp3frames as mf  # noqa: E402
from flacgen import SubframePlan, make_flac  # noqa: E402

N = 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N, "conftest should provide 8 virtual devices"
    return jax_stream_mesh(jax.devices()[:N])


@pytest.fixture(scope="module")
def mesh():
    return stream_mesh(["cpu"] * N)


@pytest.fixture(scope="module")
def flac_fleet():
    return [make_flac(rng_seed=100 + i, depth=16, channels=2, block_size=1024, n_frames=3,
                      plans=[[SubframePlan("lpc", order=8), SubframePlan("fixed", order=2)]] * 3)[0]
            for i in range(N)]


@pytest.fixture(scope="module")
def mp3_fleet():
    """8 format-uniform streams of tonal frames: error-free, real nonzero
    spectra, per-stream PCM (tests/test_batch_sharded.py::_mp3_fleet)."""
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0)
    out = []
    for i in range(N):
        rng = np.random.default_rng(300 + i)
        out.append(b"".join(mf.craft_tonal_frame(cfg, rng, gains=(150 + i, 200))
                            for _ in range(3)))
    return out


def _bodies(blobs, fleet):
    return [b[d.get_bytes_index():] for b, d in zip(blobs, fleet.decoders)]


def _flac_decode(blobs, fleet):
    fleet.read_headers(blobs)
    return fleet.decode_streams(_bodies(blobs, fleet))


def _assert_runs_equal(got, want):
    for s in range(len(want)):
        assert len(got[s]) == len(want[s])
        for (eg, pg, cg), (ew, pw, cw) in zip(got[s], want[s]):
            assert (int(eg), cg) == (int(ew), cw)
            if pw is None:
                assert pg is None
            else:
                np.testing.assert_array_equal(np.asarray(pg), np.asarray(pw))


def _split(t, mesh) -> bool:
    return isinstance(t, Sharded) and t.mesh == mesh and t.axis == 0


# ---------------------------------------------------------------- FLAC


def test_sharded_flac_decode_streams_bitexact(jmesh, mesh, flac_fleet):
    want = _flac_decode(flac_fleet, JaxFLACFleet(N, mesh=jmesh))
    one = _flac_decode(flac_fleet, BatchedFLACDecoder(N, device="cpu"))
    got = _flac_decode(flac_fleet, BatchedFLACDecoder(N, device="cpu", mesh=mesh))
    for s in range(N):
        assert got[s][0] == want[s][0] == one[s][0], f"stream {s} PCM differs under sharding"
        assert got[s][1]["md5_ok"] and want[s][1]["md5_ok"]
        assert [int(c) for c in got[s][1]["frame_results"]] == \
               [int(c) for c in want[s][1]["frame_results"]]


def test_sharded_flac_to_device(jmesh, mesh, flac_fleet):
    jf = JaxFLACFleet(N, mesh=jmesh)
    jf.read_headers(flac_fleet)
    want, _ = jf.decode_streams_to_device(_bodies(flac_fleet, jf))
    pf = BatchedFLACDecoder(N, device="cpu", mesh=mesh)
    pf.read_headers(flac_fleet)
    got, _ = pf.decode_streams_to_device(_bodies(flac_fleet, pf))
    assert _split(got, mesh)      # the composition handoff: PCM split along the streams
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))


def test_sharded_flac_int8_escape_sideband_bitexact(jmesh, mesh, monkeypatch):
    """The int8 + escape-sideband tier under a mesh: one sideband per shard
    block (``transport.escape_sideband_blocked``), byte-identical to the
    int16 tier and to the JAX package's sharded escape path."""
    from esp_audio_libs_tpu.models import flac as jax_flac

    blobs = [make_flac(rng_seed=700 + i, depth=16, channels=2, block_size=2048, n_frames=3,
                       plans=[[SubframePlan("lpc", order=8, fit=True),
                               SubframePlan("lpc", order=12, fit=True)]] * 3)[0]
             for i in range(N)]
    calls = {"blocked": 0}
    real = flac_model.transport.escape_sideband_blocked

    def counting(mask2d, *a, **k):
        calls["blocked"] += mask2d.shape[0] > 1     # one row per shard, not one block
        return real(mask2d, *a, **k)

    monkeypatch.setattr(flac_model, "ESC_MAX_DENSITY", 0.0)     # tier off
    want = _flac_decode(blobs, BatchedFLACDecoder(N, device="cpu", mesh=mesh))
    monkeypatch.setattr(flac_model, "ESC_MAX_DENSITY", 1.0)     # tier forced
    monkeypatch.setattr(jax_flac, "ESC_MAX_DENSITY", 1.0)
    monkeypatch.setattr(flac_model.transport, "escape_sideband_blocked", counting)
    got = _flac_decode(blobs, BatchedFLACDecoder(N, device="cpu", mesh=mesh))
    jax_got = _flac_decode(blobs, JaxFLACFleet(N, mesh=jmesh))
    assert calls["blocked"] >= 1, "no bucket took the per-shard sideband"
    for s in range(N):
        assert got[s][0] == want[s][0] == jax_got[s][0], f"stream {s}: the sideband changed PCM"
        assert got[s][1]["md5_ok"] and want[s][1]["md5_ok"]


def test_sharded_flac_ragged_bucket_runs_on_first_device(mesh, flac_fleet):
    """A fleet whose buckets do not divide the mesh runs them on the mesh's
    first device (JAX: unsharded), with the same bytes; its device PCM is
    then one tensor."""
    blobs = flac_fleet[:3]
    one = _flac_decode(blobs, BatchedFLACDecoder(3, device="cpu"))
    got = _flac_decode(blobs, BatchedFLACDecoder(3, device="cpu", mesh=mesh))
    assert [g[0] for g in got] == [o[0] for o in one]
    pf = BatchedFLACDecoder(3, device="cpu", mesh=mesh)
    pf.read_headers(blobs)
    pcm, _ = pf.decode_streams_to_device(_bodies(blobs, pf))
    assert isinstance(pcm, torch.Tensor)


# ----------------------------------------------------------------- MP3


def test_sharded_mp3_decode_run_bitexact(jmesh, mesh, mp3_fleet):
    want = JaxMP3Fleet(N, mesh=jmesh).decode_run(mp3_fleet, 3)
    shd = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    assert _split(shd._vbuf, mesh)    # the initial carried state is split
    got = shd.decode_run(mp3_fleet, 3)
    _assert_runs_equal(got, want)
    _assert_runs_equal(got, BatchedMP3Decoder(N, device="cpu").decode_run(mp3_fleet, 3))
    assert got.next_pos == want.next_pos
    # the carried state stays split after the run
    assert _split(shd._vbuf, mesh) and _split(shd._over, mesh)


def test_sharded_mp3_int8_escape_sideband_bitexact(mesh, mp3_fleet, monkeypatch):
    calls = {"sharded_pack": 0}
    real = pipe._pack_huff8_sharded

    def counting(huff16, n_shards):
        out = real(huff16, n_shards)
        if out is not None and n_shards > 1:
            calls["sharded_pack"] += 1
        return out

    monkeypatch.setattr(pipe, "ESC_MAX_DENSITY", 0.0)   # tier off
    want = BatchedMP3Decoder(N, device="cpu", mesh=mesh).decode_run(mp3_fleet, 3)
    monkeypatch.setattr(pipe, "ESC_MAX_DENSITY", 1.0)   # tier forced
    monkeypatch.setattr(pipe, "_pack_huff8_sharded", counting)
    got = BatchedMP3Decoder(N, device="cpu", mesh=mesh).decode_run(mp3_fleet, 3)
    assert calls["sharded_pack"] >= 1, "no run took the per-shard sideband"
    _assert_runs_equal(got, want)


@pytest.mark.parametrize("B,G,S", [(8, 3, 4), (16, 2, 8)])
def test_pack_huff8_sharded_matches_jax(B, G, S):
    """The per-shard sideband: the same plane, positions and values as the
    JAX package's ``_pack_huff8_sharded``."""
    from esp_audio_libs_tpu.models import mp3_pipeline as jax_pipe

    rng = np.random.default_rng(B + G)
    mag = rng.integers(0, 300, (G, B, 2, 576)).astype(np.uint32)
    mag[rng.random(mag.shape) < 0.99] //= 64         # escapes rare enough for the tier
    sign = (rng.random(mag.shape) < 0.5).astype(np.uint32) << 31
    h16 = pipe._pack_huff16((mag | sign).view(np.int32))    # sign in the MSB, as parsed
    want, got = jax_pipe._pack_huff8_sharded(h16, S), pipe._pack_huff8_sharded(h16, S)
    assert want is not None and got is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_mp3_to_device(jmesh, mesh, mp3_fleet):
    pcm_j, con_j = JaxMP3Fleet(N, mesh=jmesh).decode_run(mp3_fleet, 3, to_device=True)
    pcm_t, con_t = BatchedMP3Decoder(N, device="cpu", mesh=mesh).decode_run(
        mp3_fleet, 3, to_device=True)
    assert con_t == con_j
    assert _split(pcm_t, mesh)
    np.testing.assert_array_equal(pcm_t.gather().numpy(), np.asarray(pcm_j))


def test_sharded_mp3_decode_single_frames(jmesh, mesh, mp3_fleet):
    """The per-frame decode API also rides the mesh (a whole-fleet group)."""
    ref = JaxMP3Fleet(N, mesh=jmesh)
    shd = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    pos = [0] * N
    for _step in range(2):
        bufs = [s[p:] for s, p in zip(mp3_fleet, pos)]
        want = ref.decode(bufs)
        got = shd.decode(bufs)
        for s in range(N):
            assert (int(got[s][0]), got[s][2]) == (int(want[s][0]), want[s][2])
            if want[s][1] is None:
                assert got[s][1] is None
            else:
                np.testing.assert_array_equal(got[s][1], np.asarray(want[s][1]))
        pos = [p + r[2] for p, r in zip(pos, want)]
    assert _split(shd._vbuf, mesh)


def test_sharded_mp3_checkpoint_moves_between_mesh_no_mesh_and_jax(jmesh, mesh, mp3_fleet):
    """A checkpoint taken on the mesh restores onto the mesh (state split),
    with no mesh, and into JAX's mesh fleet, and back: each continues as
    the uninterrupted fleet does."""
    ref = BatchedMP3Decoder(N, device="cpu")
    first_ref = ref.decode_run(mp3_fleet, 2)
    tail = [s[p:] for s, p in zip(mp3_fleet, first_ref.next_pos)]
    want = ref.decode_run(tail, 1)
    shd = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    assert shd.decode_run(mp3_fleet, 2).next_pos == first_ref.next_pos
    st = shd.get_state()

    restored = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    restored.set_state(st)
    assert _split(restored._vbuf, mesh)
    _assert_runs_equal(restored.decode_run(tail, 1), want)
    plain = BatchedMP3Decoder(N, device="cpu")
    plain.set_state(st)
    _assert_runs_equal(plain.decode_run(tail, 1), want)
    jf = JaxMP3Fleet(N, mesh=jmesh)
    jf.set_state(st)
    from_jax = jf.get_state()
    _assert_runs_equal(jf.decode_run(tail, 1), want)
    back = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    back.set_state(from_jax)
    assert _split(back._vbuf, mesh)
    _assert_runs_equal(back.decode_run(tail, 1), want)


def test_mesh_requires_even_division():
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        BatchedMP3Decoder(3, device="cpu", mesh=stream_mesh(["cpu"] * 2))


def test_sharded_mp3_to_device_failure_rolls_back(mesh, mp3_fleet):
    """decode_run(to_device=True) on a fleet that breaks its conditions
    leaves the mesh fleet as it was (native reservoirs, FIFO phases)."""
    dec = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    dec.decode_run(mp3_fleet, 1)
    snap = [d._native_snapshot() for d in dec.decoders]
    vindex = list(dec._vindex)
    bad = list(mp3_fleet)
    bad[3] = b"\x00" * 64                   # no sync word: an error frame
    with pytest.raises(ValueError):
        dec.decode_run(bad, 2, to_device=True)
    assert [d._native_snapshot() for d in dec.decoders] == snap
    assert list(dec._vindex) == vindex
    r = dec.decode_run(mp3_fleet, 1)
    assert all(e == MP3Error.NONE for e, _, _ in r[0])


def test_sharded_reset_stream_preserves_layout(mesh, mp3_fleet):
    """Slot recycling on a split fleet: the state stays split and the
    recycled slot decodes as the unsharded fleet's does."""
    ref = BatchedMP3Decoder(N, device="cpu")
    shd = BatchedMP3Decoder(N, device="cpu", mesh=mesh)
    ref.decode_run(mp3_fleet, 2)
    shd.decode_run(mp3_fleet, 2)
    ref.reset_stream(1)
    shd.reset_stream(1)
    for a in (shd._vbuf, shd._over, shd._pt):
        assert _split(a, mesh)
    assert int(shd._vbuf.parts[1][0].abs().sum()) == 0       # stream 1: shard 1's block
    bufs = [mp3_fleet[1] if s == 1 else None for s in range(N)]
    want = ref.decode_run(bufs, 1)
    got = shd.decode_run(bufs, 1)
    _assert_runs_equal(got, want)
    assert _split(shd._vbuf, mesh)
    for a, b in zip(shd.get_state()["vbuf"], ref.get_state()["vbuf"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the composed chain on the mesh


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_composed_flac_resample(jmesh, mesh, flac_fleet, exact):
    """FLAC parse -> split device decode -> split PCM -> mesh Resampler: the
    PCM handoff, the resampler's history and the output stay split; both
    modes byte-equal to the port's unsharded chain, and within 1 LSB of
    JAX's mesh chain (exact: in under 2 % of samples)."""
    frames = 3 * 1024
    cfg = (44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)

    def port_chain(m):
        bat = BatchedFLACDecoder(N, device="cpu", mesh=m)
        bat.read_headers(flac_fleet)
        pcm, _ = bat.decode_streams_to_device(_bodies(flac_fleet, bat))
        r = Resampler(N, exact=exact, device="cpu", mesh=m)
        r.initialize(ResamplerConfiguration(*cfg))
        return (pcm, r, *r.resample_stream(pcm, frames, 1))

    jf = JaxFLACFleet(N, mesh=jmesh)
    jf.read_headers(flac_fleet)
    jpcm, _ = jf.decode_streams_to_device(_bodies(flac_fleet, jf))
    jr = JaxResampler(batch=N, exact=exact, mesh=jmesh)
    jr.initialize(JaxConfig(*cfg))
    out_j, gens_j, _ = jr.resample_stream(jpcm, frames, 1)

    pcm_1, _, out_1, gens_1, clips_1 = port_chain(None)
    pcm_s, r_s, out_s, gens_s, clips_s = port_chain(mesh)
    assert _split(pcm_s, mesh) and _split(r_s.history, mesh)
    assert isinstance(out_s, Sharded) and out_s.axis == 1   # [chunks, batch, bytes]
    assert list(gens_s) == list(gens_1) == list(gens_j)
    s16 = lambda o: np.asarray(o).view(np.int16).astype(np.int32)
    a, b = s16(out_s.gather().numpy()), s16(out_j)
    np.testing.assert_array_equal(a, s16(out_1.numpy()))
    np.testing.assert_array_equal(clips_s, clips_1)
    assert np.abs(a - b).max() <= 1, "drifted past 1 LSB"
    if exact:
        assert (a != b).mean() < 0.02

"""Port parity of checkpoint/resume: the cases of tests/test_checkpoint.py
on the port, each continued run also held to the JAX object's uninterrupted
output on the same input. A snapshot restored into a fresh object must
continue byte for byte.

The MP3 cases of that contract (``test_mp3_save_restore_with_reservoir``,
``test_batched_mp3_save_restore`` and the truncated MP3 image of
``test_bad_state_blob_rejected``) live in tests/test_torch_mp3_state.py as
the ``port_to_port`` cases of ``test_mp3_decoder_state_exchange`` and
``test_fleet_state_exchange`` and in its ``test_bad_state_blob_rejected``.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from esp_audio_libs_tpu.models.batch import BatchedFLACDecoder as JaxBatchedFLAC
from esp_audio_libs_tpu.models.flac import FLACDecoder as JaxFLAC
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu_torch.models import (BatchedFLACDecoder, FLACDecoder, Resampler,
                                             ResamplerConfiguration)
from esp_audio_libs_tpu_torch.utils.errors import FLACDecoderResult

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from flacgen import SubframePlan, make_flac  # noqa: E402

OK = FLACDecoderResult.SUCCESS


def _jax_stream_pcm(blob):
    """JAX's whole-stream decode of a FLAC blob: (pcm bytes, info)."""
    ref = JaxFLAC()
    assert ref.read_header(blob) == OK
    return ref.decode_stream(blob[ref.get_bytes_index():])


def test_flac_save_restore_mid_stream():
    blob, _ = make_flac(rng_seed=61, depth=16, channels=2, block_size=512,
                        n_frames=6, stereo_modes=["ms", None, "ls", "rs", None, "ms"],
                        plans=[[SubframePlan("lpc", order=8),
                                SubframePlan("fixed", order=2)]] * 6)
    full_pcm, _ = _jax_stream_pcm(blob)

    dec = FLACDecoder(device="cpu")
    assert dec.read_header(blob) == OK
    body = blob[dec.get_bytes_index():]
    pos, parts = 0, []
    for _ in range(3):
        res, pcm, _ = dec.decode_frame(body[pos:])
        assert res == OK
        parts.append(pcm)
        pos += dec.get_bytes_index()

    dec2 = FLACDecoder(device="cpu")
    dec2.set_state(pickle.loads(pickle.dumps(dec.get_state())))
    assert dec2.sample_rate == dec.sample_rate
    assert dec2.md5_signature == dec.md5_signature
    for _ in range(3):
        res, pcm, _ = dec2.decode_frame(body[pos:])
        assert res == OK
        parts.append(pcm)
        pos += dec2.get_bytes_index()
    assert b"".join(parts) == full_pcm


def test_flac_save_restore_partial_header():
    """A checkpoint taken inside a metadata block carries the partial-header
    resume state."""
    blob, _ = make_flac(rng_seed=62, depth=16, channels=1, block_size=256,
                        n_frames=2, metadata=[(1, bytes(256))],
                        plans=[[SubframePlan("fixed", order=1)]] * 2)
    dec = FLACDecoder(device="cpu")
    assert dec.read_header(blob[:60]) == FLACDecoderResult.HEADER_OUT_OF_DATA
    dec2 = FLACDecoder(device="cpu")
    dec2.set_state(dec.get_state())
    assert dec2.read_header(blob) == OK
    pcm, info = dec2.decode_stream(blob[dec2.get_bytes_index():])
    assert info["md5_ok"] is True
    assert pcm == _jax_stream_pcm(blob)[0]


def _resample_calls(r, raw, pos, n, chunk=400):
    out = []
    for _ in range(n):
        o, res = r.resample(raw[:, pos * 4:(pos + chunk) * 4], chunk, 300, 0.0)
        out.append(np.asarray(o))
        pos += res.frames_used
    return out, pos


@pytest.mark.parametrize("exact", [True, False])
def test_resampler_save_restore_mid_stream(exact):
    """Two calls, a snapshot into a fresh Resampler, two more: byte for byte
    equal to the uninterrupted port run, and within 1 LSB of JAX's (this
    configuration interpolates between filters, and XLA on the CPU contracts
    JAX's lerp into an FMA, as tests/test_torch_cli.py notes for exact
    ``resample_wav``)."""
    cfg = (44100.0, 16000.0, 16, 16, 2, True, True, 64, 64)
    raw = np.random.default_rng(81).integers(0, 256, (2, 4 * 400 * 2 * 2), dtype=np.uint8)

    def port():
        r = Resampler(batch=2, exact=exact, device="cpu")
        r.initialize(ResamplerConfiguration(*cfg))
        return r

    jax = JaxResampler(batch=2, exact=exact)
    jax.initialize(JaxConfig(*cfg))
    want, _ = _resample_calls(jax, raw, 0, 4)
    full, _ = _resample_calls(port(), raw, 0, 4)

    a = port()
    got, pos = _resample_calls(a, raw, 0, 2)
    b = port()
    b.set_state(pickle.loads(pickle.dumps(a.get_state())))
    tail, _ = _resample_calls(b, raw, pos, 2)
    for i, (g, f, w) in enumerate(zip(got + tail, full, want)):
        np.testing.assert_array_equal(g, f, err_msg=f"chunk {i}")
        gi, wi = g.view(np.int16).astype(np.int32), w.view(np.int16).astype(np.int32)
        assert gi.shape == wi.shape, f"chunk {i}"
        assert np.abs(gi - wi).max(initial=0) <= 1, f"chunk {i}"


def test_bad_state_blob_rejected():
    dec = FLACDecoder(device="cpu")
    with pytest.raises(RuntimeError):
        dec.set_state({"native": b"garbage", "output_32bit": False, "header_ok": False})
    blob, _ = make_flac(rng_seed=63, depth=16, channels=1, block_size=256, n_frames=1,
                        plans=[[SubframePlan("fixed", order=1)]])
    good = FLACDecoder(device="cpu")
    assert good.read_header(blob) == OK
    st = good.get_state()
    with pytest.raises(RuntimeError):
        FLACDecoder(device="cpu").set_state(dict(st, native=st["native"][:-8]))


def _flac_fleet(B):
    """B streams, their frame sections and the byte offset after 3 frames."""
    blobs, bodies, splits = [], [], []
    for s in range(B):
        blob, _ = make_flac(rng_seed=400 + s, depth=16, channels=2,
                            block_size=256, n_frames=6,
                            stereo_modes=["ms", None, "ls", "rs", None, "ms"],
                            plans=[[SubframePlan("lpc", order=4 + s),
                                    SubframePlan("fixed", order=2)]] * 6)
        scout = FLACDecoder(device="cpu")
        assert scout.read_header(blob) == OK
        body = blob[scout.get_bytes_index():]
        pos = 0
        for _ in range(3):
            res, _, _ = scout.decode_frame(body[pos:])
            assert res == OK
            pos += scout.get_bytes_index()
        blobs.append(blob)
        bodies.append(body)
        splits.append(pos)
    return blobs, bodies, splits


def test_batched_flac_save_restore():
    """A fleet snapshot (pickled) restored into a fresh fleet continues
    byte for byte, equal to JAX's uninterrupted fleet; a snapshot of another
    width is rejected."""
    B = 4
    blobs, bodies, splits = _flac_fleet(B)
    jref = JaxBatchedFLAC(B)
    assert all(r == OK for r in jref.read_headers(blobs))
    full = jref.decode_streams(bodies)
    assert all(res["md5_ok"] for _, res in full)

    fleet = BatchedFLACDecoder(B, device="cpu")
    assert all(r == OK for r in fleet.read_headers(blobs))
    part1 = fleet.decode_streams([b[:p] for b, p in zip(bodies, splits)], verify_md5=False)
    blob = pickle.dumps(fleet.get_state())
    fleet2 = BatchedFLACDecoder(B, device="cpu")
    fleet2.set_state(pickle.loads(blob))
    part2 = fleet2.decode_streams([b[p:] for b, p in zip(bodies, splits)], verify_md5=False)
    for s in range(B):
        assert part1[s][0] + part2[s][0] == full[s][0], f"stream {s}"
        assert (part1[s][1]["num_frames"] + part2[s][1]["num_frames"]
                == full[s][1]["num_frames"])

    with pytest.raises(ValueError):
        BatchedFLACDecoder(B + 1, device="cpu").set_state(pickle.loads(blob))

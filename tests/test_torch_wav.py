"""Port parity of the WAV header parser: the same byte strings through the
JAX package's ``WAVDecoder``/``parse_wav`` and the port's, whose states,
results, fields, byte counts and payloads must agree exactly. Valid headers
of tests/test_wav.py, then truncated, odd-chunk, skip and bad-magic cases,
one-shot and fed in pieces through the streaming protocol."""

import pytest

from esp_audio_libs_tpu.models.wav import WAVDecoder as JaxWAV
from esp_audio_libs_tpu.models.wav import parse_wav as jax_parse_wav
from esp_audio_libs_tpu_torch.models import WAVDecoder, parse_wav
from esp_audio_libs_tpu_torch.utils.errors import WAVDecoderResult, WAVDecoderState
from tests.test_wav import CASES, make_wav

FIELDS = ("state", "bytes_processed", "bytes_to_skip", "bytes_needed", "chunk_name",
          "chunk_bytes_left", "sample_rate", "num_channels", "bits_per_sample")

BLOBS = [make_wav(**kw) for kw in CASES] + [
    make_wav(extra_chunks=[(b"LIST", b"odd"), (b"JUNK", b"y" * 7)]),   # two odd chunks
    make_wav(extra_chunks=[(b"bext", b"z" * 600)]),                    # a long skip
    make_wav(bits=32, channels=6, sample_rate=96000, n_frames=5),
]
BAD = [
    b"RIFX" + b"\x00" * 64,                                      # no RIFF
    b"RIFF\x10\x00\x00\x00WAVX" + b"\x00" * 40,                  # no WAVE
    make_wav()[:10],                                             # truncated in the RIFF header
    make_wav()[:30],                                             # truncated in fmt
    make_wav(extra_chunks=[(b"JUNK", b"x" * 33)])[:50],          # truncated inside a skip
    make_wav(n_frames=8)[:-5],                                   # truncated payload
    b"",
]


def _fields(dec):
    return {f: getattr(dec, f) for f in FIELDS}


def test_enum_values_match_jax():
    from esp_audio_libs_tpu.utils.errors import WAVDecoderResult as JR
    from esp_audio_libs_tpu.utils.errors import WAVDecoderState as JS
    assert {m.name: int(m) for m in WAVDecoderResult} == {m.name: int(m) for m in JR}
    assert {m.name: int(m) for m in WAVDecoderState} == {m.name: int(m) for m in JS}


@pytest.mark.parametrize("i", range(len(BLOBS) + len(BAD)))
def test_decode_header_matches_jax(i):
    blob = (BLOBS + BAD)[i]
    jd, td = JaxWAV(), WAVDecoder()
    assert int(td.decode_header(blob)) == int(jd.decode_header(blob))
    assert _fields(td) == _fields(jd)


@pytest.mark.parametrize("i", range(len(BLOBS)))
def test_parse_wav_matches_jax(i):
    blob = BLOBS[i]
    jd, jpcm = jax_parse_wav(blob)
    td, tpcm = parse_wav(blob)
    assert tpcm == jpcm and len(tpcm) > 0
    assert _fields(td) == _fields(jd)
    with pytest.raises(ValueError, match="WARNING_INCOMPLETE_DATA"):
        parse_wav(blob[:20])


@pytest.mark.parametrize("i", [0, 3, 4, 6, 7])
def test_streaming_protocol_matches_jax(i):
    """The reference caller protocol (skip ``bytes_to_skip``, read
    ``bytes_needed``, ``next``) one header piece at a time: both parsers take
    the same steps through the same states."""
    blob = BLOBS[i]
    decs = (JaxWAV(), WAVDecoder())
    pos = 0
    while True:
        skip, need = decs[1].bytes_to_skip, decs[1].bytes_needed
        assert (skip, need) == (decs[0].bytes_to_skip, decs[0].bytes_needed)
        pos += skip
        chunk = blob[pos:pos + need]
        assert len(chunk) == need
        results = [int(d.next(chunk)) for d in decs]
        assert results[0] == results[1]
        assert _fields(decs[1]) == _fields(decs[0])
        pos += need
        if results[1] != WAVDecoderResult.SUCCESS_NEXT:
            break
    assert decs[1].state == WAVDecoderState.IN_DATA
    assert decs[1].chunk_bytes_left == len(blob) - pos
    decs[1].reset()
    decs[0].reset()
    assert _fields(decs[1]) == _fields(decs[0])

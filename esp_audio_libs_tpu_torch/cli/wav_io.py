"""WAV writing for the CLIs: a copy, importing nothing of JAX, of
``write_wav_header`` of examples/flac_to_wav.py (the reference's
host_examples/flac_to_wav/src/flac_to_wav.cpp:80-152). Reading goes through
``models.wav.parse_wav``."""

from __future__ import annotations

import struct

__all__ = ["WAVE_FORMAT_EXTENSIBLE", "WAVE_FORMAT_PCM", "write_wav_header"]

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def write_wav_header(f, sample_rate, channels, bits_per_sample, num_samples, bytes_per_sample):
    """A PCM header, or WAVE_FORMAT_EXTENSIBLE for depths other than 8 and
    16 bits or more than 2 channels; ``num_samples`` per channel."""
    data_size = num_samples * channels * bytes_per_sample
    byte_rate = sample_rate * channels * bytes_per_sample
    block_align = channels * bytes_per_sample
    use_ext = bits_per_sample not in (8, 16) or channels > 2

    if use_ext:
        fmt = struct.pack(
            "<HHIIHHHHI", WAVE_FORMAT_EXTENSIBLE, channels, sample_rate, byte_rate,
            block_align, bytes_per_sample * 8, 22, bits_per_sample,
            (1 << channels) - 1 if channels <= 18 else 0)
        fmt += b"\x01\x00\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"  # PCM GUID
    else:
        fmt = struct.pack("<HHIIHH", WAVE_FORMAT_PCM, channels, sample_rate, byte_rate,
                          block_align, bits_per_sample)
    f.write(b"RIFF")
    f.write(struct.pack("<I", 4 + 8 + len(fmt) + 8 + data_size))
    f.write(b"WAVE")
    f.write(b"fmt ")
    f.write(struct.pack("<I", len(fmt)))
    f.write(fmt)
    f.write(b"data")
    f.write(struct.pack("<I", data_size))

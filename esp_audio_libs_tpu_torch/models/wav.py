"""Streaming WAV (RIFF) header parser of the port, a copy of
esp_audio_libs_tpu/models/wav.py.

Host-side equivalent of the reference ``wav_decoder::WAVDecoder``
(reference: src/decode/wav_decoder.cpp:8-161, include/wav_decoder.h:34-94).
Header parsing is byte-level control flow with no device work, so it stays
on the host; the PCM payload goes to the device ops of ``ops.quantization``
downstream.

The streaming protocol is identical to the reference:

1. Check ``bytes_to_skip`` first and skip that many bytes.
2. Read exactly ``bytes_needed`` bytes into the start of the buffer.
3. Run :meth:`next` and loop to 1 until the result is ``SUCCESS_IN_DATA``.
4. Use ``chunk_bytes_left`` to read the PCM payload.

:meth:`decode_header` drives the same loop over one contiguous buffer.
"""

from __future__ import annotations

from ..utils.errors import WAVDecoderResult, WAVDecoderState

__all__ = ["WAVDecoder", "parse_wav"]


class WAVDecoder:
    """Six-state streaming RIFF parser (states: include/wav_decoder.h:34-43)."""

    def __init__(self) -> None:
        self.reset()
        self._bytes_processed = 0

    # -- getters mirroring include/wav_decoder.h:60-68 --
    @property
    def state(self) -> WAVDecoderState:
        return self._state

    @property
    def bytes_processed(self) -> int:
        return self._bytes_processed

    @property
    def bytes_to_skip(self) -> int:
        return self._bytes_to_skip

    @property
    def bytes_needed(self) -> int:
        return self._bytes_needed

    @property
    def chunk_name(self) -> str:
        return self._chunk_name

    @property
    def chunk_bytes_left(self) -> int:
        return self._chunk_bytes_left

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def num_channels(self) -> int:
        return self._num_channels

    @property
    def bits_per_sample(self) -> int:
        return self._bits_per_sample

    def reset(self) -> None:
        """Reference: src/decode/wav_decoder.cpp:152-161."""
        self._state = WAVDecoderState.BEFORE_RIFF
        self._bytes_needed = 8  # chunk name + size
        self._bytes_to_skip = 0
        self._chunk_name = ""
        self._chunk_bytes_left = 0
        self._sample_rate = 0
        self._num_channels = 0
        self._bits_per_sample = 0

    def decode_header(self, buffer: bytes) -> WAVDecoderResult:
        """Drive the skip/read/next loop over one buffer
        (reference: src/decode/wav_decoder.cpp:8-46)."""
        pos = 0
        avail = len(buffer)
        to_skip = self.bytes_to_skip
        to_read = self.bytes_needed
        self._bytes_processed = 0

        while (to_skip + to_read) > 0:
            if to_skip > avail or to_read > avail:
                return WAVDecoderResult.WARNING_INCOMPLETE_DATA
            if to_skip > 0:
                pos += to_skip
                self._bytes_processed += to_skip
                avail -= to_skip
                to_skip = 0
            elif to_read > 0:
                result = self.next(buffer[pos:pos + to_read])
                pos += to_read
                self._bytes_processed += to_read
                avail -= to_read
                if result == WAVDecoderResult.SUCCESS_IN_DATA:
                    return result
                if result != WAVDecoderResult.SUCCESS_NEXT:
                    return result
                to_skip = self.bytes_to_skip
                to_read = self.bytes_needed
        return WAVDecoderResult.ERROR_FAILED

    def next(self, buffer: bytes) -> WAVDecoderResult:
        """Advance the state machine by one chunk-header-sized read
        (reference: src/decode/wav_decoder.cpp:48-150)."""
        self._bytes_to_skip = 0
        st = self._state

        if st == WAVDecoderState.BEFORE_RIFF:
            self._chunk_name = buffer[:4].decode("latin1")
            if self._chunk_name != "RIFF":
                return WAVDecoderResult.ERROR_NO_RIFF
            self._chunk_bytes_left = int.from_bytes(buffer[4:8], "little")
            if self._chunk_bytes_left % 2:
                self._chunk_bytes_left += 1  # pad byte
            self._state = WAVDecoderState.BEFORE_WAVE
            self._bytes_needed = 4  # WAVE

        elif st == WAVDecoderState.BEFORE_WAVE:
            self._chunk_name = buffer[:4].decode("latin1")
            if self._chunk_name != "WAVE":
                return WAVDecoderResult.ERROR_NO_WAVE
            self._state = WAVDecoderState.BEFORE_FMT
            self._bytes_needed = 8

        elif st == WAVDecoderState.BEFORE_FMT:
            self._chunk_name = buffer[:4].decode("latin1")
            self._chunk_bytes_left = int.from_bytes(buffer[4:8], "little")
            if self._chunk_bytes_left % 2:
                self._chunk_bytes_left += 1
            if self._chunk_name == "fmt ":
                self._state = WAVDecoderState.IN_FMT
                self._bytes_needed = self._chunk_bytes_left
            else:
                self._bytes_to_skip = self._chunk_bytes_left
                self._bytes_needed = 8

        elif st == WAVDecoderState.IN_FMT:
            self._num_channels = int.from_bytes(buffer[2:4], "little")
            self._sample_rate = int.from_bytes(buffer[4:8], "little")
            self._bits_per_sample = int.from_bytes(buffer[14:16], "little")
            self._state = WAVDecoderState.BEFORE_DATA
            self._bytes_needed = 8

        elif st == WAVDecoderState.BEFORE_DATA:
            self._chunk_name = buffer[:4].decode("latin1")
            self._chunk_bytes_left = int.from_bytes(buffer[4:8], "little")
            if self._chunk_bytes_left % 2:
                self._chunk_bytes_left += 1
            if self._chunk_name == "data":
                self._state = WAVDecoderState.IN_DATA
                self._bytes_needed = 0
                return WAVDecoderResult.SUCCESS_IN_DATA
            self._bytes_to_skip = self._chunk_bytes_left
            self._bytes_needed = 8

        elif st == WAVDecoderState.IN_DATA:
            return WAVDecoderResult.SUCCESS_IN_DATA

        return WAVDecoderResult.SUCCESS_NEXT


def parse_wav(buffer: bytes):
    """One-shot convenience: parse a WAV header, return (decoder, pcm_bytes).

    ``pcm_bytes`` is the data-chunk payload (possibly truncated if the buffer
    holds less than ``chunk_bytes_left``).
    """
    dec = WAVDecoder()
    result = dec.decode_header(buffer)
    if result != WAVDecoderResult.SUCCESS_IN_DATA:
        raise ValueError(f"WAV header parse failed: {result.name}")
    start = dec.bytes_processed
    end = min(len(buffer), start + dec.chunk_bytes_left)
    return dec, buffer[start:end]

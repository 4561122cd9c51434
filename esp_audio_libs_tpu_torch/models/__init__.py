"""User-facing pipelines of the port: the ``Resampler`` (exact and fast
mode), the batched ART resampler ``BatchedResample``, the FLAC decoders
(``FLACDecoder`` for one stream, ``BatchedFLACDecoder`` for a fleet, and the
device-resident ``decode_streams_to_device[_grouped]`` that feed the
Resampler without a host round trip), the MP3 decoders (``MP3Decoder``,
``BatchedMP3Decoder`` whose ``decode_run(to_device=True)`` feeds the
Resampler the same way) and the WAV header parser. Each decoder and
resampler runs on ``"cuda"`` by default and raises without a card."""

from .art_resampler import BatchedResample, ResampleResult  # noqa: F401
from .batch import (BatchedFLACDecoder, BatchedMP3Decoder, MP3DeviceRunResult,  # noqa: F401
                    MP3RunResult)
from .flac import (FLACDecoder, decode_streams_to_device,  # noqa: F401
                   decode_streams_to_device_grouped)
from .mp3 import MP3Decoder  # noqa: F401
from .resampler import Resampler, ResamplerConfiguration, ResamplerResults  # noqa: F401
from .wav import WAVDecoder, parse_wav  # noqa: F401

__all__ = ["BatchedFLACDecoder", "BatchedMP3Decoder", "BatchedResample", "FLACDecoder",
           "MP3Decoder", "MP3DeviceRunResult", "MP3RunResult", "ResampleResult", "Resampler",
           "ResamplerConfiguration", "ResamplerResults", "WAVDecoder",
           "decode_streams_to_device", "decode_streams_to_device_grouped", "parse_wav"]

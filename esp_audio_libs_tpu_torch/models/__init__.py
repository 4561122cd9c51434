"""User-facing pipelines of the port: the ``Resampler`` (exact and fast
mode), the batched ART resampler ``BatchedResample``, and the FLAC decoders (``FLACDecoder`` for one stream, ``BatchedFLACDecoder`` for a
fleet, and the device-resident ``decode_streams_to_device[_grouped]`` that
feed the Resampler without a host round trip). Each runs on ``"cuda"`` by
default and raises without a card."""

from .art_resampler import BatchedResample, ResampleResult  # noqa: F401
from .batch import BatchedFLACDecoder  # noqa: F401
from .flac import (FLACDecoder, decode_streams_to_device,  # noqa: F401
                   decode_streams_to_device_grouped)
from .resampler import Resampler, ResamplerConfiguration, ResamplerResults  # noqa: F401

__all__ = ["BatchedFLACDecoder", "BatchedResample", "FLACDecoder", "ResampleResult", "Resampler", "ResamplerConfiguration",
           "ResamplerResults", "decode_streams_to_device", "decode_streams_to_device_grouped"]

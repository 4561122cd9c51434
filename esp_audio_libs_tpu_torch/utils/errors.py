"""Result and status enums of the WAV, FLAC and MP3 decoders, with the
reference library's values.

A copy of esp_audio_libs_tpu/utils/errors.py (reference:
``include/wav_decoder.h:34-52``, ``include/flac_decoder.h:22-58``,
``include/mp3_decoder.h:359-375``), so that the port imports nothing of the
JAX package. The two packages' values are equal, so results compare across
them.
"""

from __future__ import annotations

import enum

__all__ = ["FLACDecoderResult", "FLACMetadataType", "MP3Error", "WAVDecoderResult",
           "WAVDecoderState"]


class WAVDecoderState(enum.IntEnum):
    """Reference: include/wav_decoder.h:34-43."""

    BEFORE_RIFF = 0
    BEFORE_WAVE = 1
    BEFORE_FMT = 2
    IN_FMT = 3
    BEFORE_DATA = 4
    IN_DATA = 5


class WAVDecoderResult(enum.IntEnum):
    """Reference: include/wav_decoder.h:45-52."""

    SUCCESS_NEXT = 0
    SUCCESS_IN_DATA = 1
    WARNING_INCOMPLETE_DATA = 2
    ERROR_NO_RIFF = 3
    ERROR_NO_WAVE = 4
    ERROR_FAILED = 5


class FLACDecoderResult(enum.IntEnum):
    """Reference: include/flac_decoder.h:22-44 (values preserved)."""

    SUCCESS = 0
    NO_MORE_FRAMES = 1
    HEADER_OUT_OF_DATA = 2
    ERROR_OUT_OF_DATA = 3
    ERROR_BAD_MAGIC_NUMBER = 4
    ERROR_SYNC_NOT_FOUND = 5
    ERROR_BAD_BLOCK_SIZE_CODE = 6
    ERROR_BAD_HEADER = 7
    ERROR_RESERVED_CHANNEL_ASSIGNMENT = 8
    ERROR_RESERVED_SUBFRAME_TYPE = 9
    ERROR_BAD_FIXED_PREDICTION_ORDER = 10
    ERROR_RESERVED_RESIDUAL_CODING_METHOD = 11
    ERROR_BLOCK_SIZE_NOT_DIVISIBLE_RICE = 12
    ERROR_MEMORY_ALLOCATION_ERROR = 13
    ERROR_BLOCK_SIZE_OUT_OF_RANGE = 14
    ERROR_CRC_MISMATCH = 15
    # The reference header assigns 16 to both BAD_SAMPLE_DEPTH and
    # METADATA_TOO_LARGE (include/flac_decoder.h:36,43); the value is kept.
    ERROR_BAD_SAMPLE_DEPTH = 16
    ERROR_METADATA_TOO_LARGE = 16


class FLACMetadataType(enum.IntEnum):
    """Reference: include/flac_decoder.h:48-58."""

    STREAMINFO = 0
    PADDING = 1
    APPLICATION = 2
    SEEKTABLE = 3
    VORBIS_COMMENT = 4
    CUESHEET = 5
    PICTURE = 6
    INVALID = 127


class MP3Error(enum.IntEnum):
    """Reference: include/mp3_decoder.h:359-375 (values preserved)."""

    NONE = 0
    INDATA_UNDERFLOW = -1
    MAINDATA_UNDERFLOW = -2
    FREE_BITRATE_SYNC = -3
    OUT_OF_MEMORY = -4
    NULL_POINTER = -5
    INVALID_FRAMEHEADER = -6
    INVALID_SIDEINFO = -7
    INVALID_SCALEFACT = -8
    INVALID_HUFFCODES = -9
    INVALID_DEQUANTIZE = -10
    INVALID_IMDCT = -11
    INVALID_SUBBAND = -12

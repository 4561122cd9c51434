"""FLAC result and metadata enums, with the reference library's values.

A copy of esp_audio_libs_tpu/utils/errors.py's FLAC enums (reference:
``include/flac_decoder.h:22-58``), so that the port imports nothing of the
JAX package. The two packages' values are equal, so results compare across
them.
"""

from __future__ import annotations

import enum

__all__ = ["FLACDecoderResult", "FLACMetadataType"]


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

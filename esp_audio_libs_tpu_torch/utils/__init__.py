"""Result and metadata enums of the port."""

from .errors import (FLACDecoderResult, FLACMetadataType, MP3Error,  # noqa: F401
                     WAVDecoderResult, WAVDecoderState)

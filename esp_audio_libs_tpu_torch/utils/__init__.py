"""Result and metadata enums of the port."""

from .errors import FLACDecoderResult, FLACMetadataType  # noqa: F401

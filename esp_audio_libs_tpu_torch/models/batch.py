"""Batched multi-stream FLAC decoding: the port's data-parallel serving
layer, the counterpart of ``BatchedFLACDecoder`` in
esp_audio_libs_tpu/models/batch.py.

The reference is one decoder instance per stream and leaves parallelism to
the caller. Here each stream keeps its own native bitstream front-end on the
host, and every stream's frames fold into the lane axis of the shared frame
kernel, so one launch decodes a bucket of frames from the whole fleet.
"""

from __future__ import annotations

from ..runtime.kernels import entry_device
from .flac import (FLACDecoder, _decode_streams, decode_streams_to_device,
                   decode_streams_to_device_grouped)

__all__ = ["BatchedFLACDecoder"]


class BatchedFLACDecoder:
    """Decode many independent FLAC streams with shared batched kernels.

    Each stream has its own host front-end (sync, header and Rice parsing
    are bitstream-serial); frames from all streams are bucketed by kernel
    shape and each bucket runs as one launch of the same kernel the
    single-stream ``FLACDecoder.decode_stream`` uses, so outputs are
    bit-identical to decoding each stream alone.

    Args:
      n_streams: number of stream slots.
      device: ``"cuda"`` (the default) or ``"cpu"``; ``"cuda"`` without a
        usable card raises. There is no mesh: one device decodes the fleet.
    """

    def __init__(self, n_streams: int, *, device="cuda"):
        self.device = entry_device(device, "BatchedFLACDecoder")
        self.decoders = [FLACDecoder(device=self.device) for _ in range(n_streams)]

    def read_headers(self, blobs):
        """Parse headers for all streams; returns a list of FLACDecoderResult."""
        return [d.read_header(b) for d, b in zip(self.decoders, blobs)]

    def reset_stream(self, s: int) -> None:
        """Recycle slot ``s`` for a new stream: FLAC carries all per-stream
        state in the host front-end (the frame kernel is stateless), so a
        fresh decoder is the whole reset; read the new stream's header with
        ``self.decoders[s].read_header(blob)`` next."""
        self.decoders[s] = FLACDecoder(device=self.device)

    def decode_streams(self, buffers, verify_md5: bool = True):
        """Decode all streams' frame sections (the bytes after the header).

        Args:
          buffers: per-stream bytes (None skips a stream).
        Returns: per-stream (pcm_bytes, results-dict) like
          ``FLACDecoder.decode_stream``.
        """
        return _decode_streams(self.decoders, buffers, verify_md5, device=self.device)

    def decode_streams_to_device(self, buffers):
        """Uniform-fleet decode leaving the packed PCM on the device: the
        composition path for decode -> resample chains (see
        ``models.flac.decode_streams_to_device``)."""
        return decode_streams_to_device(self.decoders, buffers, device=self.device)

    def decode_streams_to_device_grouped(self, buffers):
        """Mixed-fleet decode leaving PCM on the device, grouped by
        frame-shape signature (``models.flac.decode_streams_to_device_grouped``)."""
        return decode_streams_to_device_grouped(self.decoders, buffers, device=self.device)

    # ---------------------------------------------------------- checkpoint
    def get_state(self) -> dict:
        """Serializable snapshot of the whole fleet, the JAX package's dict:
        FLAC carries all per-stream state in the host front-end, so the
        snapshot is the per-stream state list. Restore with
        :meth:`set_state` into a ``BatchedFLACDecoder`` (of either package)
        of the same width."""
        return {"streams": [d.get_state() for d in self.decoders]}

    def set_state(self, state: dict) -> None:
        if len(state["streams"]) != len(self.decoders):
            raise ValueError(
                f"state holds {len(state['streams'])} streams, decoder has "
                f"{len(self.decoders)}")
        for d, s in zip(self.decoders, state["streams"]):
            d.set_state(s)

"""Dispatch-slice sizing, the int8 escape sideband and the overlapped host
parse shared by the FLAC and MP3 serving paths.

A torch-free and JAX-free copy of the parts of
esp_audio_libs_tpu/runtime/transport.py that the port needs. The port
dispatches slices serially: each slice uploads from pinned host memory with
``non_blocking=True`` on the current stream and, on the host-returning path,
downloads into pinned memory. The host parse of later streams still
overlaps the dispatch of earlier ones (``overlapped_parse``).
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np

__all__ = ["SLICE_OUT_BYTES", "MP3_SLICE_PCM_BYTES", "ESC_MAX_DENSITY",
           "escape_sideband_blocked", "overlapped_parse"]

# target PCM bytes per dispatch slice (the JAX package's value)
SLICE_OUT_BYTES = 8 << 20

# target PCM bytes per MP3 sub-fleet dispatch: the stream-axis slicing of a
# format group's granule run (the JAX package's value); tests shrink it
MP3_SLICE_PCM_BYTES = 8 << 20

# escape-density ceiling for the int8 + sideband transport tiers (FLAC
# residuals, MP3 spectral planes): each escape costs 6 or 8 sideband bytes
# (an int32 position, an int16 or int32 value) against the 1 byte per word
# the narrower plane saves, so the break-even is 1/8 to 1/6; 1/64 keeps the
# tier safely profitable.
ESC_MAX_DENSITY = 1.0 / 64.0


def escape_sideband_blocked(mask2d, vals2d, val_dtype):
    """Sparse (position, value) escape sidebands of an int8 transport plane
    cut into ``S`` blocks along its leading axis: ``mask2d``/``vals2d`` are
    the escape mask and the source values as ``[S, M]``, one row per block.
    Positions are sorted and local to the row, padded to one shared
    power-of-two capacity (at least 16); padding slots carry the
    out-of-range local index ``M``, which the fixup ignores. The FLAC and
    MP3 paths build one row per launch with it: one row on a single device
    (its positions are then the plane's flat ones), one per shard under a
    mesh.
    Returns ``(pos int32[S, cap], val val_dtype[S, cap])``.
    """
    S, M = mask2d.shape
    rows = [np.flatnonzero(m) for m in mask2d]     # one pass over the mask
    n_max = max((idx.size for idx in rows), default=0)
    cap = max(16, 1 << int(n_max - 1).bit_length()) if n_max else 16
    pos = np.full((S, cap), M, np.int32)
    val = np.zeros((S, cap), val_dtype)
    for s, idx in enumerate(rows):
        pos[s, :idx.size] = idx
        val[s, :idx.size] = vals2d[s, idx]
    return pos, val


@contextlib.contextmanager
def overlapped_parse(parse_call, n_streams: int):
    """Run ``parse_call(on_stream)`` with per-stream completion signals.

    Yields a queue that receives each completed stream id and a final
    ``None`` sentinel. With more than one stream the parse runs on a worker
    thread, so the consumer can dispatch completed streams' work while later
    streams still parse (the native parse releases the GIL); with one
    stream it runs inline. Exceptions from the parse are re-raised on
    context exit, after the consumer body: the sentinel is always
    delivered, so the consumer never blocks on a dead parser.
    """
    done_q: queue.Queue = queue.Queue()
    err = []

    def _job():
        try:
            parse_call(done_q.put)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            err.append(e)
        finally:
            done_q.put(None)

    if n_streams <= 1:
        _job()
        yield done_q
        if err:
            raise err[0]
        return

    t = threading.Thread(target=_job)
    t.start()
    try:
        yield done_q
    finally:
        t.join()
    if err:
        raise err[0]

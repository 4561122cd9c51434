"""Dispatch-slice sizing, the int8 escape sideband and the overlapped host
parse shared by the FLAC serving paths.

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

__all__ = ["SLICE_OUT_BYTES", "ESC_MAX_DENSITY", "escape_sideband", "overlapped_parse"]

# target PCM bytes per dispatch slice (the JAX package's value)
SLICE_OUT_BYTES = 8 << 20

# escape-density ceiling for the int8 + sideband transport tier of FLAC
# residuals: each escape costs 8 sideband bytes (int32 position and value)
# against the 1 byte per word the narrower plane saves, so the break-even
# is 1/8; 1/64 keeps the tier safely profitable.
ESC_MAX_DENSITY = 1.0 / 64.0


def escape_sideband(esc_flat_idx, flat_vals, oob_index: int, val_dtype):
    """Sparse (position, value) escape sideband for an int8 transport plane,
    sorted by position as ``esc_flat_idx`` is.

    Padded to a power-of-two capacity (at least 16); padding slots carry the
    out-of-range ``oob_index``, which the fixup ignores.
    Returns ``(pos int32[cap], val val_dtype[cap])``.
    """
    n_esc = int(esc_flat_idx.size)
    cap = max(16, 1 << int(n_esc - 1).bit_length()) if n_esc else 16
    pos = np.full(cap, oob_index, np.int32)
    val = np.zeros(cap, val_dtype)
    pos[:n_esc] = esc_flat_idx
    val[:n_esc] = flat_vals
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

"""Named spans of the program on the profiler's clock.

``with span("eal.<layer>"):`` marks a stretch of host time. Under any open
``torch.profiler.profile`` it is a ``record_function`` range, so it lies in
the trace beside the torch ops and the device events, on their clock. With no
profiler running it is one shared object whose ``__enter__`` and ``__exit__``
do nothing: a span then costs a flag check and builds nothing. The open
profiler is the only collector: nothing is kept or written here.

Every name starts with ``eal.``. A call's outermost span (``eal.resample_stream``,
``eal.mp3.decode_run``) holds the spans of that call in time, on one thread.
"""

from __future__ import annotations

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A span named ``name`` while a profiler runs, else a shared no-op."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN

"""ISO/IEC 11172-3 constant tables of the MP3 decoder.

The tables come from ``build/mp3_tables.npz``, which
runtime/native.py::_mp3_headers copies from the committed
``native/gen/mp3_tables.npz`` (the artifact the JAX package extracts from
the reference source). The fixed-point math reads signed views: uint32
tables as int32 bit patterns, the small integer tables widened to int32.
"""

from __future__ import annotations

import functools

import numpy as np

from .native import REPO, _mp3_headers

NPZ = REPO / "build" / "mp3_tables.npz"


@functools.lru_cache(None)
def mp3_tables() -> dict:
    if not NPZ.exists():
        _mp3_headers()
    out = {}
    for k, v in np.load(NPZ).items():
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        elif v.dtype in (np.uint16, np.uint8, np.int8, np.int16):
            v = v.astype(np.int32)
        out[k] = v
    return out

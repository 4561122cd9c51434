"""The FLAC frame kernel's coverage fleet: real parsed buckets and every
specialisation each can run at, for holding ``flac_frame_cuda`` to
``flac_frame_plain`` byte for byte.

One definition serves ``chip_smoke.py`` (phase 6) and the ``cuda`` test of
``tests/test_torch_kernels.py``. It needs numpy, torch and the port, never
JAX. Run from the repository root (or with ``tools/`` on ``sys.path``):

    from flac_kernel_fleet import COVERAGE, coverage, fleet_buckets, kernel_variants
    buckets = fleet_buckets("cuda")
    assert not missing(coverage(buckets))
    for bkey, arrays, kw in buckets:
        for label, plane, esc, kwv in kernel_variants(arrays, kw): ...
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import flacgen as fg  # noqa: E402

__all__ = ["COVERAGE", "coverage", "fleet_blobs", "fleet_buckets", "kernel_variants",
           "missing", "on_device"]

# what the fleet and its variants must reach: depths, channel counts,
# channel assignments, the 32-bit mode, residual planes, order classes,
# accumulators, and rows of 16-byte multiples and not
COVERAGE = {"depth": {8, 12, 16, 20, 24, 32}, "nch": {1, 2, 3, 8},
            "ca": {0, 1, 2, 7, 8, 9, 10}, "mode32": {False, True},
            "plane": {"int8", "int16", "int32", "int8+esc"}, "W": {4, 8, 12, 16, 32},
            "use64": {False, True}, "rows16": {False, True}}


def fleet_blobs():
    """Small flacgen streams covering the kernel's cases; returns (blobs,
    the index from which streams decode in the 32-bit mode). The last two
    streams repeat two earlier ones in that mode."""
    P = fg.SubframePlan
    cfgs = [
        dict(rng_seed=1, depth=8, channels=1, block_size=256, n_frames=3, last_block_size=253,
             plans=[[P("lpc", order=3)], [P("fixed", order=4)], [P("lpc", order=2)]]),
        dict(rng_seed=2, depth=12, channels=2, block_size=512, n_frames=4, last_block_size=999,
             stereo_modes=[None, "ls", "rs", "ms"],
             plans=[[P("lpc", order=8, fit=True), P("lpc", order=6, fit=True)]] * 4),
        dict(rng_seed=3, depth=16, channels=2, block_size=1152, n_frames=3,
             plans=[[P("lpc", order=8, fit=True), P("lpc", order=12, fit=True)]] * 3),
        dict(rng_seed=4, depth=16, channels=2, block_size=576, n_frames=2,
             plans=[[P("lpc", order=16), P("fixed", order=2, wasted=2)]] * 2),
        dict(rng_seed=5, depth=20, channels=3, block_size=1152, n_frames=2, last_block_size=1001,
             plans=[[P("lpc", order=32, precision=15, shift=14), P("verbatim"),
                     P("fixed", order=3)]] * 2),
        dict(rng_seed=6, depth=24, channels=2, block_size=1024, n_frames=2,
             stereo_modes=["rs", None],
             plans=[[P("lpc", order=20, fit=True), P("lpc", order=32, fit=True)]] * 2),
        dict(rng_seed=7, depth=32, channels=2, block_size=256, n_frames=2,
             plans=[[P("lpc", order=8, wasted=2), P("verbatim")]] * 2),
        dict(rng_seed=8, depth=16, channels=8, block_size=256, n_frames=2,
             plans=[[P("lpc", order=4, fit=True)] * 8, [P("fixed", order=2)] * 8]),
    ]
    blobs = [fg.make_flac(**c)[0] for c in cfgs]
    return blobs + [blobs[1], blobs[5]], len(blobs)


def fleet_buckets(device):
    """Every shape bucket of the fleet as the host parse leaves it:
    a list of ``(bkey, arrays, kw)`` (``models.flac.parsed_buckets``), parsed
    by decoders of ``device``."""
    from esp_audio_libs_tpu_torch.models import FLACDecoder
    from esp_audio_libs_tpu_torch.models.flac import parsed_buckets
    blobs, mode32_from = fleet_blobs()
    decs, bodies = [], []
    for i, blob in enumerate(blobs):
        d = FLACDecoder(device=device)
        if d.read_header(blob) != 0:
            raise ValueError(f"fleet stream {i}: read_header failed")
        d.set_output_32bit_samples(i >= mode32_from)
        decs.append(d)
        bodies.append(blob[d.get_bytes_index():])
    return list(parsed_buckets(decs, bodies))


def kernel_variants(arrays, kw):
    """Every specialisation one real bucket can take, as (label, plane,
    escapes or None, kernel kwargs): each order class that covers its orders,
    the 32-bit accumulator where the front-end cleared it and the 64-bit one
    always, and the plane at its width and every wider one (an escape-tier
    plane also as the int16 and int32 planes it stands for)."""
    data = arrays[0]
    base = {k: v for k, v in kw.items() if k not in ("esc_pos", "esc_val")}
    if "esc_pos" in kw:
        pos, val = kw["esc_pos"], kw["esc_val"]
        wide = data.astype(np.int32).reshape(-1)
        live = pos < wide.size
        wide[pos[live]] = val[live]
        wide = wide.reshape(data.shape)
        planes = [("int8+esc", data, (pos, val)), ("int16", wide.astype(np.int16), None),
                  ("int32", wide, None)]
    else:
        widths = [np.int8, np.int16, np.int32]
        planes = [(np.dtype(w).name, data.astype(w), None)
                  for w in widths[widths.index(data.dtype.type):]]
    classes = [c for c in (4, 8, 12, 16, 32) if c >= kw["max_order"]]
    for name, plane, esc in planes:
        for W in classes:
            for acc in ([True] if kw["use64"] else [False, True]):
                yield f"{name} W={W} use64={acc}", plane, esc, dict(base, max_order=W, use64=acc)


def coverage(buckets):
    """What ``buckets`` and their :func:`kernel_variants` reach, keyed as
    :data:`COVERAGE`; launches nothing."""
    cover = {k: set() for k in COVERAGE}
    for _, arrays, kw in buckets:
        cover["depth"].add(kw["depth"])
        cover["nch"].add(kw["nch"])
        cover["mode32"].add(kw["mode32"])
        cover["ca"].update(int(c) for c in np.unique(arrays[5]))
        for label, plane, _, kwv in kernel_variants(arrays, kw):
            cover["plane"].add(label.split()[0])
            cover["W"].add(kwv["max_order"])
            cover["use64"].add(kwv["use64"])
            cover["rows16"].add(plane.shape[-1] * plane.itemsize % 16 == 0)
    return cover


def missing(cover):
    """The cases of :data:`COVERAGE` that ``cover`` lacks, by key."""
    return {k: sorted(v - cover[k]) for k, v in COVERAGE.items() if not v <= cover[k]}


def on_device(arrays, kw, device):
    """A bucket's operands as tensors on ``device``: (tensors, kwargs)."""
    kw = {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays], kw

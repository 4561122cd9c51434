"""The work of the fast resampler's banded contraction, and its roofline share
over the kernels that carry it.

The least time of a launch counts what the math needs, whatever implements
it: the operands and the outputs moved once, and one FP32 multiply-add a tap
of the folded filter row for each generated output. The kernel's 3xTF32
passes, its band skipping and the band-range pass it launches first
(``csrc/band_ranges.cu``) are not work the math needs: their time is in the
denominator, not in the count.
"""

from __future__ import annotations

import re

from perfbench import yardstick

TILE = 128          # output columns of a weight tile (ops/polyphase.py::TILE)


def polyphase_banded_work(M: int, L: int, nt: int, ntw: int, K: int, T: int, gen: int,
                          taps_p: int) -> tuple[int, int]:
    """(bytes, FP32 operations) of one banded contraction: xext f32 [M, L],
    the ``ntw`` distinct weight tiles f32 [K, 128], the ``nt`` int32 tile
    starts and the outputs f32 [M, T], each moved once; 2 operations (one
    multiply-add) a tap of the ``taps_p``-long folded row for each of the
    ``gen`` generated outputs of every row."""
    nbytes = (M * L + ntw * K * TILE + nt + M * T) * 4
    return nbytes, 2 * M * gen * taps_p


def roofline_share(trace, kernel_names, launches, log=None) -> float | None:
    """The share of the roofline, in %, of work that every launch spreads
    over the kernels ``kernel_names`` (one device event of each a launch):
    the least time of ``launches`` ((bytes, operations, peak operations/s)
    each) over the summed device time of those kernels' launches.

    A kernel's device time is its events' mean time a launch, times the
    launches. The profiler can drop the device events of the window's last
    call when it stops (seen on the H100: a trace whose last device event
    ended 15 ms, about one call, before the window), so up to two calls'
    launches may lack their event. None without launches, and where a
    kernel has more events than launches or lacks more than two calls'.
    With ``log``, each kernel's count of events and launches is written
    there."""
    if trace is None or not launches:
        return None
    per_call = -(-len(launches) // max(trace.calls, 1))
    device_s = 0.0
    for name in kernel_names:
        events = [(s, e) for s, e, n in trace.device if re.search(rf"\b{name}\b", n)]
        if log is not None:
            print(f"perfbench: {name}: {len(events)} device events, {len(launches)} launches",
                  file=log)
        if not events or len(events) > len(launches) or len(launches) - len(events) > 2 * per_call:
            return None
        device_s += sum(e - s for s, e in events) / len(events) * len(launches) / 1e9
    least = sum(yardstick.bound_s(b, o, p) for b, o, p in launches)
    return 100.0 * least / device_s

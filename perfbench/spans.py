"""The program's own spans in a trace, per call of the window.

The program marks its layers with ``eal.``-named spans
(``esp_audio_libs_tpu_torch/runtime/trace.py``); under the profiler they are
host events of ``yardstick.Trace.host``, on the clock of the benchmark's
``perfbench.call`` spans. A program span belongs to the call whose span
holds it in time. The readers of ``metrics/`` that read program spans use
:func:`per_call`.
"""

from __future__ import annotations

import bisect

from perfbench import yardstick

CALL = yardstick.SPAN_PREFIX + "call"
PROGRAM_PREFIX = "eal."


def per_call(trace) -> list[list[tuple[int, int, str]]]:
    """For each call span of ``trace``, the program spans it holds:
    ``(start_ns, end_ns, name)`` each. [] when the trace holds no call
    span, and when it holds no device event: a run without the card, whose
    host times are not those of the card's host."""
    if trace is None or not trace.device:
        return []
    calls = [(s, e) for s, e, n in trace.host if n == CALL]
    program = [h for h in trace.host if h[2].startswith(PROGRAM_PREFIX)]
    starts = [h[0] for h in program]
    out = []
    for cs, ce in calls:
        i, inside = bisect.bisect_left(starts, cs), []
        while i < len(program) and program[i][0] <= ce:
            if program[i][1] <= ce:
                inside.append(program[i])
            i += 1
        out.append(inside)
    return out


def union_ns(spans) -> int:
    """The ns that at least one of ``spans`` covers."""
    total, end = 0, None
    for s, e, *_ in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def ms_per_call(calls, name: str) -> float | None:
    """The mean ms per call that the spans named ``name`` cover; None when
    no call holds one."""
    if not any(n == name for c in calls for *_, n in c):
        return None
    return sum(union_ns([h for h in c if h[2] == name]) for c in calls) / 1e6 / len(calls)

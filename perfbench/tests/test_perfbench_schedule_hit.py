"""The reader of ``schedule_hit_share`` on hand-built traces: the share of
call spans that hold an ``eal.schedule.hit`` span."""

from __future__ import annotations

import pytest

from perfbench import harness, yardstick

MS = 1_000_000


def _read(trace):
    reader = harness.load_module(harness.ROOT / "metrics" / "schedule_hit_share.py",
                                 "test_metric_schedule_hit_share")
    return reader.read(harness.Record(setup_s=0.0, trace=trace), None)


def _calls(hit_in):
    """Four calls of 10 ms, each with a tail build; those in ``hit_in`` also
    take over a schedule at their head. A hit between calls counts for none."""
    host = [(12 * MS, 13 * MS, "eal.schedule.hit")]
    for i in range(4):
        t = 20 * MS * i
        host += [(t, t + 10 * MS, "perfbench.call"), (t + 1, t + 9 * MS, "eal.resample_stream"),
                 (t + 7 * MS, t + 8 * MS, "eal.schedule")]
        if i in hit_in:
            host.append((t + MS, t + MS + 5_000, "eal.schedule.hit"))
    return sorted(host)


def _trace(host, device=((0, 1, "a kernel"),)):
    return yardstick.Trace(device, host, 0, 80 * MS, 4)


@pytest.mark.parametrize("hit_in, want", [((0, 1, 2, 3), 100.0), ((1, 3), 50.0),
                                          ((2,), 25.0)])
def test_share_of_calls_with_a_hit(hit_in, want):
    assert _read(_trace(_calls(hit_in))) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no card", "no hit span", "no trace", "no call span"])
def test_reports_nothing_without_its_spans(case):
    """Without the card, from a program with no hit span (one that builds at
    each call's head), without a trace or without the call spans: None."""
    trace = {"no card": _trace(_calls((0, 1, 2, 3)), device=()),
             "no hit span": _trace([h for h in _calls((0, 1, 2, 3))
                                    if h[2] != "eal.schedule.hit"]),
             "no trace": None,
             "no call span": _trace([h for h in _calls((0, 1, 2, 3))
                                     if h[2] != "perfbench.call"])}[case]
    assert _read(trace) is None

"""The readers of the program's spans (``perfbench/spans.py`` and the four
metrics over it) on hand-built traces, and traced tiny runs on the CPU: the
resampler cells' spans, read as a card's trace would be, and the MP3 run's
decode spans."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness, spans, yardstick

from .conftest import REPO, TINY_CELLS

MS = 1_000_000
READERS = ("host_ms_per_call", "schedule_ms_per_call", "launch_ms_per_call",
           "launches_per_call")


def _read(name: str, trace):
    reader = harness.load_module(harness.ROOT / "metrics" / f"{name}.py", f"test_metric_{name}")
    return reader.read(harness.Record(setup_s=0.0, trace=trace), None)


def _trace(host, device=((0, 1, "a kernel"),)):
    return yardstick.Trace(device, host, 0, 40 * MS, 2)


# Two calls. The first: an unpack that starts before the call's outer span
# (the stretch from 1 to 1.5 ms is covered twice), two launches, and a wait
# that ends the call. The second: one launch and a wait. A wait between the
# calls and a torch op belong to no reading.
CALLS = [
    (0, 10 * MS, "perfbench.call"),
    (int(0.5 * MS), int(1.5 * MS), "eal.unpack"),
    (1 * MS, 9 * MS, "eal.resample_stream"),
    (1 * MS, 2 * MS, "eal.schedule"),
    (3 * MS, int(3.5 * MS), "eal.launch"),
    (3 * MS, int(3.4 * MS), "aten::copy_"),
    (4 * MS, int(4.5 * MS), "eal.launch"),
    (7 * MS, 9 * MS, "eal.wait"),
    (12 * MS, 13 * MS, "eal.wait"),
    (20 * MS, 30 * MS, "perfbench.call"),
    (21 * MS, 25 * MS, "eal.resample_stream"),
    (21 * MS, int(21.5 * MS), "eal.schedule"),
    (22 * MS, int(22.2 * MS), "eal.launch"),
    (24 * MS, 25 * MS, "eal.wait"),
]


@pytest.mark.parametrize("name, want", [
    ("host_ms_per_call", ((9 - 0.5 - 2) + (4 - 1)) / 2),
    ("schedule_ms_per_call", (1 + 0.5) / 2),
    ("launch_ms_per_call", (1.0 + 0.2) / 2),
    ("launches_per_call", 3 / 2)])
def test_reader_on_known_spans(name, want):
    assert _read(name, _trace(CALLS)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no trace", "no call span", "no program span",
                                  "no device event"])
def test_reader_without_its_spans_reports_nothing(name, case):
    """No trace, a trace without the benchmark's call spans, one whose
    program has no spans (a program before spans), or one without the card
    read as None."""
    trace = {"no trace": None,
             "no call span": _trace([h for h in CALLS if h[2] != "perfbench.call"]),
             "no program span": _trace([h for h in CALLS if not h[2].startswith("eal.")]),
             "no device event": _trace(CALLS, device=())}[case]
    assert _read(name, trace) is None


def test_launch_readers_without_launches_report_nothing():
    """Without ``eal.launch`` spans (the plain kernels on the CPU) only the
    launch readers are silent."""
    trace = _trace([h for h in CALLS if h[2] != "eal.launch"])
    assert _read("launch_ms_per_call", trace) is None
    assert _read("launches_per_call", trace) is None
    assert _read("schedule_ms_per_call", trace) == pytest.approx(0.75)


def test_union_counts_a_double_covered_stretch_once():
    assert spans.union_ns([(0, 4, "a"), (2, 6, "b"), (8, 9, "c"), (3, 5, "d")]) == 7


SPAN_RUNNER = """
import json, sys, time
t = time.perf_counter()
root, repo, workload, seconds = sys.argv[1:5]
sys.path[:0] = [root]
sys.path.append(repo)
from pathlib import Path
from perfbench import harness, yardstick
traces = []
reduce = yardstick.trace_from_profiler
yardstick.trace_from_profiler = lambda *a: traces.append(reduce(*a)) or traces[-1]
rc = harness.run(Path(root), workload, 2 ** 31 + 11, float(seconds), True, t_process=t,
                 device="cpu")
tr = traces[0]
print(json.dumps({"rc": rc, "device": tr.device, "calls": tr.calls,
                  "host": [h for h in tr.host if h[2].startswith(("eal.", "perfbench."))]}))
"""


def _traced_spans(root, workload: str, seconds: float):
    """The result line and the trace's spans of a traced CPU run."""
    proc = subprocess.run([sys.executable, "-c", SPAN_RUNNER, str(root), str(REPO), workload,
                           str(seconds)], capture_output=True, text=True, timeout=600, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["rc"] == 0
    return json.loads(lines[-2]), out


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_traced_tiny_cell_spans_feed_host_readers(bench_copy, cell):
    """A traced CPU run leaves the four readers out (no card), and its
    spans, read as a card's trace with a device event, give the host
    readers and, with no hand kernel launched, not the launch readers."""
    res, out = _traced_spans(bench_copy, cell, 0.3)
    assert res["correct"] is True
    assert out["device"] == [] and not set(res["metrics"]) & set(READERS)
    trace = yardstick.Trace([(0, 1, "a kernel")], [tuple(h) for h in out["host"]],
                            0, 1, out["calls"])
    got = {name: _read(name, trace) for name in READERS}
    assert got["launch_ms_per_call"] is None and got["launches_per_call"] is None
    assert 0 < got["schedule_ms_per_call"] < got["host_ms_per_call"]


MP3_SPANS = ("eal.mp3.parse", "eal.mp3.arrays", "eal.mp3.operands", "eal.mp3.upload")


def test_traced_mp3_run_holds_decode_spans(bench_copy):
    """Every traced ``decode_run`` of the tiny MP3 cell holds the parse,
    run arrays, operands and upload spans, nested in time inside it."""
    _, out = _traced_spans(bench_copy, "tiny_mp3", 1.0)
    host = out["host"]
    runs = [(s, e) for s, e, n in host if n == "eal.mp3.decode_run"]
    assert runs
    for rs, re_ in runs:
        inside = {n for s, e, n in host if rs <= s and e <= re_}
        assert set(MP3_SPANS) <= inside

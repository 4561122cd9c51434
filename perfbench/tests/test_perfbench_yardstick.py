"""The yardstick's arithmetic against hand counts: the rate over the whole
window, the 95th percentile over all calls, the roofline bytes and
operations at chip_smoke.py's shapes, and the trace reduction."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import yardstick as y

from .conftest import REPO


def test_rate_is_all_work_over_all_time():
    calls = [(10.0, 10.5), (10.5, 11.0), (11.25, 12.0)]
    per_call = 1_000_000
    assert y.rate(per_call * len(calls), calls[0][0], calls[-1][1]) == pytest.approx(1.5e6)


def test_p95_over_every_call():
    ms = list(range(1, 101))                       # 1 .. 100 ms
    assert y.percentile(ms, 95) == pytest.approx(95.05)   # (100 - 1) * 0.95 = 94.05 -> 95.05
    assert y.percentile([3.0], 95) == 3.0
    assert y.percentile([1.0, 2.0], 50) == 1.5


def test_biquad_work_main_shape():
    """chip_smoke.biquad_timing at [2048, 2, 8192]: 268,566,548 bytes,
    0.0802 ms at 3.35 TB/s; 9 operations a sample."""
    nbytes, ops = y.biquad_work(4096, 8192)
    assert nbytes == 2 * 4096 * 8192 * 4 + 8 * 4096 * 4 + 20 == 268_566_548
    assert ops == 9 * 4096 * 8192
    assert y.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.08017, abs=1e-5)


def test_polyphase_work_main_shape():
    """chip_smoke.polyphase_work at [4096, 8264] -> 2981: 184,306,148 bytes;
    a two-row output costs 4 operations a tap and 4 for the lerp."""
    nbytes, ops = y.polyphase_exact_work(4096, 8264, 2981, 33, 64, 0, 2808)
    assert nbytes == (4096 * 8264 + 33 * 64 + 5 * 2981 + 4096 * 2981) * 4 == 184_306_148
    assert ops == 4096 * 2808 * (4 * 64 + 4)
    one = y.polyphase_exact_work(1, 100, 3, 33, 64, 1, 1)[1]
    assert one == 2 * 64 + 4 * 64 + 4


def test_trace_busy_gaps_and_labels():
    dev = [(100, 200, "k1"), (150, 250, "k2"), (400, 450, "k1"), (900, 1000, "x")]
    host = [(0, 1000, "outer"), (260, 390, "aten::cat"), (300, 310, "aten::empty")]
    t = y.Trace(dev, host, 50, 600, calls=2)
    assert t.busy_intervals() == [[100, 250], [400, 450]]
    assert t.busy_s == pytest.approx(200e-9)
    assert t.window_s == pytest.approx(550e-9)
    assert t.gaps() == [(50, 100), (250, 400), (450, 600)]
    assert t.by_name() == {"k1": [2, pytest.approx(150e-9)], "k2": [1, pytest.approx(100e-9)]}
    assert t.host_label(325) == "aten::cat"
    assert t.host_label(305) == "aten::empty"
    labels = dict(t.idle_by_host())
    assert labels["outer"] == pytest.approx(200e-9) and labels["aten::cat"] == pytest.approx(150e-9)


def test_roofline_share_needs_every_launch():
    t = y.Trace([(0, 1000, "void polyphase_exact_kernel(PolyArgs)"), (0, 5, "other")], [],
                0, 2000, calls=1)
    work = (3.35e6, 0.0, y.PEAK_FP32)          # 1 us at 3.35 TB/s
    assert y.roofline_share(t, "polyphase_exact_kernel", [work]) == pytest.approx(100.0)
    assert y.roofline_share(t, "polyphase_exact_kernel", [work, work]) is None
    assert y.roofline_share(t, "recurrence_kernel", [work]) is None


def test_hand_kernels_are_read_from_the_sources():
    names = y.hand_kernels(REPO / "esp_audio_libs_tpu_torch" / "csrc")
    assert {"recurrence_kernel", "polyphase_exact_kernel", "mp3_granules_kernel"} <= names
    assert y.is_hand("(anonymous namespace)::recurrence_kernel(RecArgs)", names)
    assert not y.is_hand("void at::native::vectorized_elementwise_kernel<4>", names)


def test_mp3_granules_work_by_hand():
    """One stream, one granule: 10 lines of magnitude 1-15 and 2 of 16-63 in
    channel 0 spanning 40 lines, channel 1 silent."""
    stats = np.zeros((1, 1, 2, 4), np.int64)
    stats[0, 0, 0] = (10, 2, 0, 40)
    nbytes, ops = y.mp3_granules_work(stats, 1)
    blocks = [(40 + 7) // 18 + 1, 1]                  # 3 and 1 IMDCT blocks
    want = (10 * 12 + 2 * 18 + 40 * 10 + 40 * 2 * 4 + (blocks[0] - 1 + blocks[1] - 1) * 8 * 8
            + sum(blocks) * 260 + 2 * 18 * 408 + 2 * 576 * 38)
    assert ops == want
    assert nbytes == 2 * 576 * 2 + 2 * 16 + 2 * (576 + 6 + 2176) * 4 + 2 * 576 * 2

"""The fast-tier cells (``configs/pcm_resample_fast.json``,
``drivers/resample_fast.py``) on the CPU at a tiny size: correct within the
tier's limits, the bfloat16 control and planted faults not correct, and the
banded contraction's work and roofline share against hand counts."""

from __future__ import annotations

import json
import shutil
import types

import pytest

from perfbench import banded_work, yardstick

from .conftest import REPO, TINY, add_cell, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "esp_audio_libs_tpu"}
CELLS = ("tiny_fast", "tiny_fast_hot")


@pytest.fixture(scope="module")
def fast_copy(tmp_path_factory):
    """A copy of BENCHMARK.json and perfbench/ with two tiny cells of the
    fast configuration: the down traffic cut to TINY, and the same with
    every stream hot and 1024-frame chunks, so that the quantizer clips."""
    root = tmp_path_factory.mktemp("fast")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = "pcm_44k1_to_16k_b2048"
    signal = json.loads((root / "perfbench" / "traffic" / f"{base}.json").read_text())["signal"]
    add_cell(root, "tiny_fast", base, config="pcm_resample_fast", **TINY)
    add_cell(root, "tiny_fast_hot", base, config="pcm_resample_fast",
             **dict(TINY, chunk_frames=1024, signal=dict(signal, hot_share=1.0)))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_fast_cell_runs_correct(fast_copy, cell):
    res, proc, err = run_cell(fast_copy, cell)
    assert proc["rc"] == 0
    assert res["correct"] is True, err[-2000:]
    assert set(res["checks"]) == {"max_output_gap_lsb", "differing_state_words",
                                  "clip_count_excess"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert res["checks"]["max_output_gap_lsb"]["limit"] == 1
    assert set(res["metrics"]) == {"setup_s", "input_msamples_per_s", "call_ms_p95"}
    tops = {m.split(".")[0] for m in proc["modules"]}
    assert not tops & FORBIDDEN
    assert "esp_audio_libs_tpu_torch" in tops


def test_control_breaks_every_limit(fast_copy):
    """The reference in bfloat16 in the program's place fails each of the
    three compared numbers where streams clip."""
    res, _, _ = run_cell(fast_copy, "tiny_fast_hot", control="bfloat16")
    assert res["correct"] is False
    assert all(c["value"] > c["limit"] for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_is_caught(fast_copy, fault):
    res, _, _ = run_cell(fast_copy, "tiny_fast", fault=fault)
    assert res["correct"] is False
    assert res["checks"]["max_output_gap_lsb"]["value"] > 1
    if fault == "state_unchanged":
        assert res["checks"]["differing_state_words"]["value"] > 0


def test_banded_work_by_hand():
    """Two rows of a 256-sample slab, two 128-row weight tiles, 200 outputs a
    row of which 190 generated, a 10-tap folded row."""
    nbytes, ops = banded_work.polyphase_banded_work(2, 256, 2, 2, 128, 200, 190, 10)
    assert nbytes == (2 * 256 + 2 * 128 * 128 + 2 + 2 * 200) * 4 == 134_728
    assert ops == 2 * 2 * 190 * 10 == 7_600
    # one shared weight tile (a tile stride of 0) is moved once
    assert banded_work.polyphase_banded_work(2, 256, 2, 1, 128, 200, 190, 10)[0] == (
        nbytes - 128 * 128 * 4)


def _rec(events, launches, calls=1):
    trace = yardstick.Trace(events, [], 0, 10_000, calls=calls)
    return types.SimpleNamespace(
        trace=trace, launches={"polyphase_banded": launches},
        kernel_names={"polyphase_banded": ("polyphase_banded_kernel", "band_ranges_kernel")})


def test_roofline_reader_sums_both_kernels():
    """The least time over the two kernels' summed device time; where the
    profiler dropped up to two calls' events, each kernel's mean event time
    stands for its lost launches; no reading where a kernel lacks its
    events, lacks more than two calls', or has more events than launches."""
    import io
    from perfbench import harness
    reader = harness.load_module(harness.ROOT / "metrics" / "roofline.polyphase_banded.py",
                                 "perfbench_metric_roofline.polyphase_banded")
    work = (3.35e6, 0.0, yardstick.PEAK_FP32)          # 1 us at 3.35 TB/s
    events = [(0, 1500, "void (anonymous namespace)::polyphase_banded_kernel(float const*)"),
              (1500, 2000, "void band_ranges_kernel(float const*, long long, int, int*)"),
              (2000, 2100, "void at::native::vectorized_elementwise_kernel<4>")]
    log = io.StringIO()
    assert reader.read(_rec(events, [work]), types.SimpleNamespace(log=log)) == (
        pytest.approx(50.0))
    assert log.getvalue().splitlines() == [
        "perfbench: polyphase_banded_kernel: 1 device events, 1 launches",
        "perfbench: band_ranges_kernel: 1 device events, 1 launches"]
    assert reader.read(_rec(events, [work] * 3, calls=3), None) == pytest.approx(50.0)
    assert reader.read(_rec(events, [work] * 4, calls=4), None) is None
    assert reader.read(_rec(events + [(3000, 4500, events[0][2])], [work]), None) is None
    assert reader.read(_rec(events[:1], [work]), None) is None
    assert reader.read(_rec(events, []), None) is None

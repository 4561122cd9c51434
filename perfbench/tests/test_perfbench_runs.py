"""Whole runs of the harness on the CPU at a tiny size: cells found by
their files, the result line, the comparison's control and the faults it
has to catch, and a cell, a configuration and metrics added as files."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import REPO, TINY, add_cell, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "esp_audio_libs_tpu"}


@pytest.mark.parametrize("cell", ["tiny_down", "tiny_up"])
def test_tiny_cell_runs_correct(bench_copy, cell):
    res, proc, err = run_cell(bench_copy, cell)
    assert proc["rc"] == 0
    assert res["correct"] is True, err[-2000:]
    assert set(res["metrics"]) == {"setup_s", "input_msamples_per_s", "call_ms_p95"}
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    tops = {m.split(".")[0] for m in proc["modules"]}
    assert not tops & FORBIDDEN
    assert "esp_audio_libs_tpu_torch" in tops


def test_traced_run_has_breakdown(bench_copy):
    res, _, _ = run_cell(bench_copy, "tiny_down", trace=True)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert "idle_gaps" in res["breakdown"] and "device_ops" in res["breakdown"]
    assert res["metrics"] == {}        # a CPU run has no device events to read


def test_control_fails(bench_copy):
    """The reference in bfloat16 in the program's place is not correct."""
    res, _, _ = run_cell(bench_copy, "tiny_down", control="bfloat16")
    assert res["correct"] is False
    assert res["checks"]["differing_output_values"]["value"] > 0
    assert res["checks"]["differing_state_words"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", ["tiny_down", "tiny_up"])
def test_fault_is_caught(bench_copy, cell, fault):
    res, _, _ = run_cell(bench_copy, cell, fault=fault)
    assert res["correct"] is False
    assert res["checks"]["differing_output_values"]["value"] > 0
    if fault == "state_unchanged":
        assert res["checks"]["differing_state_words"]["value"] > 0


def test_mp3_cell_runs_correct(bench_copy):
    res, proc, err = run_cell(bench_copy, "tiny_mp3", seconds=1.0)
    assert res["correct"] is True, err[-2000:]
    assert set(res["metrics"]) == {"setup_s", "decoded_msamples_per_s"}
    assert res["checks"]["resampled_gap_lsb"]["value"] <= 1
    tops = {m.split(".")[0] for m in proc["modules"]}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("fault", ["control", "state_unchanged", "half_batch", "altered_answer"])
def test_mp3_fault_is_caught(bench_copy, fault):
    """The bfloat16 control and each planted fault come out not correct."""
    res, _, _ = run_cell(bench_copy, "tiny_mp3", seconds=1.0,
                         control="bfloat16" if fault == "control" else None,
                         fault="none" if fault == "control" else fault)
    assert res["correct"] is False
    assert res["checks"]["pcm_gap_lsb"]["value"] > res["checks"]["pcm_gap_lsb"]["limit"]


def test_added_configuration_cell_and_metric(bench_copy):
    """A configuration, a cell and an end-to-end metric added as new files
    and BENCHMARK.json entries, with no existing file edited, are found and
    reported."""
    cfg = json.loads((bench_copy / "perfbench/configs/pcm_resample_exact.json").read_text())
    cfg["resampler"]["number_of_taps"] = 32
    (bench_copy / "perfbench/configs/pcm_resample_exact_t32.json").write_text(json.dumps(cfg))
    (bench_copy / "perfbench/metrics/call_ms_p50.py").write_text(
        "from perfbench import yardstick\n\n\n"
        "def read(rec, spec):\n"
        "    return yardstick.percentile([(e - s) * 1e3 for s, e in rec.calls], 50)\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pcm_resample_exact_t32", "source": "a test",
                             "file": "perfbench/configs/pcm_resample_exact_t32.json",
                             "reduced": ["number_of_taps"], "why": "a test"})
    bench["end_to_end"].append({"name": "call_ms_p50", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": ["t32"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cell(bench_copy, "t32", "pcm_44k1_to_16k_b2048", **TINY)
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["config"] = "pcm_resample_exact_t32"
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _, _ = run_cell(bench_copy, "t32")
    assert res["correct"] is True
    assert "call_ms_p50" in res["metrics"] and "call_ms_p95" in res["metrics"]


def test_no_result_without_the_card():
    """run.py itself looks for the GPUs: here there are none, so it exits
    nonzero and prints no result."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "pcm_exact_down_b2048", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_card_cell(cuda):
    """On the card: a short run of the first cell is correct."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "pcm_exact_down_b2048", "--seed", str(2 ** 31 + 99), "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True

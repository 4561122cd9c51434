"""Fixtures of the benchmark's own tests: a temporary copy of the benchmark
with tiny cells that run on the CPU through the plain versions of the
program's kernels, and the card check of the tests marked ``cuda``."""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"streams": 4, "chunk_frames": 256, "chunks_per_call": 2, "pool_buffers": 2,
        "check": {"streams": 4, "setup_calls": 2, "window_calls": 1, "within_first_calls": 3}}
TINY_CELLS = {"tiny_down": "pcm_44k1_to_16k_b2048", "tiny_up": "pcm_16k_to_44k1_b2048"}
TINY_MP3 = {"slots": 2, "stream_frames": 4, "run_frames": 2, "pool_streams": 2, "warm_runs": 1,
            "check": {"slots": 2}}
# The MP3 chain's configuration and metrics: built and checked, but its rate
# spreads too widely between runs for a bound (see PERF.md), so
# BENCHMARK.json holds no MP3 cell; the tests add one.
MP3_ENTRIES = {
    "config": {"name": "mp3_to_16k", "source": "ISO/IEC 11172-3 Layer III, 44.1 kHz joint "
               "stereo, 128 kbit/s CBR", "file": "perfbench/configs/mp3_to_16k.json",
               "reduced": [], "why": "the composed MP3 -> 16 kHz serving chain"},
    "end_to_end": [{"name": "decoded_msamples_per_s", "unit": "Msamples/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": []}],
    "per_layer": [
        {"name": "decode_ms_per_run", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "MP3 decode", "moves": "decoded_msamples_per_s", "workloads": []},
        {"name": "roofline.mp3_granules", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "decoded_msamples_per_s",
         "workloads": []},
        {"name": "device_idle_share.mp3", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "decoded_msamples_per_s",
         "workloads": []}]}


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is visible (decided when the
    test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def add_cell(root: Path, name: str, traffic_from: str, config: str = "pcm_resample_exact",
             **traffic_changes) -> None:
    """Add a cell to the benchmark at ``root`` as files and BENCHMARK.json
    entries alone: a traffic file made from ``traffic_from`` with the
    changes, and a workload of ``config`` reporting every metric that a cell
    of that configuration reports."""
    tr = json.loads((root / "perfbench" / "traffic" / f"{traffic_from}.json").read_text())
    tr.update(copy.deepcopy(traffic_changes))
    (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config == "mp3_to_16k" and not any(c["name"] == config for c in bench["configs"]):
        entries = copy.deepcopy(MP3_ENTRIES)
        bench["configs"].append(entries["config"])
        for group in ("end_to_end", "per_layer"):
            for m in entries[group]:
                m["workloads"].append(name)
            bench[group] += entries[group]
    else:
        like = next(w["name"] for w in bench["workloads"] if w["config"] == config)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    bench["workloads"].append({"name": name, "config": config, "traffic": name,
                               "chips": 1, "why": "a tiny CPU cell of the tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ with the tiny cells added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, base in TINY_CELLS.items():
        add_cell(tmp_path, name, base, **TINY)
    add_cell(tmp_path, "tiny_mp3", "mp3_128k_js_b2048", "mp3_to_16k", **TINY_MP3)
    return tmp_path


RUNNER = """
import json, sys, time
t = time.perf_counter()
root, repo, workload, seed, seconds, trace, control, fault = sys.argv[1:9]
sys.path[:0] = [root]
sys.path.append(repo)
from pathlib import Path
from perfbench import harness
if fault != "none":
    sys.path.insert(0, {tests!r})
    import faults
    faults.plant(fault)
rc = harness.run(Path(root), workload, int(seed), float(seconds), trace == "1", t_process=t,
                 device="cpu", control=None if control == "none" else control)
print(json.dumps({{"rc": rc, "modules": sorted(sys.modules)}}))
"""


def run_cell(root: Path, workload: str, *, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
             trace: bool = False, control: str | None = None, fault: str = "none"):
    """Run a cell of the copy at ``root`` on the CPU in a fresh process;
    returns (result line, its modules and exit code, standard error)."""
    code = RUNNER.format(tests=str(Path(__file__).parent))
    proc = subprocess.run([sys.executable, "-c", code, str(root), str(REPO), workload, str(seed),
                           str(seconds), "1" if trace else "0", control or "none", fault],
                          capture_output=True, text=True, timeout=600, cwd=root)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"the run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(lines[-2]), json.loads(lines[-1]), proc.stderr

"""The harness: finds a cell's configuration, traffic, driver, reference and
metric readers by the names in ``BENCHMARK.json``, runs the cell, and prints
its result line.

Every piece of a cell lives in files of its own under ``perfbench/``:

* ``configs/<file>.json`` (named by the configuration's ``file``): the sizes
  as run; its ``driver`` names ``drivers/<driver>.py`` and its
  ``reference`` the plain reference ``configs/<reference>.py`` beside it;
* ``traffic/<traffic>.json``: the traffic mix's parameters, read by
  ``generators/<generator>.py``;
* ``metrics/<metric>.py``: one reader a metric, ``read(record, spec)``,
  returning a number or None (then the metric is left out of the line).

A driver's ``drive(spec)`` returns a :class:`Record`; the harness adds the
metrics and the verdict. Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from perfbench import yardstick

ROOT = Path(__file__).resolve().parent          # perfbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "esp_audio_libs_tpu")
TRACE_WINDOW_S = 3.0    # a traced run profiles at most this much of its window


@dataclasses.dataclass
class Spec:
    """What a driver is given: the cell, its files' contents and the run's
    arguments."""

    repo: Path
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object                 # torch.device the program and the reference's dots run on
    reference: object              # the configuration's reference module
    t_process: float               # perf_counter() when the process started
    control: str | None = None     # a precision the reference stands in for the program at
    log: object = sys.stderr
    chips: int = 1


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float
    calls: list = dataclasses.field(default_factory=list)    # (start, end) perf_counter
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None                                     # yardstick.Trace
    launches: dict = dataclasses.field(default_factory=dict)  # kernel -> [(bytes, ops, peak)]
    kernel_names: dict = dataclasses.field(default_factory=dict)  # kernel -> its device name
    checks: dict = dataclasses.field(default_factory=dict)   # name -> (value, limit)
    device: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    check_s: float = 0.0                                     # seconds the comparison took


# ---------------------------------------------------------------- loading
def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(repo: Path, bench: dict, workload_name: str):
    """(workload, configuration entry, configuration file, traffic file) of
    a cell, by its name."""
    work = {w["name"]: w for w in bench["workloads"]}
    if workload_name not in work:
        raise SystemExit(f"no workload {workload_name!r} in BENCHMARK.json")
    w = work[workload_name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, conf, load_json(repo / conf["file"]), load_json(ROOT / "traffic" /
                                                              f"{w['traffic']}.json")


def cell_metrics(bench: dict, workload_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric without ``workloads``
    belongs to every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]


# ------------------------------------------------------------ device side
def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def device_info(spec: Spec) -> dict:
    """The result line's ``device``: the peak is that of the fullest card."""
    import torch
    dev = torch.device(spec.device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": spec.chips, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(spec.chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": spec.chips,
            "memory_peak_bytes": int(peak)}


class _Window:
    def __init__(self, spec: Spec):
        self.spec = spec
        self.seconds = min(spec.seconds, TRACE_WINDOW_S) if spec.trace else spec.seconds
        self.n_calls = 0

    @contextlib.contextmanager
    def call(self):
        """One call of the window; a span of the trace when tracing."""
        self.n_calls += 1
        if self.spec.trace:
            import torch
            with torch.profiler.record_function(yardstick.SPAN_PREFIX + "call"):
                yield
        else:
            yield


@contextlib.contextmanager
def window(spec: Spec, rec: Record):
    """The measured window. With ``spec.trace`` it runs under
    ``torch.profiler`` (host and CUDA activity) and at most
    ``TRACE_WINDOW_S`` long; the trace, reduced, goes to ``rec.trace``."""
    import torch
    win = _Window(spec)
    gc.collect()            # no collection of set-up's garbage inside the window
    if not spec.trace:
        win.start = time.perf_counter()
        yield win
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(spec.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(yardstick.SPAN_PREFIX + "window"):
            start_ns = time.time_ns()
            win.start = time.perf_counter()
            yield win
            sync(spec.device)
            end_ns = time.time_ns()
    rec.trace = yardstick.trace_from_profiler(prof, start_ns, end_ns, win.n_calls)


# ------------------------------------------------------------------ a run
def run(repo: Path, workload_name: str, seed: int, seconds: float, trace: bool, *,
        t_process: float, device=None, control: str | None = None,
        out=sys.stdout, log=sys.stderr) -> int:
    """Run one cell and print its result line; returns the exit code.
    ``device`` None means the card: without the GPUs the cell asks for, no
    result and a nonzero code. Tests pass ``device="cpu"``."""
    bench = load_json(repo / "BENCHMARK.json")
    w, conf, config, traffic = cell_files(repo, bench, workload_name)
    try:
        import torch
    except ImportError as e:
        print(f"perfbench: torch is missing: {e}", file=log)
        return 3
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"perfbench: {workload_name} needs {w['chips']} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=log)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    try:
        import esp_audio_libs_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"perfbench: the program esp_audio_libs_tpu_torch is missing: {e}", file=log)
        return 5
    driver = load_module(ROOT / "drivers" / f"{config['driver']}.py",
                         f"perfbench_driver_{config['driver']}")
    reference = load_module(Path(repo / conf["file"]).parent / f"{config['reference']}.py",
                            f"perfbench_ref_{config['reference']}")
    spec = Spec(repo, w, config, traffic, int(seed), float(seconds), bool(trace), device,
                reference, t_process, control, log, w["chips"])
    rec = driver.drive(spec)
    print(f"perfbench: set-up {rec.setup_s:.1f} s, {len(rec.calls)} calls, "
          f"check {rec.check_s:.1f} s", file=log)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"perfbench: forbidden modules loaded: {loaded}", file=log)
        return 4

    metrics = {}
    for m in cell_metrics(bench, workload_name, trace):
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py", f"perfbench_metric_{m['name']}")
        value = reader.read(rec, spec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= limit for v, limit in rec.checks.values()) and bool(rec.checks)
    result = {"correct": correct, "attempted": len(rec.calls), "failed": rec.failed,
              "metrics": metrics, "device": dict(rec.device)}
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_by_host()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    for k, (v, lim) in rec.checks.items():
        print(f"check {k}: {v} (limit {lim})", file=log)
    log.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None, t_process: float | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None,
                   help="put the reference, computed in this precision, in the program's "
                        "place (the check of the comparison; not a benchmark run)")
    a = p.parse_args(argv)
    repo = ROOT.parent
    cache = repo / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    return run(repo, a.workload, a.seed, a.seconds, bool(a.trace),
               t_process=t_process if t_process is not None else time.perf_counter(),
               control=a.control)

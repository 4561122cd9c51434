"""Persistent warm CLI worker for the conformance runners.

The port's counterpart of examples/cli_worker.py. A conformance suite drives
the user CLIs (``flac_to_wav`` / ``mp3_to_wav``) once per corpus file; a fresh
process per file pays the torch import, the CUDA context and the kernel
library load every time. This worker keeps one process alive per pool slot:
it imports the CLI module once and, on the card, loads the kernel library
before it reports ready, then serves jobs over stdin/stdout as JSON lines by
calling the CLI's ``convert()`` (the code path the standalone CLI runs after
argparse) with its stdout captured, so the runner reads it as it would read
a subprocess's output.

Protocol: one JSON object per line on stdin
    {"in": path, "out": path, "kw": {...}}
answered by one JSON line
    {"rc": int, "stdout": str}
after a first line {"ready": true}. EOF on stdin ends the worker. A job
whose ``convert`` raises answers rc 99; a worker that dies answers the pool
rc 98.

The module also holds what the two runners (``flac_conformance``,
``mp3_conformance``) share: :func:`run_conformance`, which runs a suite,
owns the pool and writes the report, and :func:`wav_data_payload`.

Run: python -m esp_audio_libs_tpu_torch.cli.cli_worker flac|mp3 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def _warm_up(device) -> None:
    """Load what the first job would otherwise load: the host library and,
    on the card, the CUDA context and the kernel library (built when a
    source is newer than it). Raises without a card for ``cuda``."""
    import torch

    from ..runtime import kernels, native
    from ..runtime.kernels import entry_device

    dev = entry_device(device, "cli_worker")
    native.host_lib()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        kernels.library()


def _serve(codec: str, device="cuda") -> int:
    from . import flac_to_wav, mp3_to_wav

    convert = {"flac": flac_to_wav, "mp3": mp3_to_wav}[codec].convert
    _warm_up(device)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        job = json.loads(line)
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = convert(job["in"], job["out"], **{"device": device, **job.get("kw", {})})
        except SystemExit as e:
            rc = int(e.code or 0)
        except Exception as e:  # noqa: BLE001 - a crashed convert fails the file, not the worker
            buf.write(f"worker exception: {e!r}\n")
            rc = 99
        print(json.dumps({"rc": rc, "stdout": buf.getvalue()}), flush=True)
    return 0


class WarmCliPool:
    """Pool of persistent CLI worker processes for a conformance runner.

    ``drive(in_path, out_path, **kw)`` behaves like running the CLI on the
    two paths (returns ``(returncode, stdout)``) but pays the start-up once
    per worker. Thread-safe: each worker is checked out under a lock, so a
    runner's thread pool maps onto the workers.

    Args:
      codec: ``"flac"`` or ``"mp3"``.
      n_workers: worker processes.
      timeout: seconds the pool waits for a worker to exit on ``close``.
      device: ``"cuda"`` (the default; raises without a card) or ``"cpu"``,
        passed to every job's ``convert``. On the card the kernel library is
        built once here, before the workers start, so they do not each run
        nvcc.
    """

    def __init__(self, codec: str, n_workers: int = 2, timeout: float = 900.0, device="cuda"):
        from ..runtime import kernels
        from ..runtime.kernels import entry_device

        dev = entry_device(device, "WarmCliPool")
        if dev.type == "cuda":
            kernels.build()
        self.device = str(dev)
        self.timeout = timeout
        self._free: list[subprocess.Popen] = []
        self._cv = threading.Condition()
        for _ in range(n_workers):
            self._free.append(subprocess.Popen(
                [sys.executable, "-m", "esp_audio_libs_tpu_torch.cli.cli_worker", codec,
                 "--device", self.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, cwd=REPO))
        # wait for the ready lines, so start-up lands here and not in the
        # first file's time
        for p in self._free:
            ready = p.stdout.readline()
            if not ready or "ready" not in ready:
                self.close()
                raise RuntimeError("a cli worker failed to start")

    def drive(self, in_path, out_path, **kw):
        with self._cv:
            while not self._free:
                self._cv.wait()
            p = self._free.pop()
        try:
            p.stdin.write(json.dumps({"in": str(in_path), "out": str(out_path), "kw": kw}) + "\n")
            p.stdin.flush()
            line = p.stdout.readline()
            if not line:
                return 98, ""          # the worker died: this file fails
            r = json.loads(line)
            return int(r["rc"]), r["stdout"]
        finally:
            with self._cv:
                self._free.append(p)
                self._cv.notify()

    def close(self):
        with self._cv:
            for p in self._free:
                try:
                    p.stdin.close()
                    p.wait(timeout=self.timeout)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()
            self._free.clear()


def wav_data_payload(path: Path) -> bytes:
    """The data chunk payload of a RIFF/WAVE file."""
    raw = Path(path).read_bytes()
    pos = 12  # past RIFF size WAVE
    while pos + 8 <= len(raw):
        tag, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        if tag == b"data":
            return raw[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return b""


def run_conformance(corpus: Path, out: Path, check, *, codec: str, categories, report: str,
                    checks: str, row_text, finalize, device="cuda", cli: bool = True,
                    workers: int = 4, wav_dir: str = "wav", no_cli=(), on_file=None) -> dict:
    """Run a conformance suite over every ``*.<codec>`` file of the corpus's
    ``categories`` folders, in order, and write ``<report>.{txt,json}``
    under ``out``.

    ``check(category, path, cli_out)`` decodes one file and returns its
    report row and its CLI drive (a function of the ``WarmCliPool``
    returning True or False, or None); ``cli_out`` is the folder for the
    CLI's WAV, None when the CLI is off or the category is in ``no_cli``.
    The drives run on a pool of ``workers`` ``device`` workers beside the
    next decodes; once they have all resolved, each result is its row's
    ``cli`` and ``finalize(row)`` sets the row's final status.
    ``on_file(category, row)``, when given, is called after each file's
    decode. The text report has one line per file, ``row_text(row)`` in
    it, under a summary and the ``checks`` line. Returns the report dict
    (``categories``: per category the rows; ``summary``).
    """
    t_run0 = time.perf_counter()
    cli_pool = warm_pool = None
    if cli:
        warm_pool = WarmCliPool(codec, n_workers=workers, device=device)
        cli_pool = ThreadPoolExecutor(max_workers=workers)
    result = {"categories": {}, "summary": {}}
    pending = []
    try:
        for cat in categories:
            d = corpus / cat
            if not d.exists():
                continue
            cli_out = None
            if cli and cat not in no_cli:
                cli_out = out / wav_dir / cat
                cli_out.mkdir(parents=True, exist_ok=True)
            rows = result["categories"][cat] = []
            for f in sorted(d.glob(f"*.{codec}")):
                row, job = check(cat, f, cli_out)
                rows.append(row)
                pending.append((row, None if job is None else cli_pool.submit(job, warm_pool)))
                if on_file is not None:
                    on_file(cat, row)
        for row, fut in pending:
            if fut is not None:
                row["cli"] = fut.result()
            finalize(row)
    finally:
        if cli_pool is not None:
            cli_pool.shutdown()
        if warm_pool is not None:
            warm_pool.close()

    rows = [(cat, r) for cat, rs in result["categories"].items() for r in rs]
    total = len(rows)
    passed = sum(r["status"] == "pass" for _, r in rows)
    n_dec = sum(r["parity"] == "decode" for _, r in rows)
    wall = time.perf_counter() - t_run0
    result["summary"] = {"total": total, "passed": passed, "failed": total - passed,
                         "decode_parity": n_dec, "reject_parity": total - n_dec,
                         "wall_seconds": round(wall, 1),
                         "cli_mode": "warm-pool" if cli else "none"}
    title = f"{codec.upper()} conformance report (esp_audio_libs_tpu_torch)"
    lines = [title, "=" * len(title),
             f"{passed}/{total} passed ({n_dec} decode-parity, {total - n_dec} reject-parity); "
             f"suite wall {wall:.1f}s (cli={result['summary']['cli_mode']}, device={device})",
             f"checks: {checks}; no C-oracle comparison", ""]
    for cat, r in rows:
        label = r["status"].upper()
        if r["status"] == "pass" and r["parity"] == "reject":
            label = "PASS-reject"   # visibly weaker than decode parity
        lines.append(f"[{cat}] {r['file']}: {label} ({row_text(r)}, {r['seconds']}s)")
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{report}.txt").write_text("\n".join(lines) + "\n")
    (out / f"{report}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("codec", nargs="?", default="flac", choices=["flac", "mp3"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return _serve(args.codec, args.device)


if __name__ == "__main__":
    sys.exit(main())

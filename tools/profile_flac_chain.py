#!/usr/bin/env python3
"""Where the time of the composed FLAC -> 16 kHz chain goes, on one GPU.

Drives ``esp_audio_libs_tpu_torch`` (never JAX) at chip_smoke.py's composed
configuration: one tools/flacgen.py stream (16-bit stereo, 16 frames of 4096
samples, fitted order-8 LPC, seed 1) replicated over ``--streams`` streams,
``BatchedFLACDecoder.decode_streams_to_device``, then a Resampler 44.1 ->
16 kHz (64 taps, 32 filters) on the device PCM. It reports:

  * the untraced wall time of ``--reps`` decode calls and of ``--reps`` whole
    chain calls (median, min, max);
  * one decode call with each stage timed on the host clock, the card
    synchronised around every device stage: the host parse (its own thread,
    overlapping the rest), the bucket operands in numpy (row gathers, escape
    scan), the uploads (pinned copy + host-to-device), the frame kernel, and
    the rest of the call (queue waits, stitching the device PCM);
  * one chain call traced with CUDA activity only: wall, device busy time
    (union of kernel and copy intervals), the frame kernel's and the
    contraction kernels' time, host-to-device copy time, and the idle share;
  * the host parse alone (``_parse_streams``) with 1, 2, 4 and 8 parse
    threads (``EAL_PARSE_THREADS``), median of ``--reps``: how the native
    front-end scales on this host.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_flac_chain.py [--streams 256] [--reps 5]

The last line is one JSON object with the numbers above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from flacgen import SubframePlan, make_flac  # noqa: E402

from esp_audio_libs_tpu_torch.models import (BatchedFLACDecoder, Resampler,  # noqa: E402
                                             ResamplerConfiguration)
from esp_audio_libs_tpu_torch.models import flac as fm  # noqa: E402

FRAMES, BLOCK = 16, 4096


def _busy_us(events) -> float:
    """Microseconds covered by the union of the events' device intervals."""
    ivs = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur = 0.0, None
    for s, e in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def _resampler(batch: int) -> Resampler:
    r = Resampler(batch=batch, exact=False, device="cuda")
    r.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32))
    return r


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def staged_call(bat, bodies) -> dict:
    """One decode call with its stages timed (ms). The stage wrappers
    synchronise the card, so this call is slower than an untimed one."""
    acc = defaultdict(float)
    real = {name: getattr(fm, name) for name in
            ("_parse_streams", "_bucket_operands", "_put", "flac_frame_cuda")}

    def timed(name, sync):
        def wrapper(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **k)
            if sync:
                torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for name in real:
        setattr(fm, name, timed(name, sync=name in ("_put", "flac_frame_cuda")))
    try:
        wall = _wall(lambda: bat.decode_streams_to_device(bodies))
    finally:
        for name, fn in real.items():
            setattr(fm, name, fn)
    main_thread = acc["_bucket_operands"] + acc["_put"] + acc["flac_frame_cuda"]
    return {"wall_ms": wall, "parse_thread_ms": acc["_parse_streams"],
            "operands_ms": acc["_bucket_operands"], "uploads_ms": acc["_put"],
            "kernel_ms": acc["flac_frame_cuda"], "rest_ms": wall - main_thread}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_flac_chain: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    blob, _ = make_flac(rng_seed=1, depth=16, channels=2, block_size=BLOCK, n_frames=FRAMES,
                        plans=[[SubframePlan("lpc", order=8, fit=True)] * 2] * FRAMES)
    n = args.streams
    bat = BatchedFLACDecoder(n, device="cuda")
    bat.read_headers([blob] * n)
    bodies = [blob[d.get_bytes_index():] for d in bat.decoders]
    frames = FRAMES * BLOCK
    r = _resampler(n)

    def chain():
        pcm, _ = bat.decode_streams_to_device(bodies)
        r.resample_stream(pcm, frames, 1)

    for _ in range(2):
        chain()
    torch.cuda.synchronize()
    dec = [_wall(lambda: bat.decode_streams_to_device(bodies)) for _ in range(args.reps)]
    full = [_wall(chain) for _ in range(args.reps)]
    stages = staged_call(bat, bodies)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = _wall(chain)
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(ev) / 1e3
    flac = _busy_us([e for e in ev if "flac_frame" in e.name]) / 1e3
    contraction = _busy_us([e for e in ev if "polyphase" in e.name or "band_ranges" in e.name]) / 1e3
    h2d = _busy_us([e for e in ev if "HtoD" in e.name or "Memcpy H" in e.name]) / 1e3

    parse_ms = {}
    for threads in (1, 2, 4, 8):
        os.environ["EAL_PARSE_THREADS"] = str(threads)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fm._parse_streams(bat.decoders, bodies)
            times.append((time.perf_counter() - t0) * 1e3)
        parse_ms[threads] = float(np.median(times))
    os.environ.pop("EAL_PARSE_THREADS")

    n_in = n * frames * 2
    row = {"device": torch.cuda.get_device_name(0), "card": card, "streams": n,
           "decode_ms_median": float(np.median(dec)), "decode_ms_min": min(dec),
           "decode_ms_max": max(dec), "chain_ms_median": float(np.median(full)),
           "chain_ms_min": min(full), "chain_ms_max": max(full),
           "decode_msamples_s": n_in / float(np.median(dec)) / 1e3,
           "chain_msamples_s": n_in / float(np.median(full)) / 1e3,
           "staged": stages, "traced_wall_ms": traced, "device_busy_ms": busy,
           "flac_frame_ms": flac, "contraction_ms": contraction, "h2d_copy_ms": h2d,
           "traced_idle_share": 1.0 - busy / traced, "parse_ms_by_threads": parse_ms,
           "host_cpus": os.cpu_count()}
    print(f"decode_streams_to_device: {row['decode_ms_median']:.2f} ms median of {args.reps} "
          f"({min(dec):.2f}-{max(dec):.2f}), {row['decode_msamples_s']:.1f} Msamples/s; chain "
          f"{row['chain_ms_median']:.2f} ms ({min(full):.2f}-{max(full):.2f}), "
          f"{row['chain_msamples_s']:.1f} Msamples/s")
    print("staged decode call (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"traced chain call: wall {traced:.2f} ms, device busy {busy:.3f} ms (flac_frame "
          f"{flac:.3f}, contraction {contraction:.3f}, host-to-device copies {h2d:.3f}), "
          f"idle share {row['traced_idle_share']:.3f}")
    print(f"host parse alone ({os.cpu_count()} CPUs): " + ", ".join(
        f"{t} thread(s) {ms:.1f} ms" for t, ms in parse_ms.items()))
    print(json.dumps(row))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Profile steady resample_stream calls of the PyTorch + CUDA port on one GPU.

Drives ``esp_audio_libs_tpu_torch`` (never JAX) at the bench configuration
(44.1 kHz -> 16 kHz stereo s16, 64 taps, 32 filters, pre-filter folded,
input bytes from ``numpy.random.default_rng(0)``), with the fused int16
tier off and then on, and reports for each:

  * the untraced wall time of ``--reps`` calls (median, min, max);
  * one call traced with CUDA activity only (the lightest trace): its wall
    time, the device busy time (union of kernel and copy intervals), the
    contraction kernel's time and the idle share of that traced wall;
  * the idle share estimated from the untraced median wall minus the traced
    busy time (two different calls, so an estimate, printed as such);
  * one call traced with CPU + CUDA activity: the top ops by device time,
    written to ``--out`` when given.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_stream.py
    python3 tools/profile_stream.py --batch 256 --out chiprun_out/profile.txt

The last line is one JSON object with the numbers above.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration  # noqa: E402

KERNEL_NAMES = ("polyphase_banded", "polyphase_fused16")


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


def _timed_call(r, data, frames, chunks) -> float:
    t0 = time.perf_counter()
    r.resample_stream(data, frames, chunks)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_tier(fused: bool, data, args) -> tuple[dict, str]:
    os.environ["EAL_RESAMPLE_FUSED16"] = "1" if fused else "0"
    r = Resampler(batch=args.batch, exact=False, device="cuda")
    r.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32))
    for _ in range(2):
        r.resample_stream(data, args.frames, args.chunks)
    torch.cuda.synchronize()
    walls = [_timed_call(r, data, args.frames, args.chunks) for _ in range(args.reps)]

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall = _timed_call(r, data, args.frames, args.chunks)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(dev) / 1e3
    kernel = _busy_us([e for e in dev if any(k in e.name for k in KERNEL_NAMES)]) / 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_ops:
        _timed_call(r, data, args.frames, args.chunks)
    table = prof_ops.key_averages().table(sort_by="device_time_total", row_limit=25,
                                          max_name_column_width=70)
    median = float(np.median(walls))
    row = {"fused": fused, "untraced_ms_median": median, "untraced_ms_min": min(walls),
           "untraced_ms_max": max(walls), "traced_wall_ms": traced_wall,
           "device_busy_ms": busy, "kernel_ms": kernel, "other_device_ms": busy - kernel,
           "traced_idle_share": 1.0 - busy / traced_wall,
           "estimated_idle_share_untraced": 1.0 - busy / median}
    return row, table


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8192)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None,
                    help="file for the per-op tables of the CPU + CUDA traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_stream: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    data = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (args.batch, args.chunks * args.frames * 4), dtype=np.uint8), device="cuda")

    rows, tables = [], []
    for fused in (False, True):
        row, table = profile_tier(fused, data, args)
        rows.append(row)
        tables.append(f"== fused tier {'on' if fused else 'off'}\n{table}")
        print(f"fused tier {'on' if fused else 'off'}: untraced {row['untraced_ms_median']:.3f} ms "
              f"(median of {args.reps}, {row['untraced_ms_min']:.3f}-{row['untraced_ms_max']:.3f}); "
              f"traced {row['traced_wall_ms']:.3f} ms, device busy {row['device_busy_ms']:.3f} ms "
              f"(kernel {row['kernel_ms']:.3f}, other {row['other_device_ms']:.3f}), "
              f"traced idle {row['traced_idle_share']:.3f}, "
              f"estimated untraced idle {row['estimated_idle_share_untraced']:.3f}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(tables))
    else:
        print("\n".join(tables))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "batch": args.batch,
                      "frames": args.frames, "chunks": args.chunks, "tiers": rows}))


if __name__ == "__main__":
    main()

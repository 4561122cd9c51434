#!/usr/bin/env python3
"""Profile steady resample_stream calls of the PyTorch + CUDA port on one GPU.

Drives ``esp_audio_libs_tpu_torch`` (never JAX) at the bench configuration
(44.1 kHz -> 16 kHz stereo s16, 64 taps, 32 filters, input bytes from
``numpy.random.default_rng(0)``): fast mode (pre-filter folded) with the
fused int16 tier off and then on, or with ``--exact`` the bit-exact mode
(two exact pre-filter biquad stages and the exact polyphase kernel per
chunk). With ``--upsample`` it runs the other direction, 16 kHz -> 44.1 kHz
at batch 256 (``--batch`` overrides): in exact mode the exact polyphase
kernel, then two exact post-filter biquad stages with ``valid_len`` per
chunk. It reports for each:

  * the untraced wall time of ``--reps`` calls (median, min, max);
  * one call traced with CUDA activity only (the lightest trace): its wall
    time, the device busy time (union of kernel and copy intervals), the
    hand kernels' time (fast mode: the contraction kernels with the
    band-range kernel each launches first, also shown alone; exact mode:
    the biquad and exact polyphase kernels, each also alone), the rest of
    the device time (glue) and the idle share of that traced wall;
  * one call traced with CPU + CUDA activity: the top ops by device time,
    written to ``--out`` when given.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_stream.py
    python3 tools/profile_stream.py --batch 256 --out chiprun_out/profile.txt
    python3 tools/profile_stream.py --exact
    python3 tools/profile_stream.py --exact --upsample

The last line is one JSON object with the numbers above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration  # noqa: E402

# the hand kernels: fast mode's contraction kernels and the band-range kernel
# each of them launches first; exact mode's biquad and polyphase kernels
KERNEL_NAMES = ("polyphase_banded", "polyphase_fused16", "band_ranges", "recurrence_kernel",
                "polyphase_exact")


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
    r = Resampler(batch=args.batch, exact=args.exact, device="cuda")
    src, dst = (16000.0, 44100.0) if args.upsample else (44100.0, 16000.0)
    r.initialize(ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32))
    for _ in range(2):
        r.resample_stream(data, args.frames, args.chunks)
    torch.cuda.synchronize()
    walls = [_timed_call(r, data, args.frames, args.chunks) for _ in range(args.reps)]

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall = _timed_call(r, data, args.frames, args.chunks)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(dev) / 1e3
    kernel = _busy_us([e for e in dev if any(k in e.name for k in KERNEL_NAMES)]) / 1e3
    band = _busy_us([e for e in dev if "band_ranges" in e.name]) / 1e3
    biquad = _busy_us([e for e in dev if "recurrence_kernel" in e.name]) / 1e3
    poly = _busy_us([e for e in dev if "polyphase_" in e.name]) / 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_ops:
        _timed_call(r, data, args.frames, args.chunks)
    table = prof_ops.key_averages().table(sort_by="device_time_total", row_limit=25,
                                          max_name_column_width=70)
    median = float(np.median(walls))
    row = {"mode": "exact" if args.exact else "fast", "fused": fused,
           "direction": "16k->44.1k" if args.upsample else "44.1k->16k",
           "untraced_ms_median": median, "untraced_ms_min": min(walls),
           "untraced_ms_max": max(walls), "traced_wall_ms": traced_wall,
           "device_busy_ms": busy, "kernel_ms": kernel, "band_ranges_ms": band,
           "biquad_ms": biquad, "polyphase_ms": poly,
           "other_device_ms": busy - kernel,
           "traced_idle_share": 1.0 - busy / traced_wall}
    return row, table


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="streams per call (default 2048, or 256 with --upsample)")
    ap.add_argument("--frames", type=int, default=8192)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--exact", action="store_true",
                    help="profile exact mode instead of the two fast tiers")
    ap.add_argument("--upsample", action="store_true",
                    help="16 kHz -> 44.1 kHz (the post-filter direction) instead of 44.1 -> 16")
    ap.add_argument("--out", type=Path, default=None,
                    help="file for the per-op tables of the CPU + CUDA traces")
    args = ap.parse_args()
    if args.batch is None:
        args.batch = 256 if args.upsample else 2048
    if not torch.cuda.is_available():
        sys.exit("profile_stream: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    data = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (args.batch, args.chunks * args.frames * 4), dtype=np.uint8), device="cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    rows, tables = [], []
    for fused in ((False,) if args.exact else (False, True)):
        row, table = profile_tier(fused, data, args)
        rows.append(row)
        name = (f"{row['direction']} " +
                ("exact mode" if args.exact else f"fused tier {'on' if fused else 'off'}"))
        tables.append(f"== {name}\n{table}")
        print(f"{name}: untraced {row['untraced_ms_median']:.3f} ms "
              f"(median of {args.reps}, {row['untraced_ms_min']:.3f}-{row['untraced_ms_max']:.3f}); "
              f"traced {row['traced_wall_ms']:.3f} ms, device busy {row['device_busy_ms']:.3f} ms "
              f"(kernel {row['kernel_ms']:.3f}: biquad {row['biquad_ms']:.3f}, polyphase "
              f"{row['polyphase_ms']:.3f}, band ranges {row['band_ranges_ms']:.3f}; "
              f"other {row['other_device_ms']:.3f}), "
              f"traced idle {row['traced_idle_share']:.3f}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(tables))
    else:
        print("\n".join(tables))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card, "batch": args.batch,
                      "frames": args.frames, "chunks": args.chunks, "tiers": rows}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of the composed MP3 -> 16 kHz chain goes, on one GPU.

Drives ``esp_audio_libs_tpu_torch`` (never JAX) at chip_smoke.py's composed
MP3 configuration: ``--streams`` streams of 8 tools/mp3frames.py tonal
frames (MPEG-1 44.1 kHz stereo, 320 kbit/s, seeds 9000 + i),
``BatchedMP3Decoder.decode_run(to_device=True)``, then a Resampler 44.1 ->
16 kHz (64 taps, 32 filters, fast mode) on the device PCM. It reports:

  * the untraced wall time of ``--reps`` decode calls and of ``--reps`` whole
    chain calls (median, min, max);
  * one decode call with each stage timed on the host clock, the card
    synchronised around every device stage: the host parse (the native
    front-ends, one batch call per frame), the run arrays (stacking the
    parsed granules), the kernel operands (the compact parameter blobs and
    the int16 spectra), the int8 narrowing, the uploads, the granule kernel
    (with the escape fixup before it; under ``--fast mxu`` the run's
    prelude, the dequantizer and the x-side product, and its granule steps,
    two step kernels and two GEMMs each) and the rest of the call;
  * one chain call traced with CUDA activity only: wall, device busy time
    (union of kernel and copy intervals), the granule kernels' (the tier's:
    mp3_granules, mp3_granules_f32 or the two mp3_mxu step kernels), the
    GEMMs' and the contraction kernels' time, host-to-device copy time, and
    the idle share.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_mp3_chain.py [--streams 256] [--reps 5] [--fast {mirror,mxu}]

``--fast`` decodes with ``BatchedMP3Decoder(fast=...)`` (default: the exact
tier).

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

import mp3frames as mf  # noqa: E402
from profile_flac_chain import _busy_us, _resampler, _wall  # noqa: E402

from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder  # noqa: E402
from esp_audio_libs_tpu_torch.models import mp3_pipeline as mp  # noqa: E402
from esp_audio_libs_tpu_torch.ops import mp3mxu  # noqa: E402

FRAMES = 8
CFG = dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)


# the device stages of each tier's run: (stage, module, attribute)
TIER_STAGES = {"exact": [("kernel", mp, "mp3_granules_cuda")],
               "mirror": [("kernel", mp, "mp3_granules_f32_cuda")],
               "mxu": [("prelude", mp3mxu, "mxu_prelude"), ("steps", mp3mxu, "mxu_steps")]}


def staged_call(bat, streams) -> dict:
    """One decode call with its stages timed (ms). The device stages
    synchronise the card, so this call is slower than an untimed one."""
    acc = defaultdict(float)
    cls = BatchedMP3Decoder
    real = {"parse": (cls, "_parse_run", cls._parse_run),
            "run_arrays": (cls, "_group_arrays", cls.__dict__["_group_arrays"]),
            "operands": (mp, "run_operands", mp.run_operands),
            "narrow": (mp, "_pack_huff8_sharded", mp._pack_huff8_sharded),
            "uploads": (mp, "_put", mp._put)}
    device = {name for name, _, _ in TIER_STAGES[bat.tier]} | {"uploads"}
    for name, owner, attr in TIER_STAGES[bat.tier]:
        real[name] = (owner, attr, getattr(owner, attr))

    def timed(name, fn, sync):
        def wrapper(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for name, (owner, attr, fn) in real.items():
        inner = fn.__func__ if isinstance(fn, staticmethod) else fn
        w = timed(name, inner, sync=name in device)
        setattr(owner, attr, staticmethod(w) if isinstance(fn, staticmethod) else w)
    try:
        wall = _wall(lambda: bat.decode_run(streams, FRAMES, to_device=True))
    finally:
        for owner, attr, fn in real.values():
            setattr(owner, attr, fn)
    out = {f"{k}_ms": v for k, v in acc.items()}
    out["wall_ms"] = wall
    out["rest_ms"] = wall - sum(acc.values())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fast", choices=("mirror", "mxu"), default=None,
                    help="the relaxed tier to decode with (default: the exact tier)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_mp3_chain: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    n = args.streams
    streams = [mf.tonal_stream(CFG, 9000 + i, FRAMES) for i in range(n)]
    bat = BatchedMP3Decoder(n, device="cuda", fast=args.fast or False)
    samples = FRAMES * 1152
    r = _resampler(n)

    def chain():
        pcm, _ = bat.decode_run(streams, FRAMES, to_device=True)
        r.resample_stream(pcm.view(torch.uint8), samples, 1)

    for _ in range(2):
        chain()
    torch.cuda.synchronize()
    dec = [_wall(lambda: bat.decode_run(streams, FRAMES, to_device=True))
           for _ in range(args.reps)]
    full = [_wall(chain) for _ in range(args.reps)]
    stages = staged_call(bat, streams)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = _wall(chain)
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(ev) / 1e3
    kernel = _busy_us([e for e in ev if "mp3_granules" in e.name or "mp3_mxu" in e.name]) / 1e3
    gemm = _busy_us([e for e in ev if "gemm" in e.name.lower()]) / 1e3
    contraction = _busy_us([e for e in ev
                            if "polyphase" in e.name or "band_ranges" in e.name]) / 1e3
    h2d = _busy_us([e for e in ev if "HtoD" in e.name or "Memcpy H" in e.name]) / 1e3

    n_in = n * samples * 2
    row = {"device": torch.cuda.get_device_name(0), "card": card, "tier": bat.tier,
           "streams": n, "frames": FRAMES, "decode_ms_median": float(np.median(dec)),
           "decode_ms_min": min(dec),
           "decode_ms_max": max(dec), "chain_ms_median": float(np.median(full)),
           "chain_ms_min": min(full), "chain_ms_max": max(full),
           "decode_msamples_s": n_in / float(np.median(dec)) / 1e3,
           "chain_msamples_s": n_in / float(np.median(full)) / 1e3,
           "staged": stages, "traced_wall_ms": traced, "device_busy_ms": busy,
           "granule_kernels_ms": kernel, "gemm_ms": gemm, "contraction_ms": contraction,
           "h2d_copy_ms": h2d,
           "traced_idle_share": 1.0 - busy / traced, "host_cpus": os.cpu_count()}
    print(f"decode_run(to_device): {row['decode_ms_median']:.2f} ms median of {args.reps} "
          f"({min(dec):.2f}-{max(dec):.2f}), {row['decode_msamples_s']:.1f} Msamples/s; chain "
          f"{row['chain_ms_median']:.2f} ms ({min(full):.2f}-{max(full):.2f}), "
          f"{row['chain_msamples_s']:.1f} Msamples/s")
    print("staged decode call (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"traced chain call ({bat.tier} tier): wall {traced:.2f} ms, device busy {busy:.3f} ms "
          f"(granule kernels {kernel:.3f}, GEMMs {gemm:.3f}, contraction {contraction:.3f}, "
          f"host-to-device copies {h2d:.3f}), idle share {row['traced_idle_share']:.3f}")
    print(json.dumps(row))


if __name__ == "__main__":
    main()

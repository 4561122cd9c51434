"""profile_serve_flac: where the time of serve_fleet's FLAC fleet goes.

Builds serve_fleet's FLAC corpus (``--streams`` tools/flacgen.py streams,
16-bit stereo, order-8 LPC, ``--min-frames`` to ``--max-frames`` frames of
1024, ``--seed``) and serves it on fresh fleets, timing each stage on the
host clock, the median of ``--reps``:

  construct  the BatchedFLACDecoder;
  headers    read_headers;
  decode     decode_streams as serve_flac calls it, MD5 checks included,
             the card synchronised after it;
  parse      the host parse alone (models/flac.py::_parse_streams, which runs
             on its own thread inside decode_streams), on another fresh fleet;
  md5        the MD5 checks alone (FLACDecoder._md5_of_output over the
             decoded PCM).

Usage: python -m esp_audio_libs_tpu_torch.cli.profile_serve_flac
         [--streams 256] [--min-frames 8] [--max-frames 16] [--reps 3]
         [--seed 7] [--device cuda|cpu]

Prints one JSON object: the arguments and the median ms of each stage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..runtime.kernels import entry_device
from .serve_fleet import flac_corpus


def stage_ms(blobs, reps: int, device) -> dict:
    """Median host-clock ms of each stage over ``reps`` fresh fleets."""
    from ..models import flac as fm
    from ..models.batch import BatchedFLACDecoder
    from ..utils.errors import FLACDecoderResult

    times = {"construct": [], "headers": [], "decode": [], "parse": [], "md5": []}

    def fresh():
        t0 = time.perf_counter()
        fleet = BatchedFLACDecoder(len(blobs), device=device)
        t1 = time.perf_counter()
        hdrs = fleet.read_headers(blobs)
        times["construct"].append(t1 - t0)
        times["headers"].append(time.perf_counter() - t1)
        if not all(h == FLACDecoderResult.SUCCESS for h in hdrs):
            raise ValueError(f"header parse failed: {sorted({h.name for h in hdrs})}")
        return fleet, [b[d.get_bytes_index():] for b, d in zip(blobs, fleet.decoders)]

    for _ in range(reps):
        fleet, bodies = fresh()
        t0 = time.perf_counter()
        results = fleet.decode_streams(bodies)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times["decode"].append(time.perf_counter() - t0)
        if not all(info["md5_ok"] for _pcm, info in results):
            raise ValueError("a stream is not md5_ok")
        t0 = time.perf_counter()
        for dec, (pcm, _info) in zip(fleet.decoders, results):
            dec._md5_of_output([np.frombuffer(pcm, np.uint8)])
        times["md5"].append(time.perf_counter() - t0)
        fleet, bodies = fresh()
        t0 = time.perf_counter()
        fm._parse_streams(fleet.decoders, bodies)
        times["parse"].append(time.perf_counter() - t0)
    return {k: round(float(np.median(v)) * 1e3, 2) for k, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--min-frames", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = entry_device(args.device, "profile_serve_flac")
    blobs = flac_corpus(args.streams, args.min_frames, args.max_frames, args.seed)
    stages = stage_ms(blobs, args.reps, device)
    print(json.dumps({**vars(args), "stage_ms": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

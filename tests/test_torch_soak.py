"""Port parity of the serving soak (tests/test_soak.py): repeated identical
fleet cycles must not grow memory.

A per-cycle allocation that escapes (a native front-end context that is not
destroyed, a tensor pinned by a host reference, a cache keyed on per-call
state) shows as monotone growth across cycles. After a warm-up these tests
assert, on the port with ``device="cpu"``:

  1. the count of live torch tensors (a gc scan: the counterpart of
     ``jax.live_arrays``) returns to its baseline within 4, and
  2. the resident set stays within the JAX contract's allowances: 64 MB
     over the serving cycles, 16 MB over the native context churn.

The cycle counts are lower than the contract's 40 and 300: on the CPU the
port runs its kernels' plain versions, and the plain MP3 path takes
0.1-0.2 s per granule step, so the contract's counts would take minutes.
chip_smoke.py phase 17 runs the full counts on the card, with
``torch.cuda.memory_allocated()`` in place of the gc scan's device half.
"""

import gc
import sys
from pathlib import Path

import numpy as np
import torch

from esp_audio_libs_tpu_torch.models import (BatchedFLACDecoder, BatchedMP3Decoder, FLACDecoder,
                                             MP3Decoder)
from esp_audio_libs_tpu_torch.utils.errors import FLACDecoderResult

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mp3frames as mf  # noqa: E402
from flacgen import SubframePlan, make_flac  # noqa: E402

torch.set_num_threads(2)

SERVING_CYCLES, CHURN_CYCLES = 12, 100


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


def _live_tensors() -> int:
    return sum(1 for o in gc.get_objects() if issubclass(type(o), torch.Tensor))


def _mp3_streams(n, nf=6):
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
    out = []
    for i in range(n):
        rng = np.random.default_rng(700 + i)
        out.append(b"".join(mf.craft_tonal_frame(cfg, rng) for _ in range(nf)))
    return out


def _flac_streams():
    cfgs = [
        dict(rng_seed=61, depth=16, channels=2, block_size=1024, n_frames=2,
             plans=[[SubframePlan("lpc", order=8), SubframePlan("fixed", order=2)]] * 2),
        dict(rng_seed=62, depth=16, channels=2, block_size=1024, n_frames=2,
             plans=[[SubframePlan("lpc", order=4), SubframePlan("constant")]] * 2),
    ]
    return [make_flac(**c)[0] for c in cfgs]


def test_fleet_serving_cycles_leak_free():
    mp3_bufs = _mp3_streams(4)
    flac_bufs = _flac_streams()

    mp3 = BatchedMP3Decoder(len(mp3_bufs), device="cpu")
    flac = BatchedFLACDecoder(len(flac_bufs), device="cpu")
    assert all(h == FLACDecoderResult.SUCCESS for h in flac.read_headers(flac_bufs))
    flac_frames = [b[d.get_bytes_index():] for b, d in zip(flac_bufs, flac.decoders)]

    def cycle():
        for s in range(len(mp3_bufs)):   # slot recycling: same fleet, "new" streams
            mp3.reset_stream(s)
        r = mp3.decode_run(mp3_bufs, 3)
        assert all(len(frames) == 3 for frames in r)
        res = flac.decode_streams(flac_frames)
        assert all(info["md5_ok"] for _, info in res)

    for _ in range(5):                  # warm-up: pools and caches
        cycle()
    gc.collect()
    base_live = _live_tensors()
    base_rss = _rss_mb()

    for _ in range(SERVING_CYCLES):
        cycle()
    gc.collect()

    live = _live_tensors()
    assert live <= base_live + 4, (
        f"live tensors grew {base_live} -> {live} over {SERVING_CYCLES} identical cycles: "
        "a tensor is leaking per cycle")
    grown = _rss_mb() - base_rss
    assert grown < 64.0, (
        f"RSS grew {grown:.1f} MB over {SERVING_CYCLES} identical serving cycles "
        f"(from {base_rss:.1f} MB): host memory is leaking per cycle")


def test_native_context_churn_bounded():
    """Create/destroy churn of the native front-end contexts (the
    continuous-batching admission path) must not accumulate host memory:
    every eal_flac_create / eal_mp3_create is balanced by its destroy."""
    blob = _flac_streams()[0]
    mp3_blob = _mp3_streams(1, nf=2)[0]

    def churn():
        d = FLACDecoder(device="cpu")
        assert d.read_header(blob) == FLACDecoderResult.SUCCESS
        m = MP3Decoder(device="cpu")
        m.decode(mp3_blob)
        del d, m

    for _ in range(20):                 # warm-up
        churn()
    gc.collect()
    base = _rss_mb()
    for _ in range(CHURN_CYCLES):
        churn()
    gc.collect()
    grown = _rss_mb() - base
    assert grown < 16.0, (
        f"RSS grew {grown:.1f} MB over {CHURN_CYCLES} native context create/destroy "
        "cycles: a front-end context or its buffers leak")

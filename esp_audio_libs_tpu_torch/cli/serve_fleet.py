"""serve_fleet: fleet serving, N compressed streams on one card.

The port's counterpart of examples/serve_fleet.py. The reference API is one
decoder instance per stream (reference include/mp3_decoder.h:303-336); here a
whole fleet decodes through the shared batched kernels, one launch per format
group per run:

  MP3:  the BatchedMP3Decoder.decode_run loop: fixed-frame runs, the
        next_pos continuation protocol (reservoir slack is skipped inside
        the run and is part of no frame's consumed), ragged stream lengths
        (streams finish at different runs) and continuous batching: with
        --total-streams > --streams, finished slots recycle through
        reset_stream and admit pending streams, so a fixed-width fleet serves
        an open-ended queue. A stream ends at its first error. Stereo and
        mono streams dispatch as separate format groups.
  FLAC: BatchedFLACDecoder.decode_streams: whole-stream fleet decode with
        per-stream MD5 self-verification, ragged stream lengths.

Optional:
  --rate HZ   (MP3, uniform fleets) compose decode -> resample with the PCM
              left on the device between the stages: decode_run(to_device=
              True) gives int16 [B, n], viewed as little-endian bytes and fed
              to the fast Resampler.
  --verify    check every stream's fleet PCM against a single-stream
              MP3Decoder decode with the reference caller protocol.
  --device    cuda (the default: the hand kernels; raises without a card) or
              cpu (their plain versions).
  --mesh N    serve over an N-device stream mesh (parallel/mesh.py): every
              visible device of the --device type, which must number N, as
              in the JAX original. serve_mp3 and serve_flac also take a
              StreamMesh in-process, which may name a device more than once.

Prints one metrics JSON line per run and one aggregate line, as the JAX
original does:
  {"run": i, "active": k, "samples": n, "recycled": r, "ms": t, "msps": r}
  {"aggregate": ..., "streams": N, "samples": n, "msps": r,
   "realtime_streams": x, "verified": true|null}

The corpus is generated in-process from --seed: MP3 tonal frames (nonzero
spectra) from tools/mp3frames.py, FLAC streams from tools/flacgen.py.

Usage: python -m esp_audio_libs_tpu_torch.cli.serve_fleet [--codec mp3|flac]
         [--streams N] [--total-streams M] [--min-frames a] [--max-frames b]
         [--run-frames r] [--rate HZ] [--verify] [--seed S] [--device cuda|cpu]
         [--mesh N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import Sharded, stream_mesh, to_numpy
from ..runtime.kernels import entry_device

TOOLS = Path(__file__).resolve().parent.parent.parent / "tools"

MP3_STEREO = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
MP3_MONO = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=3)


def _tools():
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))


def _sync(device, mesh=None) -> None:
    """Wait for the work queued on ``device`` (on every device of ``mesh``)."""
    for dev in (mesh.distinct() if mesh is not None else [torch.device(device)]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _mesh(n, device):
    """The stream mesh of ``--mesh n``: every visible device of ``device``'s
    type (one for the CPU), which must number ``n``; None without ``n``.
    Raises ``ValueError`` otherwise, as the JAX original exits."""
    if not n:
        return None
    dev = entry_device(device, "serve_fleet")
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    if visible != n:
        raise ValueError(f"--mesh {n} but {visible} {dev.type} device(s) visible")
    return stream_mesh([torch.device(dev.type, i) for i in range(n)] if dev.type == "cuda"
                       else ["cpu"])


# ----------------------------------------------------------------- MP3 fleet


def mp3_corpus(n_streams, min_frames, max_frames, seed, uniform):
    """Tonal streams with ragged lengths, every third one mono, unless
    ``uniform`` (the composed mode needs one format group: all stereo, all
    ``max_frames`` long). Returns (uint8 arrays, [(cfg, n_frames)])."""
    _tools()
    from mp3frames import craft_tonal_frame

    rng = np.random.default_rng(seed)
    streams, metas = [], []
    for i in range(n_streams):
        cfg = MP3_STEREO if (uniform or i % 3) else MP3_MONO
        n = max_frames if uniform else int(rng.integers(min_frames, max_frames + 1))
        streams.append(np.frombuffer(
            b"".join(craft_tonal_frame(cfg, rng) for _ in range(n)), np.uint8))
        metas.append((cfg, n))
    return streams, metas


def mp3_single_decode(data, n_frames: int, device="cuda"):
    """The reference caller protocol on one stream: decode, advance by
    consumed, then MP3FindSyncWord past reservoir slack (reference
    mp3_decoder.cpp:8533); the per-stream ground truth of --verify. Returns
    [(err, pcm | None)]."""
    from ..models.mp3 import MP3Decoder

    dec = MP3Decoder(device=device)
    pos, out = 0, []
    data = bytes(data)
    while pos < len(data) and len(out) < n_frames:
        err, pcm, consumed = dec.decode(data[pos:])
        out.append((int(err), None if pcm is None else np.asarray(pcm)))
        pos += consumed
        if int(err) != 0:
            break
        nxt = MP3Decoder.find_sync_word(data[pos:])
        pos = pos + nxt if nxt >= 0 else len(data)
    return out


def serve_mp3(args, streams, metas, on_run=None, mesh=None):
    """Serve the MP3 streams of :func:`mp3_corpus` (``streams``, ``metas``)
    on a fleet of ``args.streams`` slots, with the options of :func:`main`,
    over the stream ``mesh`` if one is given (a ``StreamMesh`` of
    ``args.device``'s type; the composed mode's PCM then stays split over it
    between the stages).

    ``on_run(run, slots, bufs, res, out)``, when given, sees each run as it
    ends: the stream in each slot (None for an idle slot), the per-slot input
    views (None likewise), the ``decode_run`` result and, in the composed
    mode, the resampler's ``(packed, gens, clips)``, else None. It is the
    way to read the PCM of a serve without ``args.verify``.

    Returns ``(pcm, runs, aggregate)``: with ``args.verify`` per stream the
    list of its decoded int16 PCM arrays, else None (a serve keeps no PCM,
    as the JAX original keeps none); the per-run metric dicts; the aggregate
    dict, which a failed --verify marks ``"verified": false``. Raises
    ``ValueError`` when the streams do not fit the slots.
    """
    from ..models.batch import BatchedMP3Decoder

    uniform = args.rate is not None
    slots = args.streams
    total = len(streams)
    if total < slots or (uniform and total != slots):
        raise ValueError(f"{total} streams for {slots} slots: the composed --rate mode "
                         "serves one stream per slot, the ragged mode at least as many")
    fleet = BatchedMP3Decoder(slots, device=args.device, mesh=mesh)

    resampler = None
    if uniform:
        from ..models.resampler import Resampler, ResamplerConfiguration

        resampler = Resampler(batch=slots, exact=False, device=args.device, mesh=mesh)
        if not resampler.initialize(ResamplerConfiguration(
                44100.0, float(args.rate), 16, 16, 2, True, True, 64, 32)):
            raise ValueError(f"the resampler refused 44100 -> {args.rate} Hz")

    # slot_of[i]: the stream in slot i (None: idle); a finished slot recycles
    # through fleet.reset_stream and admits the next pending stream
    slot_of = list(range(slots))
    next_admit = slots
    pos = [0] * slots
    per_stream_pcm = [[] for _ in range(total)] if args.verify else None
    nch_of = [1 if m[0]["mode"] == 3 else 2 for m in metas]
    total_samples = 0
    audio_seconds = 0.0   # each stream weighted by its own channel count
    runs = []
    t_all = time.perf_counter()

    def finish_slot(i):
        nonlocal next_admit
        if next_admit < total:
            fleet.reset_stream(i)
            slot_of[i], pos[i] = next_admit, 0
            next_admit += 1
            return True
        slot_of[i] = None
        return False

    while any(s is not None for s in slot_of):
        bufs = [None if slot_of[i] is None else streams[slot_of[i]][pos[i]:]
                for i in range(slots)]
        errored = [False] * slots
        out = None
        t0 = time.perf_counter()
        if uniform:
            # composed serving: the PCM never visits the host between stages
            res = fleet.decode_run(bufs, args.run_frames, to_device=True)
            pcm_dev = res[0]
            nb = pcm_dev.shape[1] * 2

            def as_bytes(p):
                return p.contiguous().view(torch.uint8)   # little-endian, no copy

            pcm_u8 = pcm_dev.map(as_bytes) if isinstance(pcm_dev, Sharded) else as_bytes(pcm_dev)
            out = resampler.resample_stream(pcm_u8, nb // 4, 1)
            _sync(args.device, mesh)
            samples = int(pcm_dev.shape[0]) * int(pcm_dev.shape[1])
            audio_seconds += samples / (44100.0 * 2)   # uniform = stereo
            if args.verify:
                host = to_numpy(pcm_dev)
                for i in range(slots):
                    per_stream_pcm[slot_of[i]].append(host[i])
        else:
            res = fleet.decode_run(bufs, args.run_frames)
            samples = 0
            for i in range(slots):
                if bufs[i] is None:
                    continue
                for err, pcm, _c in res[i]:
                    if pcm is not None:
                        samples += pcm.size
                        audio_seconds += pcm.size / (44100.0 * nch_of[slot_of[i]])
                        if args.verify:
                            per_stream_pcm[slot_of[i]].append(pcm)
                    if int(err) != 0:
                        errored[i] = True   # a run ends a stream at its first error
        dt = time.perf_counter() - t0
        if on_run is not None:
            on_run(len(runs), tuple(slot_of), bufs, res, out)
        active = sum(1 for b in bufs if b is not None)
        recycled = 0
        for i in range(slots):
            if bufs[i] is None:
                continue
            pos[i] += res.next_pos[i]
            if errored[i] or pos[i] >= streams[slot_of[i]].size:
                recycled += int(finish_slot(i))
        total_samples += samples
        runs.append({"run": len(runs), "active": active, "samples": samples,
                     "recycled": recycled, "ms": round(dt * 1e3, 2),
                     "msps": round(samples / dt / 1e6, 2)})
    dt_all = time.perf_counter() - t_all

    verified = None
    if args.verify:
        verified = True
        for i, (_cfg, n) in enumerate(metas):
            want = [p for _e, p in mp3_single_decode(streams[i], n, args.device)
                    if p is not None]
            ref = np.concatenate(want) if want else np.zeros(0, np.int16)
            got = (np.concatenate(per_stream_pcm[i]) if per_stream_pcm[i]
                   else np.zeros(0, np.int16))
            if got.size < ref.size or not np.array_equal(got[:ref.size], ref):
                verified = False
                print(f"VERIFY FAIL: stream {i}", file=sys.stderr)
    # realtime equivalence: decoded audio seconds per wall second (a mono
    # stream producing 44100 samples/s is one realtime stream, not half)
    aggregate = {"aggregate": "mp3", "streams": total, "slots": slots,
                 "samples": total_samples, "runs": len(runs),
                 "msps": round(total_samples / dt_all / 1e6, 2),
                 "realtime_streams": round(audio_seconds / dt_all, 1),
                 "verified": verified}
    return per_stream_pcm, runs, aggregate


# ---------------------------------------------------------------- FLAC fleet


def flac_corpus(n_streams, min_frames, max_frames, seed):
    """16-bit stereo flacgen streams of order-8 LPC frames of 1024 samples,
    ragged lengths. Returns the blobs."""
    _tools()
    from flacgen import SubframePlan, make_flac

    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(n_streams):
        n_frames = int(rng.integers(min_frames, max_frames + 1))
        blob, _pcm = make_flac(
            rng_seed=seed * 1000 + i, depth=16, channels=2, block_size=1024,
            n_frames=n_frames,
            plans=[[SubframePlan("lpc", order=8, fit=True),
                    SubframePlan("lpc", order=8, fit=True)]] * n_frames)
        blobs.append(blob)
    return blobs


def serve_flac(args, blobs, mesh=None):
    """Decode the FLAC streams ``blobs`` (:func:`flac_corpus`) as one fleet
    on ``args.device`` (over the stream ``mesh`` if one is given): headers,
    then one ``decode_streams`` call with MD5 checks. Returns ``(results,
    aggregate)``: per stream ``(pcm_bytes, info)`` as
    ``BatchedFLACDecoder.decode_streams`` gives it, and the aggregate dict."""
    from ..models.batch import BatchedFLACDecoder
    from ..utils.errors import FLACDecoderResult

    fleet = BatchedFLACDecoder(len(blobs), device=args.device, mesh=mesh)
    t0 = time.perf_counter()
    hdrs = fleet.read_headers(blobs)
    if not all(h == FLACDecoderResult.SUCCESS for h in hdrs):
        raise ValueError(f"header parse failed: {sorted({h.name for h in hdrs})}")
    results = fleet.decode_streams(
        [b[d.get_bytes_index():] for b, d in zip(blobs, fleet.decoders)])
    dt = time.perf_counter() - t0

    # num_samples is already interleaved (channels included)
    total_samples = sum(info["num_samples"] for _pcm, info in results)
    sps = total_samples / dt
    aggregate = {"aggregate": "flac", "streams": len(blobs), "samples": total_samples,
                 "msps": round(sps / 1e6, 2),
                 "realtime_streams": round(sps / (44100 * 2), 1),
                 "verified": all(info["md5_ok"] for _pcm, info in results)}
    return results, aggregate


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--codec", choices=["mp3", "flac"], default="mp3")
    ap.add_argument("--streams", type=int, default=8,
                    help="fleet width (concurrent serving slots)")
    ap.add_argument("--total-streams", type=int, default=None,
                    help="MP3: total streams to serve; slots recycle through "
                    "reset_stream as streams finish (continuous batching)")
    ap.add_argument("--min-frames", type=int, default=4)
    ap.add_argument("--max-frames", type=int, default=10)
    ap.add_argument("--run-frames", type=int, default=4,
                    help="frames decoded per serving run (MP3)")
    ap.add_argument("--rate", type=float, default=None,
                    help="MP3 only: composed decode->resample to this rate "
                    "(uniform fleet, PCM on the device between the stages)")
    ap.add_argument("--verify", action="store_true",
                    help="check the fleet PCM against single-stream decodes")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", type=int, default=None,
                    help="serve over an N-device stream mesh (N visible devices)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.codec == "flac" and args.rate is not None:
        print("ERROR: --rate composition is demonstrated for --codec mp3 "
              "(FLAC composition: models/flac.decode_streams_to_device)")
        return 1
    if args.codec == "flac" and args.total_streams is not None:
        print("ERROR: --total-streams slot recycling is demonstrated for "
              "--codec mp3 (FLAC serves whole streams per decode_streams "
              "call; recycle with BatchedFLACDecoder.reset_stream)")
        return 1
    if args.rate is not None and (args.total_streams or args.streams) != args.streams:
        print("ERROR: the --total-streams recycling demo needs the ragged mode "
              "(composed --rate fleets run in lockstep)")
        return 1
    entry_device(args.device, "serve_fleet")
    try:
        mesh = _mesh(args.mesh, args.device)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    if args.codec == "flac":
        blobs = flac_corpus(args.streams, args.min_frames, args.max_frames, args.seed)
        _results, aggregate = serve_flac(args, blobs, mesh)
        print(json.dumps(aggregate))
        return 0 if aggregate["verified"] else 1
    total = max(args.total_streams or args.streams, args.streams)
    streams, metas = mp3_corpus(total, args.min_frames, args.max_frames, args.seed,
                                uniform=args.rate is not None)
    _pcm, runs, aggregate = serve_mp3(args, streams, metas, mesh=mesh)
    for line in runs:
        print(json.dumps(line))
    print(json.dumps(aggregate))
    return 0 if aggregate["verified"] in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())

"""resample_wav: resample a WAV file with the batched sinc resampler.

The port's counterpart of examples/resample_wav.py. It drives the public
``Resampler`` the way the reference's downstream consumer (ESPHome's speaker
pipeline) drives ``esp_audio_libs::resampler::Resampler`` (reference
include/resampler.h:34-80, src/resample/resampler.cpp:21-160): parse the WAV
header, initialize once, then loop feed -> resample -> collect, honouring
the required-samples throttle (``frames_used`` says how much input was
consumed; the rest is resent next call).

Usage: python -m esp_audio_libs_tpu_torch.cli.resample_wav input.wav output.wav
         --rate 16000 [--bits N] [--gain-db G] [--taps 64] [--filters 32]
         [--no-filter] [--no-interpolate] [--fast] [--device cuda|cpu]
Exit codes: 0 ok, 1 parse/config error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..models.resampler import Resampler, ResamplerConfiguration
from ..models.wav import parse_wav
from .wav_io import write_wav_header

CHUNK_FRAMES = 8192


def resample_pcm_bytes(rs: Resampler, pcm: bytes, *, ch: int, src_bits: int,
                       ratio: float, gain_db: float = 0.0,
                       chunk_frames: int = CHUNK_FRAMES):
    """The reference caller contract (resampler.cpp:100-160) as a loop:
    feed at most ``chunk_frames``, honour the required-samples throttle
    (``frames_used``), resend the unconsumed tail next call. Shared by the
    CLIs that resample (this one and mix_wav). Returns ``(payload bytes,
    clipped sample count)``."""
    bps_in = (src_bits + 7) // 8
    frame_bytes = ch * bps_in
    total_frames = len(pcm) // frame_bytes
    out_free = int(chunk_frames * ratio) + 16
    pos = 0
    parts: list[bytes] = []
    clipped = 0
    while pos < total_frames:
        avail = min(chunk_frames, total_frames - pos)
        buf = pcm[pos * frame_bytes:(pos + avail) * frame_bytes]
        data = np.frombuffer(buf, np.uint8)[None, :]
        out, res = rs.resample(data, avail, out_free, gain_db=gain_db)
        parts.append(out[0].cpu().numpy().tobytes())
        clipped += int(res.clipped_samples[0])
        if res.frames_used <= 0:   # throttled with nothing consumed: done
            break
        pos += res.frames_used
    return b"".join(parts), clipped


def convert(in_path: str, out_path: str, *, rate: float, bits: int | None,
            gain_db: float, taps: int, filters: int, use_filter: bool,
            interpolate: bool, exact: bool, device="cuda") -> int:
    try:
        raw = Path(in_path).read_bytes()
    except OSError as e:
        print(f"ERROR: cannot read {in_path}: {e.strerror}")
        return 1
    try:
        hdr, pcm = parse_wav(raw)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1

    src_rate, ch, src_bits = hdr.sample_rate, hdr.num_channels, hdr.bits_per_sample
    out_bits = bits if bits is not None else src_bits
    print(f"  in : {src_rate} Hz, {ch} ch, {src_bits}-bit, "
          f"{len(pcm) // (ch * (src_bits // 8))} frames")
    print(f"  out: {rate:g} Hz, {ch} ch, {out_bits}-bit"
          + (f", gain {gain_db:+g} dB" if gain_db else ""))

    rs = Resampler(batch=1, exact=exact, device=device)
    ok = rs.initialize(ResamplerConfiguration(
        source_sample_rate=float(src_rate), target_sample_rate=float(rate),
        source_bits_per_sample=src_bits, target_bits_per_sample=out_bits,
        channels=ch, use_pre_or_post_filter=use_filter,
        subsample_interpolate=interpolate, number_of_taps=taps,
        number_of_filters=filters))
    if not ok:
        print("ERROR: resampler configuration rejected "
              "(taps must be a multiple of 4 in 4-1024, filters in 2-1024)")
        return 1

    payload, clipped = resample_pcm_bytes(
        rs, pcm, ch=ch, src_bits=src_bits,
        ratio=float(rate) / float(src_rate), gain_db=gain_db)
    bps_out = (out_bits + 7) // 8
    n_out = len(payload) // (ch * bps_out)
    with open(out_path, "wb") as f:
        write_wav_header(f, int(rate), ch, out_bits, n_out, bps_out)
        f.write(payload)
    print(f"  wrote {out_path}: {n_out} frames"
          + (f", {clipped} clipped samples" if clipped else ""))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--rate", type=float, required=True,
                    help="target sample rate in Hz")
    ap.add_argument("--bits", type=int, default=None,
                    help="target bit depth (default: keep source depth)")
    ap.add_argument("--gain-db", type=float, default=0.0)
    ap.add_argument("--taps", type=int, default=64)
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--no-filter", action="store_true",
                    help="disable the pre/post lowpass biquads")
    ap.add_argument("--no-interpolate", action="store_true",
                    help="disable inter-filter interpolation")
    ap.add_argument("--fast", action="store_true",
                    help="fast mode: the banded contraction (default: bit-exact mode)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys.exit(convert(
        args.input, args.output, rate=args.rate, bits=args.bits,
        gain_db=args.gain_db, taps=args.taps, filters=args.filters,
        use_filter=not args.no_filter, interpolate=not args.no_interpolate,
        exact=not args.fast, device=args.device))


if __name__ == "__main__":
    main()

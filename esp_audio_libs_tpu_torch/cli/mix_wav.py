"""mix_wav: volume-scale and mix N WAV files with the DSP primitives.

The port's counterpart of examples/mix_wav.py: the downstream-consumer
chain the reference exports ``dsps_mulc_s16``/``dsps_add_s16`` for (reference
include/dsp.h:45-94; ESPHome's mixer and volume stages):

    parse WAV headers -> [optional] resample each input to a common rate
    (exact ``Resampler``) -> per-input Q15 volume (mulc_s16) -> left-fold
    sum (add_s16, with the caller's headroom shift) -> write WAV

bit for bit as the C kernels chained in that order (``ops.dsp.mix_s16``).

Usage: python -m esp_audio_libs_tpu_torch.cli.mix_wav out.wav in1.wav in2.wav [...]
         [--gain-db G ...]   one per input, <= 0 dB (default 0 dB -> Q15
                             32767; Q15 can only attenuate)
         [--shift N]         arithmetic right shift per add (headroom;
                             0 wraps on overflow exactly like the C kernel)
         [--rate R]          resample all inputs to R Hz first
         [--device cuda|cpu]
Exit codes: 0 ok, 1 parse/config error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.resampler import Resampler, ResamplerConfiguration
from ..models.wav import parse_wav
from ..ops.dsp import mix_s16
from ..runtime.kernels import entry_device
from .resample_wav import resample_pcm_bytes
from .wav_io import write_wav_header


def db_to_q15(gain_db: float) -> np.int16:
    """dB -> Q15 gain for mulc_s16; 0 dB maps to 32767 (about unity). Q15
    tops out just below unity, so the mixer can only attenuate: a positive
    gain raises ``ValueError``."""
    if gain_db > 0.0:
        raise ValueError(
            f"gain_db {gain_db:+g} not representable: the Q15 mixer can "
            f"only attenuate (max gain is 0 dB)")
    q = int(round((10.0 ** (gain_db / 20.0)) * 32768.0))
    return np.int16(max(-32768, min(32767, q)))


def _resample_pcm(pcm: bytes, src_rate: int, ch: int, rate: float, device) -> bytes:
    """16-bit PCM through the exact ``Resampler`` and resample_wav's
    feed/throttle loop (resampler.cpp:100-160)."""
    rs = Resampler(batch=1, exact=True, device=device)
    ok = rs.initialize(ResamplerConfiguration(
        source_sample_rate=float(src_rate), target_sample_rate=float(rate),
        source_bits_per_sample=16, target_bits_per_sample=16,
        channels=ch, use_pre_or_post_filter=True,
        subsample_interpolate=True, number_of_taps=64, number_of_filters=32))
    if not ok:
        raise ValueError("resampler configuration rejected")
    payload, _clipped = resample_pcm_bytes(rs, pcm, ch=ch, src_bits=16,
                                           ratio=float(rate) / float(src_rate))
    return payload


def mix(out_path: str, in_paths: list[str], gains_db: list[float],
        shift: int, rate: float | None, device="cuda") -> int:
    dev = entry_device(device, "mix_wav")
    streams, fmt = [], None
    for p, g in zip(in_paths, gains_db):
        try:
            hdr, pcm = parse_wav(Path(p).read_bytes())
        except (OSError, ValueError) as e:
            print(f"ERROR: {p}: {e}")
            return 1
        if hdr.bits_per_sample != 16:
            print(f"ERROR: {p}: mixer operates on 16-bit PCM "
                  f"(got {hdr.bits_per_sample}-bit); convert first "
                  f"(resample_wav --bits 16)")
            return 1
        sr = hdr.sample_rate
        if rate is not None and sr != rate:
            pcm = _resample_pcm(pcm, sr, hdr.num_channels, rate, dev)
            sr = int(rate)
        this_fmt = (sr, hdr.num_channels)
        if fmt is None:
            fmt = this_fmt
        elif this_fmt != fmt:
            print(f"ERROR: {p}: format {this_fmt} != {fmt} of first input; "
                  f"pass --rate to resample to a common rate")
            return 1
        print(f"  in : {p}: {sr} Hz, {hdr.num_channels} ch, "
              f"{len(pcm) // (hdr.num_channels * 2)} frames, {g:+g} dB")
        streams.append(np.frombuffer(pcm, np.int16))

    n = max(len(s) for s in streams)
    x = np.zeros((len(streams), n), np.int16)
    for i, s in enumerate(streams):
        x[i, :len(s)] = s
    gains = np.array([db_to_q15(g) for g in gains_db], np.int16)

    mixed = mix_s16(torch.as_tensor(x, device=dev), torch.as_tensor(gains, device=dev),
                    shift=shift).cpu().numpy()

    sr, ch = fmt
    n_frames = n // ch
    with open(out_path, "wb") as f:
        write_wav_header(f, sr, ch, 16, n_frames, 2)
        f.write(mixed.tobytes())
    print(f"  out: {out_path}: {sr} Hz, {ch} ch, {n_frames} frames "
          f"(shift {shift})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output")
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--gain-db", type=float, action="append", default=None,
                    help="per-input gain in dB (repeat once per input; "
                    "default 0 dB = Q15 32767)")
    ap.add_argument("--shift", type=int, default=0,
                    help="arithmetic right shift per add (headroom; "
                    "0 wraps on overflow like the C kernel)")
    ap.add_argument("--rate", type=float, default=None,
                    help="resample all inputs to this rate before mixing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    gains = args.gain_db if args.gain_db is not None else [0.0] * len(args.inputs)
    if len(gains) != len(args.inputs):
        print(f"ERROR: {len(gains)} --gain-db flags for {len(args.inputs)} inputs")
        sys.exit(1)
    bad = [g for g in gains if g > 0.0]
    if bad:
        print(f"ERROR: --gain-db {bad[0]:+g} not representable: the Q15 "
              f"mixer (dsps_mulc_s16) can only attenuate: max gain is 0 dB")
        sys.exit(1)
    sys.exit(mix(args.output, args.inputs, gains, args.shift, args.rate, device=args.device))


if __name__ == "__main__":
    main()

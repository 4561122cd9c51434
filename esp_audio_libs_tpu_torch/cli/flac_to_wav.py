"""flac_to_wav: decode a FLAC file to WAV with MD5 verification.

The port's counterpart of examples/flac_to_wav.py (the reference's
host_examples/flac_to_wav/src/flac_to_wav.cpp): header parse, the whole
stream decoded by ``FLACDecoder.decode_stream`` (frames batched into
``flac_frame`` kernel launches on the card), a WAV writer with
WAVE_FORMAT_EXTENSIBLE for 12/20/24/32-bit and multichannel content, and
the STREAMINFO MD5 checked (PASS/FAIL, reference :446-478).

Usage: python -m esp_audio_libs_tpu_torch.cli.flac_to_wav input.flac output.wav
         [--no-verify] [--device cuda|cpu]
Exit codes: 0 ok, 1 read/parse/decode error, 2 MD5 mismatch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..models.flac import FLACDecoder
from ..utils.errors import FLACDecoderResult
from .wav_io import write_wav_header


def convert(in_path: str, out_path: str, verify: bool = True, device="cuda") -> int:
    try:
        blob = Path(in_path).read_bytes()
    except OSError as e:
        print(f"ERROR: cannot read {in_path}: {e.strerror}")
        return 1
    dec = FLACDecoder(device=device)
    res = dec.read_header(blob)
    if res != FLACDecoderResult.SUCCESS:
        print(f"ERROR: header parse failed: {res.name}")
        return 1

    print(f"  {dec.sample_rate} Hz, {dec.num_channels} ch, {dec.sample_depth} bit, "
          f"{dec.num_samples} samples")

    pcm, results = dec.decode_stream(blob[dec.get_bytes_index():], verify_md5=verify)
    bad = [r for r in results["frame_results"] if r != FLACDecoderResult.SUCCESS]
    if bad:
        print(f"ERROR: decode failed: {bad[-1].name} after {results['num_frames']} frames")
        return 1

    bps = dec.get_output_bytes_per_sample()
    n = results["num_samples"] // dec.num_channels
    with open(out_path, "wb") as f:
        write_wav_header(f, dec.sample_rate, dec.num_channels, dec.sample_depth, n, bps)
        f.write(pcm)

    print(f"  wrote {out_path}: {n} samples/channel, {len(pcm)} PCM bytes")
    if verify:
        if results["md5_ok"] is None:
            print("  MD5: no signature in STREAMINFO (skipped)")
        elif results["md5_ok"]:
            print("  MD5: PASS")
        else:
            print("  MD5: FAIL")
            return 2
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys.exit(convert(args.input, args.output, verify=not args.no_verify, device=args.device))


if __name__ == "__main__":
    main()

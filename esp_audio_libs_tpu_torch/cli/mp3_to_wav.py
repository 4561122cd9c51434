"""mp3_to_wav: decode an MP3 file to WAV.

The port's counterpart of examples/mp3_to_wav.py. It drives the public
``MP3Decoder`` as the reference's Helix API is driven (reference
mp3_decoder.cpp:8710-8856): sync search, the frame loop, error tolerance with
zero-filled bad frames; each frame's granules run on the ``mp3_granules``
kernel on the card.

Usage: python -m esp_audio_libs_tpu_torch.cli.mp3_to_wav input.mp3 output.wav
         [--max-frames N] [--device cuda|cpu]
Exit codes: 0 decoded >= 1 frame, 1 no frames / IO error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..models.mp3 import MP3Decoder
from ..utils.errors import MP3Error
from .wav_io import write_wav_header


def convert(in_path: str, out_path: str, max_frames: int | None = None, device="cuda") -> int:
    try:
        data = Path(in_path).read_bytes()
    except OSError as e:
        print(f"ERROR: cannot read {in_path}: {e.strerror}")
        return 1

    dec = MP3Decoder(device=device)
    start = MP3Decoder.find_sync_word(data)
    if start < 0:
        print("ERROR: no MP3 sync word found")
        return 1

    pos = start
    pcm_parts = []
    n_frames = 0
    info = None
    while pos < len(data) and (max_frames is None or n_frames < max_frames):
        err, pcm, consumed = dec.decode(data[pos:])
        if err == MP3Error.NONE:
            if info is None:
                info = dec.get_last_frame_info()
                print(f"  {info['samprate']} Hz, {info['nChans']} ch, "
                      f"{info['bitrate'] // 1000} kbps, MPEG version index {info['version']}")
            pcm_parts.append(bytes(memoryview(pcm)))
            n_frames += 1
        elif pcm is not None:
            pcm_parts.append(bytes(memoryview(pcm)))   # bad frame: zero fill
            n_frames += 1
        if consumed <= 0:
            nxt = MP3Decoder.find_sync_word(data[pos + 1:])
            if nxt < 0:
                break
            pos += 1 + nxt
        else:
            pos += consumed

    if not n_frames or info is None:
        print("ERROR: no frames decoded")
        return 1

    pcm = b"".join(pcm_parts)
    n = len(pcm) // (2 * info["nChans"])
    with open(out_path, "wb") as f:
        write_wav_header(f, info["samprate"], info["nChans"], 16, n, 2)
        f.write(pcm)
    print(f"  wrote {out_path}: {n_frames} frames, {n} samples/channel")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys.exit(convert(args.input, args.output, args.max_frames, device=args.device))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Write the signature file of the port's MP3 conformance runner,
esp_audio_libs_tpu_torch/cli/mp3_conformance_signatures.json, from the JAX
package's decode.

The JAX runner, examples/test_mp3_decoder.py (loaded through importlib; it
imports JAX), generates its corpus with its own ``generate_corpus`` (whose
build-time decode check runs too), and its own loops decode every file:
``our_decode_run_loop`` for the long streams, ``our_decode_loop`` for the
rest, the committed corpus/independent_mp3 files included. For each file the
signature holds its category and intent, the SHA256 and length of its bytes,
the ladder ``[err, consumed, defined]`` per decode attempt, the count of
decoded frames and the payload's length and SHA256. The count of decoded
frames must equal the ``frames`` of the committed JAX report
(build/test_results/mp3_test_report.json), which the C oracle checked.

Run it with JAX on the CPU (a few minutes, most of it the four 1152-frame
streams) whenever the generator's ``CORPUS_VERSION`` changes:

    JAX_PLATFORMS=cpu python3 tools/mp3_conformance_signatures.py [--corpus DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "esp_audio_libs_tpu_torch" / "cli" / "mp3_conformance_signatures.json"
REPORT = REPO / "build" / "test_results" / "mp3_test_report.json"


def jax_runner():
    """examples/test_mp3_decoder.py as a module (JAX on the CPU by default)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    spec = importlib.util.spec_from_file_location("jax_mp3_conformance",
                                                  REPO / "examples" / "test_mp3_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sign_corpus(runner, root: Path, log=print) -> dict:
    """The signatures of ``root``'s generated categories and of
    corpus/independent_mp3, decoded by the JAX runner's loops."""
    sys.path.insert(0, str(REPO))
    from esp_audio_libs_tpu_torch.cli.mp3_conformance import signature

    intents = json.loads((root / "intent.json").read_text())
    files = [(cat, f) for cat in ("standard", "modes", "long", "faulty")
             for f in sorted((root / cat).glob("*.mp3"))]
    files += [("independent", f)
              for f in sorted((REPO / "corpus" / "independent_mp3").glob("*.mp3"))]
    sigs = {}
    for cat, f in files:
        t0 = time.perf_counter()
        intent = intents.get(f.name, "decode" if cat == "independent" else "parity")
        data = f.read_bytes()
        loop = runner.our_decode_run_loop if intent == "decode_long" else runner.our_decode_loop
        frames, n_ok, payload, _ = loop(data)
        sigs[f.name] = {"category": cat, "intent": intent,
                        **signature(data, frames, n_ok, payload)}
        log(f"{cat}/{f.name}: {len(frames)} attempts, {n_ok} frames, "
            f"{time.perf_counter() - t0:.1f} s")
    return sigs


def write_signatures(sigs: dict, version: str, path: Path = OUT) -> None:
    """One file per line, its ladder on that line."""
    lines = [f'  {json.dumps(name)}: {json.dumps(sig, separators=(",", ":"))}'
             for name, sig in sorted(sigs.items())]
    path.write_text('{"corpus_version": ' + json.dumps(version) + ',\n "files": {\n'
                    + ",\n".join(lines) + "\n }\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", type=Path, default=None,
                    help="where the JAX runner generates its corpus (a temporary directory "
                         "by default)")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    runner = jax_runner()
    with tempfile.TemporaryDirectory() as tmp:
        root = args.corpus or Path(tmp) / "mp3_corpus"
        runner.generate_corpus(root)
        sigs = sign_corpus(runner, root)
    want = {r["file"]: r["frames"] for rs in json.loads(REPORT.read_text())["categories"].values()
            for r in rs}
    if want.keys() != sigs.keys():
        raise SystemExit(f"the corpus differs from the committed report's files: "
                         f"{sorted(want.keys() ^ sigs.keys())}")
    bad = [n for n, s in sigs.items() if s["n_ok"] != want[n]]
    if bad:
        raise SystemExit(f"decoded frames differ from the committed report: {bad}")
    write_signatures(sigs, runner.CORPUS_VERSION.decode(), args.out)
    print(f"wrote {args.out}: {len(sigs)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())

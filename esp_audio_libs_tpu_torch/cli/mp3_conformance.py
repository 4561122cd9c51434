"""MP3 conformance runner of the port: the counterpart of
examples/test_mp3_decoder.py.

Runs the port's decoder over a generated corpus in five categories
(standard / modes / long / faulty / independent) and writes text and JSON
reports with the JAX runner's keys (``mp3_test_report.{txt,json}``).

Checks, per file:
  1. the signature: the file's bytes (SHA256), its frame ladder
     ``[err, consumed, defined]`` per decode attempt, its count of decoded
     frames and the SHA256 of its PCM payload (bad frames zero-filled, as
     the CLI writes them) against ``mp3_conformance_signatures.json``, which
     tools/mp3_conformance_signatures.py writes from the JAX runner's own
     loops (``signature_match``; null for a file it does not hold);
  2. the user CLI: ``mp3_to_wav`` driven through a ``WarmCliPool`` of
     persistent workers: its exit code and a WAV payload equal to the
     library decode (``long/`` skips the CLI, as the JAX runner does);
  3. the file's intent (``intent.json``): ``decode`` files must decode at
     least one frame, ``decode_long`` ones at least 1100, ``reject`` ones
     and every ``faulty/`` file none.
There is no C-oracle comparison here: ``reference_match`` stays null.

Short files decode frame by frame through one ``MP3Decoder`` (one
``mp3_granules`` launch per frame on the card); the 30 s streams of
``long/`` through ``BatchedMP3Decoder(1).decode_run`` in runs of 128
frames (one launch per run).

Usage: python -m esp_audio_libs_tpu_torch.cli.mp3_conformance [--corpus DIR]
         [--out DIR] [--no-cli] [--device cuda|cpu] [--signatures FILE]
         [--categories CAT ...]
Exit code 0 when every file passes. ``--categories`` is for a run on the
CPU: there the plain path takes minutes for each stream of ``long/``, so
such a run names the four short categories; on the card every category
runs (the default).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

from ..models.batch import BatchedMP3Decoder
from ..models.mp3 import MP3Decoder
from ..runtime.kernels import entry_device
from .cli_worker import run_conformance, wav_data_payload

REPO = Path(__file__).resolve().parent.parent.parent
TOOLS = REPO / "tools"
SIGNATURES = Path(__file__).resolve().with_name("mp3_conformance_signatures.json")
CATEGORIES = ["standard", "modes", "long", "faulty", "independent"]

# attempt cap, a runaway guard only: every attempt advances >= 1 byte, so a
# file ends by its length; the CLI's --max-frames gets the same value
MAX_FRAMES = 100_000
# the JAX runner's corpus version: a corpus whose .complete differs is
# generated again
CORPUS_VERSION = b"3"
LONG_CHUNK = 128      # frames per decode_run call for long/
LONG_MIN_FRAMES = 1100


def generate_corpus(root: Path):
    """Write the JAX runner's corpus (its ``generate_corpus``) byte for byte:
    ``standard/``, ``modes/``, ``long/``, ``faulty/``, ``intent.json`` and
    the ``.complete`` sentinel holding ``CORPUS_VERSION``.

    The JAX runner also decodes every decode-intent file as it writes it.
    Here the signature file pins each file's bytes and decode instead, and
    :func:`finalize_status` fails a decode-intent file with no frame.
    """
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    from mp3frames import (craft_reservoir_stream, craft_tonal_frame, crafted_frame,
                           frame_sizes, fuzz_frame, make_free_frame, make_header)

    std, modes, longd, faulty = (root / c for c in ("standard", "modes", "long", "faulty"))
    for d in (std, modes, faulty):
        d.mkdir(parents=True, exist_ok=True)
    intent = {}

    def emit(path: Path, blob: bytes, what: str):
        path.write_bytes(blob)
        intent[path.name] = what

    # ---- standard: every version x rate x channel-mode family (MPEG-2.5
    # lives in faulty/: the reference's 12-bit sync mask never finds it)
    fuzz_cfgs = [
        ("mpeg1_mono_128k", dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=3)),
        ("mpeg1_stereo_192k", dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)),
        ("mpeg1_joint_ms", dict(ver_bits=3, bitrate_idx=11, sr_idx=1, mode=1, mode_ext=2)),
        ("mpeg1_joint_ms_is", dict(ver_bits=3, bitrate_idx=11, sr_idx=2, mode=1, mode_ext=3)),
        ("mpeg1_joint_is", dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=1, mode_ext=1)),
        ("mpeg2_stereo", dict(ver_bits=2, bitrate_idx=8, sr_idx=0, mode=0)),
        ("mpeg2_intensity", dict(ver_bits=2, bitrate_idx=8, sr_idx=1, mode=1, mode_ext=1)),
        ("mpeg2_mono", dict(ver_bits=2, bitrate_idx=7, sr_idx=2, mode=3)),
    ]
    for i, (name, cfg) in enumerate(fuzz_cfgs):
        rng = np.random.default_rng(1000 + i)
        emit(std / f"fuzz_{name}.mp3", b"".join(fuzz_frame(cfg, rng) for _ in range(4)),
             "parity")

    tonal_cfgs = [
        ("mpeg1_stereo", dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)),
        ("mpeg1_mono", dict(ver_bits=3, bitrate_idx=9, sr_idx=1, mode=3)),
        ("mpeg2_stereo", dict(ver_bits=2, bitrate_idx=7, sr_idx=0, mode=0)),
        # joint stereo: real spectra through mid/side and intensity
        ("mpeg1_joint_ms", dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=2)),
        ("mpeg1_joint_is", dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=1)),
        ("mpeg1_joint_ms_is", dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=3)),
    ]
    for i, (name, cfg) in enumerate(tonal_cfgs):
        rng = np.random.default_rng(2000 + i)
        emit(std / f"tonal_{name}.mp3", b"".join(craft_tonal_frame(cfg, rng) for _ in range(4)),
             "decode")

    win_cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
    for bt, mixed in [(1, 0), (2, 0), (2, 1), (3, 0)]:
        rng = np.random.default_rng(3000 + bt * 2 + mixed)
        emit(std / f"windows_bt{bt}_mixed{mixed}.mp3",
             b"".join(crafted_frame(win_cfg, bt, mixed, rng) for _ in range(3)), "decode")
    rng = np.random.default_rng(3100)
    emit(std / "windows_mpeg2_short_mixed.mp3",
         b"".join(crafted_frame(dict(ver_bits=2, bitrate_idx=8, sr_idx=0, mode=0), 2, 1, rng)
                  for _ in range(3)), "decode")

    # bit reservoir: real back-references, every frame decodes
    for seed in (0, 1):
        rng = np.random.default_rng(100 + seed)
        cfgs = [dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)] * 5
        emit(std / f"reservoir_{seed}.mp3",
             craft_reservoir_stream(cfgs, rng, gains=(200 + seed, 235)), "decode")
    rng = np.random.default_rng(102)
    cfg = dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)
    total, _ = frame_sizes(3, 11, 0, 0)
    emit(std / "fuzz_reservoir_random.mp3",
         b"".join(make_header(**cfg) + rng.integers(0, 256, total - 4, dtype=np.uint8).tobytes()
                  for _ in range(5)), "parity")

    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=3)
    total, _ = frame_sizes(3, 9, 0, 3)
    emit(std / "silence.mp3", (make_header(**cfg) + bytes(total - 4)) * 3, "decode")

    # VBR: the bitrate index (and the slot size) changes frame to frame
    rng = np.random.default_rng(4100)
    emit(std / "vbr_tonal.mp3", b"".join(
        craft_tonal_frame(dict(ver_bits=3, bitrate_idx=br, sr_idx=0, mode=0), rng)
        for br in (9, 13, 7, 11)), "decode")
    # VBR + reservoir: back-references cross slots of different sizes
    rng = np.random.default_rng(4101)
    emit(std / "vbr_reservoir.mp3", craft_reservoir_stream(
        [dict(ver_bits=3, bitrate_idx=br, sr_idx=0, mode=0) for br in (9, 12, 6, 11, 13)], rng),
        "decode")

    # mid-stream garbage (bytes < 0xFF: no false sync word): resync
    rng = np.random.default_rng(42)
    f1 = craft_tonal_frame(dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0), rng)
    junk = bytes(int(x) for x in rng.integers(0, 0xFE, 37))
    f2 = craft_tonal_frame(dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0), rng)
    emit(std / "midstream_garbage.mp3", f1 + junk + f2, "decode")

    # ---- modes: free bitrate, the slot size found from the second sync
    # (reference MP3FindFreeSync :8570-8610)
    emit(modes / "free_silent.mp3", b"".join(make_free_frame(100) for _ in range(4)), "decode")
    rng = np.random.default_rng(7)
    emit(modes / "free_tonal.mp3",
         b"".join(make_free_frame(120, tonal_rng=rng, mode=0) for _ in range(4)), "decode")
    emit(modes / "free_padding.mp3",
         b"".join(make_free_frame(100, padding=p) for p in (0, 1, 1, 0)), "decode")

    # ---- long: 1152 frames (30.1 s at 44.1 kHz MPEG-1 / 22.05 kHz MPEG-2),
    # the reservoir evolving over hundreds of frames; a multiple of the
    # runner's decode_run chunk
    longd.mkdir(parents=True, exist_ok=True)
    NLONG = 1152
    rng = np.random.default_rng(9001)
    emit(longd / "long_tonal_mpeg1_stereo.mp3", b"".join(
        craft_tonal_frame(dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0), rng)
        for _ in range(NLONG)), "decode_long")
    rng = np.random.default_rng(9002)
    emit(longd / "long_reservoir_mpeg1_stereo.mp3", craft_reservoir_stream(
        [dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)] * NLONG, rng, gains=(200, 235)),
        "decode_long")
    rng = np.random.default_rng(9003)
    emit(longd / "long_vbr_reservoir_mpeg1.mp3", craft_reservoir_stream(
        [dict(ver_bits=3, bitrate_idx=(9, 12, 6, 11, 13)[i % 5], sr_idx=0, mode=0)
         for i in range(NLONG)], rng), "decode_long")
    rng = np.random.default_rng(9004)
    emit(longd / "long_tonal_mpeg2_stereo.mp3", b"".join(
        craft_tonal_frame(dict(ver_bits=2, bitrate_idx=7, sr_idx=0, mode=0), rng)
        for _ in range(NLONG)), "decode_long")

    # ---- faulty: whole-stream rejects
    rng = np.random.default_rng(13)
    emit(faulty / "garbage.mp3", bytes(int(x) for x in rng.integers(0, 0xFE, 512)), "reject")
    emit(faulty / "empty.mp3", b"", "reject")
    # MPEG-2.5: the reference's sync mask demands 12 set bits, so such a
    # header never syncs (include/mp3_decoder.h:41-42)
    rng = np.random.default_rng(1008)
    emit(faulty / "mpeg25_sync_unreachable_mono.mp3", b"".join(
        craft_tonal_frame(dict(ver_bits=0, bitrate_idx=8, sr_idx=0, mode=3),
                          np.random.default_rng(2006)) for _ in range(4)), "reject")
    emit(faulty / "mpeg25_sync_unreachable_stereo.mp3", b"".join(
        fuzz_frame(dict(ver_bits=0, bitrate_idx=8, sr_idx=1, mode=0), rng) for _ in range(4)),
        "reject")
    # hardened_: the reference over-reads a truncated buffer here; this
    # decoder and the CLI must reject it
    emit(faulty / "hardened_truncated_header.mp3", b"\xff\xfb", "reject")
    emit(faulty / "reserved_layer.mp3", make_header(layer_bits=0) + bytes(200), "reject")
    emit(faulty / "reserved_version.mp3", make_header(ver_bits=1) + bytes(200), "reject")
    emit(faulty / "reserved_samplerate.mp3", make_header(sr_idx=3) + bytes(200), "reject")
    emit(faulty / "invalid_bitrate.mp3", make_header(bitrate_idx=15) + bytes(200), "reject")
    emit(faulty / "free_no_second_sync.mp3", make_free_frame(100), "reject")
    (root / "intent.json").write_text(json.dumps(intent, indent=1))
    # written last: an interrupted generation is generated again
    (root / ".complete").write_bytes(CORPUS_VERSION)


def install_independent_corpus(root: Path):
    """Copy the committed ``corpus/independent_mp3`` files (structural
    mutants the reference accepted, each decoding >= 1 frame) into the
    corpus's ``independent/`` category; their intent is ``decode``."""
    src = REPO / "corpus" / "independent_mp3"
    if not src.is_dir():
        return
    dst = root / "independent"
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.mp3"):
        (dst / f.name).write_bytes(f.read_bytes())


def corpus_complete(root: Path) -> bool:
    sentinel = root / ".complete"
    return sentinel.exists() and sentinel.read_bytes() == CORPUS_VERSION


def our_decode_loop(data: bytes, device="cuda"):
    """Decode a whole file with the CLI's loop (mp3_to_wav): one
    ``MP3Decoder``, sync search, then ``consumed`` advances, a resync after
    an attempt that consumed nothing. Returns (frames [(err, consumed,
    defined)] per attempt, n_ok, payload, pcms): the payload holds every
    PCM the attempts returned (bad frames zero-filled), ``pcms`` the PCM
    bytes of each successful attempt (None otherwise)."""
    dec = MP3Decoder(device=device)
    start = MP3Decoder.find_sync_word(data)
    if start < 0:
        return [], 0, b"", []
    pos = start
    frames, pcms, parts = [], [], []
    n_ok = 0
    while pos < len(data) and len(frames) < MAX_FRAMES:
        err, pcm, consumed = dec.decode(data[pos:])
        frames.append((int(err), int(consumed), bool(dec.last_frame_reference_defined)))
        b = None if pcm is None else bytes(memoryview(pcm))
        if b is not None:
            parts.append(b)
        if int(err) == 0:
            n_ok += 1
        pcms.append(b if int(err) == 0 else None)
        if consumed <= 0:
            nxt = MP3Decoder.find_sync_word(data[pos + 1:])
            if nxt < 0:
                break
            pos += 1 + nxt
        else:
            pos += consumed
    return frames, n_ok, b"".join(parts), pcms


def our_decode_run_loop(data: bytes, device="cuda", chunk: int = LONG_CHUNK):
    """The long-stream loop: the per-frame semantics of
    :func:`our_decode_loop`, with every ``chunk`` frames synthesized by one
    ``BatchedMP3Decoder(1).decode_run`` call (one granule-kernel launch).
    ``defined`` is the flag read after a run, given to each of its frames;
    the loop advances by the run's ``next_pos`` and stops when a run
    decodes nothing or does not advance. Returns what
    :func:`our_decode_loop` returns."""
    dec = BatchedMP3Decoder(1, device=device)
    frames, pcms, parts = [], [], []
    n_ok = 0
    pos = 0
    while pos < len(data) and len(frames) < MAX_FRAMES:
        runs = dec.decode_run([data[pos:]], chunk)
        if not runs[0]:
            break
        defined = bool(dec.last_frame_reference_defined[0])
        for err, pcm, consumed in runs[0]:
            frames.append((int(err), int(consumed), defined))
            b = None if pcm is None else bytes(memoryview(np.asarray(pcm)))
            if b is not None:
                parts.append(b)
            if int(err) == 0:
                n_ok += 1
            pcms.append(b if int(err) == 0 else None)
        adv = int(runs.next_pos[0])
        if adv <= 0:
            break
        pos += adv
    return frames, n_ok, b"".join(parts), pcms


def signature(data: bytes, frames, n_ok: int, payload: bytes) -> dict:
    """A file's signature: its bytes' SHA256, the frame ladder, n_ok and the
    payload's length and SHA256."""
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "ladder": [[int(e), int(c), bool(d)] for e, c, d in frames], "n_ok": int(n_ok),
            "payload_bytes": len(payload), "payload_sha256": hashlib.sha256(payload).hexdigest()}


def load_signatures(path: Path = SIGNATURES) -> dict:
    """The signature file: {"corpus_version", "files": {name: {category,
    intent, sha256, bytes, ladder, n_ok, payload_bytes, payload_sha256}}}."""
    return json.loads(Path(path).read_text())


def signature_matches(got: dict, want: dict) -> bool:
    return all(got[k] == want[k] for k in got)


def drive_cli(path: Path, out_dir: Path, expect_fail: bool, expected_payload, warm_pool):
    """Drive the user CLI, ``mp3_to_wav``, through the warm pool: its exit
    code and WAV payload. ``expected_payload is None`` means the library
    decoded no frame, so the CLI must exit nonzero (it writes no WAV)."""
    out_wav = out_dir / (path.stem + ".wav")
    try:
        rc, _ = warm_pool.drive(str(path), str(out_wav), max_frames=MAX_FRAMES)
    except (OSError, ValueError):
        return False   # a broken worker fails this file, not the run
    if expect_fail or expected_payload is None:
        return rc != 0
    if rc != 0:
        return False
    return wav_data_payload(out_wav) == expected_payload


def check_file(path: Path, expect_fail: bool, intent: str = "parity", device="cuda",
               want_sig: dict | None = None, cli_out: Path | None = None):
    """Decode one file and hold it to its signature (the JAX runner's
    ``test_single_file`` without the C oracle). Returns its row and, with
    ``cli_out``, its CLI drive (a function of the warm pool,
    :func:`drive_cli`), else None; :func:`finalize_status` sets the status
    once the drive has resolved."""
    blob = path.read_bytes()
    t0 = time.perf_counter()
    result = {"file": path.name, "frames": 0, "reference_match": None, "cli": None,
              "status": "fail", "intent": intent, "parity": None, "seconds": 0.0,
              "signature_match": None}
    loop = our_decode_run_loop if intent == "decode_long" else our_decode_loop
    frames, n_ok, payload, _ = loop(blob, device)
    result["frames"] = n_ok
    if want_sig is not None:
        result["signature_match"] = signature_matches(
            signature(blob, frames, n_ok, payload), want_sig)
    job = None
    if cli_out is not None:
        job = partial(drive_cli, path, cli_out, expect_fail, payload if n_ok else None)
    result["_expect_fail"] = expect_fail
    result["_n_ok"] = n_ok
    result["seconds"] = round(time.perf_counter() - t0, 3)
    return result, job


def finalize_status(result):
    """Set ``parity`` and ``status`` once every check has resolved. Decode
    parity (frames decoded) and reject parity (none) are reported apart, and
    the intent is enforced: a decode-intent file that decodes nothing fails.
    At least one oracle (the signature or the CLI) must have run, else the
    file fails rather than passing vacuously."""
    n_ok = result.pop("_n_ok")
    result["parity"] = "decode" if n_ok > 0 else "reject"
    oracles = [result[k] for k in ("reference_match", "signature_match", "cli")
               if result[k] is not None]
    checks = list(oracles)
    if result.pop("_expect_fail"):
        checks.append(n_ok == 0)
    if result["intent"] == "decode":
        checks.append(n_ok >= 1)
    elif result["intent"] == "decode_long":
        checks.append(n_ok >= LONG_MIN_FRAMES)
    elif result["intent"] == "reject":
        checks.append(n_ok == 0)
    result["status"] = "pass" if oracles and all(checks) else "fail"


def read_intents(corpus: Path) -> dict:
    """``intent.json`` of the corpus; the independent files' intent is
    ``decode``."""
    p = corpus / "intent.json"
    intents = json.loads(p.read_text()) if p.exists() else {}
    for f in (corpus / "independent").glob("*.mp3"):
        intents.setdefault(f.name, "decode")
    return intents


def run_suite(corpus: Path, out: Path, device="cuda", cli: bool = True, workers: int = 4,
              signatures: Path | None = SIGNATURES, categories=CATEGORIES, on_file=None):
    """Run every ``*.mp3`` of the corpus's category folders; write
    ``mp3_test_report.{txt,json}`` under ``out``. ``on_file(category,
    result)``, when given, is called after each file's decode. Returns the
    report dict (``categories``: per category the per-file results;
    ``summary``)."""
    device = str(entry_device(device, "mp3_conformance"))
    intents = read_intents(corpus)
    sigs = load_signatures(signatures)["files"] if signatures is not None else {}

    def check(cat, f, cli_out):
        return check_file(f, cat == "faulty", intents.get(f.name, "parity"), device,
                          sigs.get(f.name), cli_out)

    return run_conformance(
        corpus, out, check, codec="mp3", categories=categories, report="mp3_test_report",
        checks="the JAX decode's signatures and the mp3_to_wav CLI", finalize=finalize_status,
        row_text=lambda r: (f"frames={r['frames']}, intent={r['intent']}, "
                            f"ref={r['reference_match']}, sig={r['signature_match']}, "
                            f"cli={r['cli']}"),
        device=device, cli=cli, workers=workers, wav_dir="mp3_wav", no_cli=("long",),
        on_file=on_file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", type=Path, default=REPO / "build" / "torch_mp3_corpus")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "torch_mp3_results")
    ap.add_argument("--no-cli", action="store_true",
                    help="skip driving the mp3_to_wav CLI per file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--signatures", type=Path, default=SIGNATURES,
                    help="the signature file the decodes are held to")
    ap.add_argument("--categories", nargs="+", default=CATEGORIES, choices=CATEGORIES,
                    help="the categories to run (all by default; on the CPU the four long "
                         "streams take many minutes)")
    args = ap.parse_args(argv)
    device = str(entry_device(args.device, "mp3_conformance"))
    if not corpus_complete(args.corpus):
        print(f"generating corpus at {args.corpus}")
        generate_corpus(args.corpus)
    install_independent_corpus(args.corpus)
    report = run_suite(args.corpus, args.out, device, cli=not args.no_cli,
                       signatures=args.signatures, categories=args.categories)
    print((args.out / "mp3_test_report.txt").read_text())
    print(f"reports: {args.out}/mp3_test_report.{{txt,json}}")
    s = report["summary"]
    return 0 if s["total"] and s["passed"] == s["total"] else 1


if __name__ == "__main__":
    sys.exit(main())

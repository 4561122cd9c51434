"""FLAC conformance runner of the port: the counterpart of
examples/test_flac_decoder.py.

Runs the port's decoder over a corpus of FLAC files in four categories
(subset / uncommon / faulty / independent) and writes text and JSON reports
with the JAX runner's keys (``test_report.{txt,json}``).

Checks, per file:
  1. the primary oracle: the MD5 of the PCM that ``FLACDecoder`` decodes
     against the STREAMINFO signature (the reference CLI's own self-check);
  2. the user CLI: ``flac_to_wav`` driven through a ``WarmCliPool`` of
     persistent workers; its exit code, its ``MD5: PASS`` line and a WAV
     payload equal to the library decode.
There is no C-oracle comparison here: ``reference_match`` stays null and a
file passes on its other checks, as the JAX runner's files do without the
oracle. Files in ``faulty/`` (except ``accept_*``) and ``reject_*`` files
must be rejected by the decoder and the CLI.

Without a corpus the runner generates one: the same files as the JAX
runner's ``generate_corpus`` (tools/flacgen.py: every subframe type, stereo
mode, bit depth, several corrupt streams) plus the committed
corpus/independent files.

Usage: python -m esp_audio_libs_tpu_torch.cli.flac_conformance [--corpus DIR]
         [--out DIR] [--no-cli] [--device cuda|cpu]
Exit code 0 when every file passes.
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

from ..models.flac import FLACDecoder
from ..utils.errors import FLACDecoderResult
from .cli_worker import run_conformance, wav_data_payload

REPO = Path(__file__).resolve().parent.parent.parent
TOOLS = REPO / "tools"
CATEGORIES = ["subset", "uncommon", "faulty", "independent"]


def install_independent_corpus(root: Path):
    """Copy the committed ``independent`` category into the working corpus.

    These files come from outside the generator: ``enc2_*`` are
    encoded by tools/flacgen2.py — a second encoder whose every structural
    choice (order selection, Rice params, partition search, stereo mode) is
    cost-measured, not plan-scripted — and ``mut_*`` are structure-aware
    mutants that the REFERENCE decoder accepted at generation time
    (tools/flacmut.py), with STREAMINFO MD5 signatures rewritten from the
    oracle-verified PCM.  They are committed (corpus/independent/) so the
    category is hermetic: CI re-verifies MD5 + CLI without the reference
    mounted, and the full differential runs wherever it is."""
    src = REPO / "corpus" / "independent"
    dst = root / "independent"
    if not src.is_dir():
        return
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.flac"):
        (dst / f.name).write_bytes(f.read_bytes())


def generate_corpus(root: Path):
    """Synthesize the corpus with tools/flacgen.py: the JAX runner's files,
    byte for byte."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    from flacgen import SubframePlan

    (root / "subset").mkdir(parents=True, exist_ok=True)
    (root / "uncommon").mkdir(parents=True, exist_ok=True)
    (root / "faulty").mkdir(parents=True, exist_ok=True)

    subset = [
        dict(rng_seed=1, depth=16, channels=2, block_size=4096, n_frames=4,
             stereo_modes=["ms", "ls", "rs", None],
             plans=[[SubframePlan("lpc", order=8), SubframePlan("lpc", order=8)]] * 4),
        dict(rng_seed=2, depth=16, channels=1, block_size=1152, n_frames=3,
             plans=[[SubframePlan("fixed", order=o)] for o in (2, 3, 4)]),
        dict(rng_seed=3, depth=24, channels=2, block_size=2048, n_frames=3,
             plans=[[SubframePlan("lpc", order=12, partition_order=2),
                     SubframePlan("lpc", order=6)]] * 3),
        dict(rng_seed=4, depth=8, channels=1, block_size=256, n_frames=2,
             plans=[[SubframePlan("verbatim")], [SubframePlan("constant")]]),
        dict(rng_seed=5, depth=16, channels=2, block_size=576, n_frames=3,
             plans=[[SubframePlan("lpc", order=2, escape=True),
                     SubframePlan("fixed", order=1)]] * 3),
        dict(rng_seed=6, depth=16, channels=1, block_size=192, n_frames=4,
             plans=[[SubframePlan("lpc", order=32)]] * 4),
        dict(rng_seed=7, depth=16, channels=2, block_size=4096, n_frames=4,
             stereo_modes=["ms", "ls", "rs", None],
             plans=[[SubframePlan("lpc", order=8, fit=True),
                     SubframePlan("lpc", order=12, fit=True)]] * 4),
    ]
    SP = SubframePlan
    lpc2 = lambda **kw: [[SP("lpc", order=8, fit=True, **kw),
                          SP("lpc", order=8, fit=True, **kw)]]
    # --- blocksize series (ietf subset 01-10: 16..4608, incl. non-pow2) ---
    for s, bs in enumerate([4608, 16, 192, 254, 512, 725, 1000, 1937, 2304]):
        subset.append(dict(rng_seed=30 + s, depth=16, channels=2, block_size=bs,
                           n_frames=2, plans=lpc2() * 2 if bs >= 32 else
                           [[SP("fixed", order=1), SP("fixed", order=2)]] * 2))
    # --- rice partition orders 0..8 (ietf 11 + partition files) ---
    for s, po in enumerate([0, 1, 3, 5, 8]):
        subset.append(dict(rng_seed=40 + s, depth=16, channels=2, block_size=4096,
                           n_frames=2, plans=lpc2(partition_order=po) * 2))
    # --- qlp coefficient precision extremes (ietf 12-13) ---
    subset.append(dict(rng_seed=45, depth=16, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=8, precision=15, fit=True)] * 2] * 2))
    subset.append(dict(rng_seed=46, depth=16, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=2, precision=2, shift=1)] * 2] * 2))
    # --- wasted bits (ietf 14) ---
    subset.append(dict(rng_seed=47, depth=16, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=6, wasted=1), SP("lpc", order=6, wasted=5)]] * 2))
    # --- only-verbatim / only-constant streams (ietf 15-16) ---
    subset.append(dict(rng_seed=48, depth=16, channels=2, block_size=1152, n_frames=3,
                       plans=[[SP("verbatim"), SP("verbatim")]] * 3))
    subset.append(dict(rng_seed=49, depth=16, channels=2, block_size=1152, n_frames=3,
                       plans=[[SP("constant"), SP("constant")]] * 3))
    # --- all fixed predictor orders 0-4 (ietf 17) ---
    subset.append(dict(rng_seed=50, depth=16, channels=1, block_size=2304, n_frames=5,
                       plans=[[SP("fixed", order=o)] for o in range(5)]))
    # --- odd + explicit-coded sample rates (ietf 19-21) ---
    subset.append(dict(rng_seed=51, depth=16, channels=2, block_size=4096, n_frames=2,
                       sample_rate=35467, sr_code_override=13, plans=lpc2() * 2))
    subset.append(dict(rng_seed=52, depth=16, channels=2, block_size=4096, n_frames=2,
                       sample_rate=39000, sr_code_override=14, plans=lpc2() * 2))
    subset.append(dict(rng_seed=53, depth=16, channels=2, block_size=2304, n_frames=2,
                       sample_rate=22050, plans=lpc2() * 2))
    subset.append(dict(rng_seed=54, depth=16, channels=1, block_size=1024, n_frames=2,
                       sample_rate=96000, sr_code_override=12,
                       plans=[[SP("lpc", order=4)]] * 2))
    # --- bit depths 8/12/20/24/32 stereo (ietf 22-23 + uncommon depths) ---
    for s, dep in enumerate([8, 12, 20, 24, 32]):
        subset.append(dict(rng_seed=55 + s, depth=dep, channels=2, block_size=2048,
                           n_frames=2, stereo_modes=["ms", "ls"], plans=lpc2() * 2))
    # --- variable blocksize streams (ietf 24-25) ---
    subset.append(dict(rng_seed=60, depth=16, channels=2,
                       block_sizes=[4096, 1152, 576, 2048], n_frames=4,
                       stereo_modes=["ms", None, "ls", "rs"], plans=lpc2() * 4))
    subset.append(dict(rng_seed=61, depth=16, channels=1,
                       block_sizes=[192, 725, 4096], n_frames=3,
                       plans=[[SP("fixed", order=2)], [SP("lpc", order=8, fit=True)],
                              [SP("lpc", order=12, fit=True)]]))
    # --- channel counts 3-8 (ietf 26-31) ---
    for s, nch in enumerate([3, 4, 5, 6, 7, 8]):
        subset.append(dict(rng_seed=62 + s, depth=16, channels=nch, block_size=256,
                           n_frames=2,
                           plans=[[SP("lpc", order=4, fit=True) for _ in range(nch)],
                                  [SP("fixed", order=2) for _ in range(nch)]]))
    # --- stereo decorrelation, one mode per file (ietf 32-35) ---
    for s, mode in enumerate(["rs", "ls", "ms", None]):
        subset.append(dict(rng_seed=68 + s, depth=16, channels=2, block_size=4096,
                           n_frames=2, stereo_modes=[mode] * 2, plans=lpc2() * 2))
    # --- metadata variants (ietf 36-41); content is opaque to both decoders,
    #     size-limit/skip handling is what's exercised ---
    md_rng = np.random.default_rng(99)
    big_padding = bytes(100 * 1024)
    seektable = b"".join(  # 18-byte seekpoints
        int(i).to_bytes(8, "big") + int(i * 1000).to_bytes(8, "big") + (4096).to_bytes(2, "big")
        for i in range(32))
    vorbis = (b"\x0b\x00\x00\x00flacgen 1.0\x02\x00\x00\x00"
              b"\x0c\x00\x00\x00TITLE=corpus" b"\x10\x00\x00\x00ARTIST=synthetic")
    picture = (b"\x00\x00\x00\x06" + b"\x00\x00\x00\x09image/png" + b"\x00" * 20 +
               (8192).to_bytes(4, "big") + md_rng.integers(0, 256, 8192, dtype=np.uint8).tobytes())
    application = b"eal!" + md_rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    cuesheet = bytes(128) + (1).to_bytes(1, "big") + bytes(395)
    for s, (mtype, mdata) in enumerate([(1, big_padding), (3, seektable), (4, vorbis),
                                        (6, picture), (2, application), (5, cuesheet)]):
        subset.append(dict(rng_seed=72 + s, depth=16, channels=2, block_size=4096,
                           n_frames=2, metadata=[(mtype, mdata)], plans=lpc2() * 2))
    # --- high sample rates at depth (ietf high-rate files) ---
    subset.append(dict(rng_seed=80, depth=24, channels=2, block_size=4096, n_frames=2,
                       sample_rate=96000, plans=lpc2() * 2))
    subset.append(dict(rng_seed=81, depth=24, channels=2, block_size=4096, n_frames=2,
                       sample_rate=192000, plans=lpc2() * 2))
    subset.append(dict(rng_seed=82, depth=16, channels=2, block_size=4096, n_frames=2,
                       sample_rate=384000, sr_code_override=0, plans=lpc2() * 2))
    # --- filling combos: escapes, high orders, mixed kinds, short tail ---
    subset.append(dict(rng_seed=83, depth=16, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=8, escape=True), SP("lpc", order=8)]] * 2))
    subset.append(dict(rng_seed=84, depth=16, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=25, fit=True), SP("lpc", order=32, fit=True)]] * 2))
    subset.append(dict(rng_seed=85, depth=16, channels=2, block_size=4096, n_frames=3,
                       plans=[[SP("constant"), SP("lpc", order=8)],
                              [SP("verbatim"), SP("fixed", order=3)],
                              [SP("lpc", order=16, fit=True), SP("verbatim")]]))
    subset.append(dict(rng_seed=86, depth=16, channels=2, block_size=4096, n_frames=3,
                       last_block_size=137, plans=lpc2() * 3))
    subset.append(dict(rng_seed=87, depth=16, channels=2, block_size=4096, n_frames=2,
                       metadata=[(1, bytes(64)), (4, b"\x04\x00\x00\x00gen\x00\x00\x00\x00"),
                                 (3, bytes(18 * 4))], plans=lpc2() * 2))
    subset.append(dict(rng_seed=88, depth=12, channels=1, block_size=254, n_frames=3,
                       uncommon_bs_code=True,
                       plans=[[SP("lpc", order=6, fit=True)]] * 3))
    subset.append(dict(rng_seed=89, depth=24, channels=2, block_size=4096, n_frames=2,
                       plans=[[SP("lpc", order=12, fit=True, partition_order=6),
                               SP("lpc", order=16, fit=True, partition_order=4)]] * 2))
    assert len(subset) == 64, len(subset)
    uncommon = [
        dict(rng_seed=11, depth=32, channels=2, block_size=512, n_frames=2,
             plans=[[SubframePlan("lpc", order=4), SubframePlan("verbatim")]] * 2),
        dict(rng_seed=12, depth=20, channels=2, block_size=1000, n_frames=2,
             uncommon_bs_code=True, stereo_modes=["ms", None],
             plans=[[SubframePlan("lpc", order=8), SubframePlan("fixed", order=2)]] * 2),
        dict(rng_seed=13, depth=12, channels=1, block_size=250, n_frames=2,
             uncommon_bs_code=True,
             plans=[[SubframePlan("fixed", order=0)], [SubframePlan("lpc", order=7)]]),
        dict(rng_seed=14, depth=16, channels=1, block_size=256, n_frames=2,
             plans=[[SubframePlan("lpc", order=5, wasted=3)],
                    [SubframePlan("verbatim", wasted=2)]]),
        # reference-envelope extremes (TESTING.md:82-96): 1-8 channels,
        # 22.05-768 kHz, block sizes 16-65535, depths 8-32
        dict(rng_seed=15, depth=16, channels=8, block_size=256, n_frames=2,
             plans=[[SubframePlan("lpc", order=4) for _ in range(8)],
                    [SubframePlan("fixed", order=2) for _ in range(8)]]),
        dict(rng_seed=16, depth=24, channels=4, block_size=1024, n_frames=2, sample_rate=96000,
             plans=[[SubframePlan("lpc", order=8, fit=True) for _ in range(4)]] * 2),
        dict(rng_seed=17, depth=16, channels=2, block_size=16, n_frames=3, uncommon_bs_code=True,
             plans=[[SubframePlan("lpc", order=2), SubframePlan("fixed", order=1)]] * 3),
        dict(rng_seed=18, depth=16, channels=1, block_size=65535, n_frames=1, sample_rate=768000,
             plans=[[SubframePlan("lpc", order=8, fit=True)]]),
        dict(rng_seed=19, depth=32, channels=2, block_size=256, n_frames=2, sample_rate=176400,
             plans=[[SubframePlan("lpc", order=8, wasted=2), SubframePlan("verbatim")]] * 2),
        dict(rng_seed=20, depth=16, channels=3, block_size=4096, n_frames=2, sample_rate=22050,
             plans=[[SubframePlan("lpc", order=16, fit=True, partition_order=4),
                     SubframePlan("fixed", order=3),
                     SubframePlan("lpc", order=8, escape=True)]] * 2),
    ]
    from flacgen import make_flac as mk
    for i, cfg in enumerate(subset):
        blob, _ = mk(**cfg)
        (root / "subset" / f"subset_{i:02d}.flac").write_bytes(blob)
    for i, cfg in enumerate(uncommon):
        blob, _ = mk(**cfg)
        (root / "uncommon" / f"uncommon_{i:02d}.flac").write_bytes(blob)
    # uncommon expect-fail classes (reference TESTING.md:93-96): mid-stream
    # parameter changes and headerless streams are rejected (not supported
    # by either decoder).  Header size with STREAMINFO only is 4+4+34=42.
    ua, _ = mk(rng_seed=25, depth=16, channels=2, block_size=1024, n_frames=2,
               plans=[[SubframePlan("lpc", order=4)] * 2] * 2)
    ub, _ = mk(rng_seed=26, depth=16, channels=3, block_size=1024, n_frames=1,
               plans=[[SubframePlan("lpc", order=4)] * 3])
    (root / "uncommon" / "reject_midstream_channel_change.flac").write_bytes(
        ua + ub[42:])
    (root / "uncommon" / "reject_headerless.flac").write_bytes(ua[42:])
    # faulty: corrupted variants, mirroring the reference corpus's failure
    # classes (TESTING.md:98-104).  Reject-class files must fail in BOTH
    # decoders; "accept_" files carry errors both decoders tolerate
    # gracefully (garbage skipped by sync search, unvalidated header fields)
    # and must decode with verified MD5 — the reference corpus has both
    # kinds ("some files may be accepted if the error is in metadata we
    # don't validate").
    from flacgen import STANDARD_RATES, SubframePlan as SP
    blob, _ = mk(**subset[0])
    (root / "faulty" / "bad_magic.flac").write_bytes(b"fLaX" + blob[4:])
    bad2 = bytearray(blob)
    bad2[-3] ^= 0xFF  # corrupt last frame CRC region
    (root / "faulty" / "crc_mismatch.flac").write_bytes(bytes(bad2))
    (root / "faulty" / "truncated.flac").write_bytes(blob[: len(blob) // 2])
    # mid-frame truncation: cut inside the LAST frame's payload
    (root / "faulty" / "mid_frame_truncated.flac").write_bytes(blob[:-9])
    # mid-header truncation: cut inside the metadata region
    (root / "faulty" / "mid_header_truncated.flac").write_bytes(blob[:20])
    # reserved subframe type code (spec §9.2.1)
    b6, _ = mk(rng_seed=70, depth=16, channels=2, block_size=256, n_frames=1,
               plans=[[SP("reserved"), SP("fixed", order=1)]])
    (root / "faulty" / "reserved_subframe.flac").write_bytes(b6)
    # reserved residual coding method (spec §9.2.7)
    b7, _ = mk(rng_seed=71, depth=16, channels=2, block_size=256, n_frames=1,
               plans=[[SP("lpc", order=4, bad_residual_method=True),
                       SP("fixed", order=1)]])
    (root / "faulty" / "reserved_residual_method.flac").write_bytes(b7)
    # rice partition order that does not divide the block size.  "hardened_"
    # class: the reference DISCARDS decode_subframes' return value
    # (flac_decoder.cpp:220 — no `ret =`), so with a structurally-valid
    # CRC16 it reports SUCCESS and emits uninitialized memory as PCM; its
    # output is nondeterministic and not a usable oracle here.  This repo
    # propagates BLOCK_SIZE_NOT_DIVISIBLE_RICE (the check the reference has
    # at :858-861 but loses).  Pass = our decoder and CLI reject.
    b8, _ = mk(rng_seed=72, depth=16, channels=1, block_size=1000, n_frames=1,
               plans=[[SP("lpc", order=4, bad_partition_order=True)]])
    (root / "faulty" / "hardened_bad_partition_order.flac").write_bytes(b8)
    # frame channel assignment contradicting STREAMINFO (validated, :634-645)
    b9, _ = mk(rng_seed=73, depth=16, channels=2, block_size=256, n_frames=1,
               plans=[[SP("fixed", order=1), SP("fixed", order=1)]],
               ca_override=0)
    (root / "faulty" / "channel_mismatch.flac").write_bytes(b9)
    # reserved frame sample-rate code 15 (spec: invalid)
    b10, _ = mk(rng_seed=74, depth=16, channels=1, block_size=256, n_frames=1,
                plans=[[SP("fixed", order=1)]], sr_code_override=15)
    (root / "faulty" / "reserved_sample_rate.flac").write_bytes(b10)
    # accept-class: metadata block length field overflowing the file — both
    # decoders read STREAMINFO's fixed 34 bytes and tolerate the bogus
    # declared length identically ("errors in metadata we don't validate",
    # reference TESTING.md:102-104); output stays MD5-verified
    b11 = bytearray(blob)
    b11[5:8] = (0xFFFFFF).to_bytes(3, "big")  # STREAMINFO length -> 16 MB
    (root / "faulty" / "accept_metadata_overflow.flac").write_bytes(bytes(b11))
    # accept-class: junk between frames is skipped by frame sync search
    b12, _ = mk(rng_seed=75, depth=16, channels=2, block_size=1024, n_frames=3,
                plans=[[SP("lpc", order=6), SP("fixed", order=2)]] * 3,
                inter_frame_garbage=23)
    (root / "faulty" / "accept_interframe_garbage.flac").write_bytes(b12)
    # wrong (but valid) sample-rate code in the frame header: both decoders
    # validate it against STREAMINFO (reference flac_decoder.cpp:655-659;
    # no mid-stream rate changes) -> reject class
    b13, _ = mk(rng_seed=76, depth=16, channels=2, block_size=256, n_frames=2,
                plans=[[SP("fixed", order=2), SP("lpc", order=4)]] * 2,
                sr_code_override=STANDARD_RATES[48000])
    (root / "faulty" / "wrong_sample_rate.flac").write_bytes(b13)


def drive_cli(path: Path, out_dir: Path, expect_fail: bool, ref_pcm, warm_pool):
    """Drive the user CLI, ``flac_to_wav``, through the warm pool and read
    its result as the reference harness reads its example binary's
    (reference test_flac_decoder.py:152-259): the exit code, the MD5 PASS
    line and, for a file the library decoded, the WAV payload byte for
    byte."""
    out_wav = out_dir / (path.stem + ".wav")
    try:
        rc, stdout = warm_pool.drive(str(path), str(out_wav))
    except (OSError, ValueError):
        return False   # a broken worker fails this file, not the run
    if expect_fail:
        return rc != 0
    if rc != 0:
        return False
    if "MD5: PASS" not in stdout and "no signature" not in stdout:
        return False
    return ref_pcm is None or wav_data_payload(out_wav) == ref_pcm


def check_file(path: Path, expect_fail: bool, device="cuda", cli_out: Path | None = None):
    """The checks of one file (the JAX runner's ``test_single_file`` without
    the C oracle). Returns its row and, with ``cli_out``, its CLI drive (a
    function of the warm pool, :func:`drive_cli`), else None."""
    blob = path.read_bytes()
    t0 = time.perf_counter()
    result = {"file": path.name, "md5": None, "reference_match": None,
              "cli": None, "status": "fail", "parity": None, "seconds": 0.0}

    dec = FLACDecoder(device=device)
    pcm = b""
    decode_ok = False
    if dec.read_header(blob) == FLACDecoderResult.SUCCESS:
        pcm, r = dec.decode_stream(blob[dec.get_bytes_index():])
        decode_ok = all(x == FLACDecoderResult.SUCCESS for x in r["frame_results"])
        result["md5"] = bool(r["md5_ok"]) if r["md5_ok"] is not None else None
    # decode parity (PCM produced and checked) vs reject parity (nothing
    # decoded): different strengths, and every row says which it reached
    result["parity"] = "decode" if decode_ok and pcm else "reject"

    job = None
    if cli_out is not None:
        job = partial(drive_cli, path, cli_out, expect_fail,
                      pcm if decode_ok and not expect_fail else None)

    if expect_fail:
        ok = not decode_ok
    else:
        ok = decode_ok and result["md5"] in (None, True)
    result["status"] = "pass" if ok else "fail"
    result["seconds"] = round(time.perf_counter() - t0, 3)
    return result, job


def _cli_verdict(row) -> None:
    """A CLI drive that failed fails its file."""
    if row["cli"] is False:
        row["status"] = "fail"


def expect_fail(category: str, name: str) -> bool:
    """Whether a file must be rejected: ``faulty`` files except ``accept_*``,
    and ``reject_*`` files anywhere."""
    return (category == "faulty" and not name.startswith("accept_")) or name.startswith("reject_")


def run_suite(corpus: Path, out: Path, device="cuda", cli: bool = True, workers: int = 4):
    """Run every ``*.flac`` of the corpus's category folders; write
    ``test_report.{txt,json}`` under ``out``. Returns the report dict
    (``categories``: per category the per-file results; ``summary``)."""
    return run_conformance(
        corpus, out,
        lambda cat, f, cli_out: check_file(f, expect_fail(cat, f.name), device, cli_out),
        codec="flac", categories=CATEGORIES, report="test_report",
        checks="STREAMINFO MD5 and the flac_to_wav CLI", finalize=_cli_verdict,
        row_text=lambda r: f"md5={r['md5']}, ref={r['reference_match']}, cli={r['cli']}",
        device=device, cli=cli, workers=workers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", type=Path, default=REPO / "build" / "torch_flac_corpus")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "torch_flac_results")
    ap.add_argument("--no-cli", action="store_true",
                    help="skip driving the flac_to_wav CLI per file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.corpus.exists():
        print(f"generating corpus at {args.corpus}")
        generate_corpus(args.corpus)
    if not (args.corpus / "independent").exists():
        install_independent_corpus(args.corpus)
    report = run_suite(args.corpus, args.out, args.device, cli=not args.no_cli)
    print((args.out / "test_report.txt").read_text())
    print(f"reports: {args.out}/test_report.{{txt,json}}")
    s = report["summary"]
    return 0 if s["passed"] == s["total"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Port parity of the MP3 conformance runner (``cli/mp3_conformance``)
against examples/test_mp3_decoder.py.

- The corpus: the port's ``generate_corpus`` writes the JAX runner's names
  and bytes (its build-time decode check stubbed: it would decode every
  decode-intent file with JAX), ``intent.json`` and the sentinel.
- The signature file (tools/mp3_conformance_signatures.py writes it with
  JAX's loops) is current: its file hashes are the generated corpus's, and
  JAX's loops reproduce its ladders and payload hashes on one short file
  of each kind.
- The runner on the CPU: a seeded subset of the short categories through
  ``run_suite`` with a ``WarmCliPool`` of 2 CPU workers matches every
  signature and gets the committed JAX report's (build/test_results/
  mp3_test_report.json) ``status``, ``parity`` and ``frames``.
- The long loop: ``our_decode_run_loop`` with a small chunk on a prefix of
  a long stream gives JAX's ladder, flags and payload (the whole streams
  run on the card: the plain path takes minutes for one here).
- ``finalize_status`` on hand-made rows, and ``tools/mp3frames.py``'s
  builders byte for byte against the JAX tests' and their earlier output.
"""

import hashlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.cli import mp3_conformance as mc

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import mp3frames  # noqa: E402

REPORT = json.loads((REPO / "build" / "test_results" / "mp3_test_report.json").read_text())
SIGS = mc.load_signatures()
GENERATED = ["standard", "modes", "long", "faulty"]


def _jax_runner():
    spec = importlib.util.spec_from_file_location("jax_mp3_conformance",
                                                  REPO / "examples" / "test_mp3_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runner():
    return _jax_runner()


@pytest.fixture(scope="module")
def corpora(jax_runner, tmp_path_factory):
    """Both runners' generated corpora: {"port"|"jax": root}; the port's
    with the independent category installed."""
    port = tmp_path_factory.mktemp("corpus_port")
    mc.generate_corpus(port)
    mc.install_independent_corpus(port)
    jax = tmp_path_factory.mktemp("corpus_jax")
    mp = pytest.MonkeyPatch()
    # the build-time check decodes with JAX: stubbed, as a decode of >= 1 frame
    mp.setattr(jax_runner, "our_decode_loop", lambda blob: ([], 1, b"", []))
    try:
        jax_runner.generate_corpus(jax)
    finally:
        mp.undo()
    return {"port": port, "jax": jax}


def _files(root, cat):
    return {p.name: p.read_bytes() for p in sorted((root / cat).glob("*.mp3"))}


# ------------------------------------------------------------------ (a) corpus

@pytest.mark.parametrize("cat", GENERATED)
def test_generated_category_matches_jax(corpora, cat):
    port, jax = _files(corpora["port"], cat), _files(corpora["jax"], cat)
    assert port.keys() == jax.keys()
    assert port.keys() == {r["file"] for r in REPORT["categories"][cat]}
    for name, blob in port.items():
        assert blob == jax[name], name


def test_generated_intent_and_sentinel_match_jax(corpora):
    port, jax = corpora["port"], corpora["jax"]
    assert (port / "intent.json").read_bytes() == (jax / "intent.json").read_bytes()
    assert (port / ".complete").read_bytes() == (jax / ".complete").read_bytes() \
        == mc.CORPUS_VERSION
    assert mc.corpus_complete(port)
    assert sum(len(_files(port, c)) for c in GENERATED) == 43


# ---------------------------------------------------------- (b) the signatures

def test_signature_file_is_current(corpora):
    port = corpora["port"]
    intents = mc.read_intents(port)
    files = SIGS["files"]
    assert SIGS["corpus_version"].encode() == mc.CORPUS_VERSION
    want_frames = {r["file"]: r["frames"] for rs in REPORT["categories"].values() for r in rs}
    assert files.keys() == want_frames.keys() and len(files) == 53
    for cat in mc.CATEGORIES:
        for name, blob in _files(port, cat).items():
            sig = files[name]
            assert (sig["category"], sig["intent"]) == (cat, intents[name]), name
            assert sig["sha256"] == hashlib.sha256(blob).hexdigest(), name
            assert sig["bytes"] == len(blob)
            assert sig["n_ok"] == want_frames[name] == sum(e == 0 for e, _, _ in sig["ladder"])


# one short file of each kind: tonal joint stereo, reservoir, VBR reservoir,
# free bitrate with padding changes, mid-stream garbage, MPEG-2 windows, a
# reject and a hardened file
KINDS = ["standard/tonal_mpeg1_joint_ms_is.mp3", "standard/reservoir_1.mp3",
         "standard/vbr_reservoir.mp3", "modes/free_padding.mp3",
         "standard/midstream_garbage.mp3", "standard/windows_mpeg2_short_mixed.mp3",
         "faulty/free_no_second_sync.mp3", "faulty/hardened_truncated_header.mp3"]


@pytest.mark.parametrize("rel", KINDS)
def test_jax_loop_reproduces_signature(corpora, jax_runner, rel):
    blob = (corpora["port"] / rel).read_bytes()
    frames, n_ok, payload, _ = jax_runner.our_decode_loop(blob)
    assert mc.signature(blob, frames, n_ok, payload) == {
        k: v for k, v in SIGS["files"][Path(rel).name].items()
        if k not in ("category", "intent")}


@pytest.mark.parametrize("rel", KINDS)
def test_port_loop_reproduces_signature(corpora, rel):
    blob = (corpora["port"] / rel).read_bytes()
    frames, n_ok, payload, pcms = mc.our_decode_loop(blob, "cpu")
    assert mc.signature_matches(mc.signature(blob, frames, n_ok, payload),
                                SIGS["files"][Path(rel).name])
    assert len(pcms) == len(frames)
    assert [p is not None for p in pcms] == [e == 0 for e, _, _ in frames]


# ----------------------------------------------------------- (c) the runner

def _subset(root, dst):
    """A seeded subset of the short categories with the special files
    (VBR, free bitrate, garbage, a fuzz file that decodes a frame, hardened,
    MPEG-2.5), copied into its own corpus tree with the generated
    intent.json."""
    rng = np.random.default_rng(15)
    special = {"standard": ["vbr_tonal.mp3", "midstream_garbage.mp3", "silence.mp3",
                            "fuzz_mpeg1_mono_128k.mp3"],
               "modes": ["free_padding.mp3", "free_silent.mp3"],
               "faulty": ["free_no_second_sync.mp3", "hardened_truncated_header.mp3",
                          "mpeg25_sync_unreachable_stereo.mp3"],
               "independent": []}
    picked = []
    for cat, names in special.items():
        rest = sorted(n for n in _files(root, cat) if n not in names)
        n = {"standard": 3, "modes": 0, "faulty": 1, "independent": 2}[cat]
        picked += [(cat, x) for x in names + [rest[i] for i in
                                              sorted(rng.choice(len(rest), n, replace=False))]]
    for cat, name in picked:
        (dst / cat).mkdir(parents=True, exist_ok=True)
        shutil.copyfile(root / cat / name, dst / cat / name)
    shutil.copyfile(root / "intent.json", dst / "intent.json")
    return picked


def test_runner_subset_matches_jax_report(corpora, tmp_path):
    picked = _subset(corpora["port"], tmp_path / "corpus")
    assert len(picked) >= 15
    seen = []
    report = mc.run_suite(tmp_path / "corpus", tmp_path / "out", device="cpu", cli=True,
                          workers=2, on_file=lambda cat, r: seen.append((cat, r["file"])))
    assert seen == [(c, n) for c in mc.CATEGORIES for c2, n in sorted(picked) if c2 == c]
    assert json.loads((tmp_path / "out" / "mp3_test_report.json").read_text()) == report
    want = {(cat, r["file"]): r for cat, rs in REPORT["categories"].items() for r in rs}
    got = {(cat, r["file"]): r for cat, rs in report["categories"].items() for r in rs}
    assert got.keys() == set(picked)
    for key, r in got.items():
        assert list(r) == [*want[key], "signature_match"]
        for field in ("status", "parity", "frames", "intent"):
            assert r[field] == want[key][field], (key, field)
        assert r["reference_match"] is None
        assert r["signature_match"] is True, key
        assert r["cli"] is True, key
    s = report["summary"]
    assert s["passed"] == s["total"] == len(picked) and s["cli_mode"] == "warm-pool"
    assert {r["parity"] for r in got.values()} == {"decode", "reject"}
    text = (tmp_path / "out" / "mp3_test_report.txt").read_text()
    assert f"{len(picked)}/{len(picked)} passed" in text


def test_runner_flags_a_wrong_signature(corpora, tmp_path):
    """A signature that disagrees fails its file; a file without one runs
    on its other checks."""
    (tmp_path / "corpus" / "modes").mkdir(parents=True)
    for name in ("free_tonal.mp3", "free_silent.mp3"):
        shutil.copyfile(corpora["port"] / "modes" / name, tmp_path / "corpus" / "modes" / name)
    shutil.copyfile(corpora["port"] / "intent.json", tmp_path / "corpus" / "intent.json")
    sigs = json.loads(json.dumps(SIGS))
    sigs["files"]["free_tonal.mp3"]["payload_sha256"] = "0" * 64
    del sigs["files"]["free_silent.mp3"]
    (tmp_path / "sigs.json").write_text(json.dumps(sigs))
    report = mc.run_suite(tmp_path / "corpus", tmp_path / "out", device="cpu", cli=False,
                          signatures=tmp_path / "sigs.json")
    rows = {r["file"]: r for r in report["categories"]["modes"]}
    assert rows["free_tonal.mp3"]["signature_match"] is False
    assert rows["free_tonal.mp3"]["status"] == "fail"
    # no signature and no CLI: no oracle ran, so the file fails
    assert rows["free_silent.mp3"]["signature_match"] is None
    assert rows["free_silent.mp3"]["status"] == "fail"
    assert report["summary"]["failed"] == 2


def test_wav_data_payload_skips_other_chunks(tmp_path):
    """The payload both runners compare: the data chunk after chunks of odd
    size (padded to even), and nothing from a file without one."""
    body = b"fmt " + (3).to_bytes(4, "little") + b"abc\0" + b"data" + (4).to_bytes(4, "little")
    (tmp_path / "a.wav").write_bytes(b"RIFF" + bytes(4) + b"WAVE" + body + b"\1\2\3\4")
    assert mc.wav_data_payload(tmp_path / "a.wav") == b"\1\2\3\4"
    (tmp_path / "b.wav").write_bytes(b"RIFF" + bytes(4) + b"WAVE")
    assert mc.wav_data_payload(tmp_path / "b.wav") == b""


def test_main_on_the_cpu(corpora, tmp_path):
    shutil.copytree(corpora["port"], tmp_path / "corpus")
    assert mc.main(["--corpus", str(tmp_path / "corpus"), "--out", str(tmp_path / "out"),
                    "--device", "cpu", "--no-cli", "--categories", "modes", "faulty"]) == 0
    report = json.loads((tmp_path / "out" / "mp3_test_report.json").read_text())
    assert list(report["categories"]) == ["modes", "faulty"]
    assert report["summary"]["total"] == report["summary"]["passed"] == 13


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mc.main(["--corpus", str(tmp_path / "corpus"), "--out", str(tmp_path / "out")])
    assert not (tmp_path / "corpus").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mc.run_suite(tmp_path, tmp_path / "out", cli=False)


# -------------------------------------------------------- (d) the long loop

@pytest.mark.parametrize("name,n_frames,cut", [
    ("long_vbr_reservoir_mpeg1.mp3", 12, 0),       # 2 runs of 6
    ("long_tonal_mpeg2_stereo.mp3", 12, 0),
    ("long_reservoir_mpeg1_stereo.mp3", 6, 200),   # the next frame cut: error frames end it
])
def test_long_loop_prefix_matches_jax(corpora, jax_runner, name, n_frames, cut):
    blob = (corpora["port"] / "long" / name).read_bytes()
    ladder = SIGS["files"][name]["ladder"]
    data = blob[:sum(c for _, c, _ in ladder[:n_frames]) + cut]
    want = jax_runner.our_decode_run_loop(data, chunk=6)
    got = mc.our_decode_run_loop(data, "cpu", chunk=6)
    assert got[0] == want[0]
    assert got[1] == want[1] == n_frames
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert [list(f) for f in got[0][:n_frames]] == ladder[:n_frames]
    assert (len(got[0]) > n_frames) == (cut > 0)
    assert all(e != 0 for e, _, _ in got[0][n_frames:])


# ------------------------------------------------------- (e) finalize_status

def _row(n_ok, intent="decode", sig=True, cli=None, expect_fail=False):
    return {"file": "f.mp3", "frames": n_ok, "reference_match": None, "cli": cli,
            "status": "fail", "intent": intent, "parity": None, "seconds": 0.0,
            "signature_match": sig, "_expect_fail": expect_fail, "_n_ok": n_ok}


@pytest.mark.parametrize("row,status,parity", [
    (_row(4), "pass", "decode"),
    (_row(0), "fail", "reject"),                           # decode intent, no frame
    (_row(0, "parity"), "pass", "reject"),                 # fuzz: reject parity allowed
    (_row(0, "reject", cli=True, expect_fail=True), "pass", "reject"),
    (_row(1, "reject"), "fail", "decode"),                 # a reject file that decoded
    (_row(1, "parity", expect_fail=True), "fail", "decode"),  # faulty/ must give no frame
    (_row(1152, "decode_long"), "pass", "decode"),
    (_row(1099, "decode_long"), "fail", "decode"),
    (_row(4, sig=False, cli=True), "fail", "decode"),
    (_row(4, cli=False), "fail", "decode"),
    (_row(4, sig=None), "fail", "decode"),                 # no oracle ran
    (_row(4, sig=None, cli=True), "pass", "decode"),
])
def test_finalize_status(row, status, parity):
    row = dict(row)
    mc.finalize_status(row)
    assert (row["status"], row["parity"]) == (status, parity)
    assert "_n_ok" not in row and "_expect_fail" not in row


# --------------------------------------------------------- (f) mp3frames

# SHA256 of the stream helpers' output before craft_reservoir_stream and
# make_free_frame were added
PINNED = {
    "tonal_stream": ((lambda: mp3frames.tonal_stream(mp3frames.BATCH_CFGS[1], 3, 6)),
                     "6e3e12d3c31998400ff8e4695d27b24fa09860ec256a1010d63c6a8bcbbca0d0"),
    "mixed_stream": ((lambda: mp3frames.mixed_stream(mp3frames.BATCH_CFGS[3], 5, 9)),
                     "601e871769aa0036560c3034eb339fe429fb355f38f088fe728e2c5af1d08bbc"),
    "mixed_stream_no_fuzz": ((lambda: mp3frames.mixed_stream(mp3frames.BATCH_CFGS[2], 6, 7,
                                                             fuzz=False)),
                             "98aad6d44c7187acf4aa0654ed7424ace5753c06141df02c1fc0b1ef61f1d217"),
    "fuzz_stream": ((lambda: mp3frames.fuzz_stream(mp3frames.BATCH_CFGS[0], 4, 5)),
                    "0be57f2282c4b21042f7fd4bf5db7834de66308dfeace197f027259e1d81acb1"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_mp3frames_streams_unchanged(name):
    make, digest = PINNED[name]
    assert hashlib.sha256(make()).hexdigest() == digest


@pytest.mark.parametrize("cfg", [dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=1, mode_ext=3),
                                 dict(ver_bits=2, bitrate_idx=7, sr_idx=1, mode=3)])
def test_mp3frames_builders_match_jax_tests(cfg):
    from tests.test_mp3_coverage import (craft_reservoir_stream, craft_tonal_frame,
                                         crafted_frame, fuzz_frame)
    from tests.test_mp3_modes import make_free_frame

    def both(port, jax, *args, **kw):
        assert port(*args, np.random.default_rng(8), **kw) == \
            jax(*args, np.random.default_rng(8), **kw)

    both(mp3frames.craft_tonal_frame, craft_tonal_frame, cfg, gains=(150, 230))
    both(mp3frames.fuzz_frame, fuzz_frame, cfg)
    both(mp3frames.crafted_frame, crafted_frame, cfg, 2, 1)
    vbr = [dict(cfg, bitrate_idx=b) for b in (9, 12, 6, 11, 13) * 3]
    both(mp3frames.craft_reservoir_stream, craft_reservoir_stream, vbr)
    both(mp3frames.craft_reservoir_stream, craft_reservoir_stream, [cfg] * 9, gains=(201, 235))
    for padding in (0, 1):
        assert mp3frames.make_free_frame(90, padding=padding, mode=cfg["mode"]) == \
            make_free_frame(90, padding=padding, mode=cfg["mode"])
    assert mp3frames.make_free_frame(120, mode=0, tonal_rng=np.random.default_rng(3)) == \
        make_free_frame(120, mode=0, tonal_rng=np.random.default_rng(3))

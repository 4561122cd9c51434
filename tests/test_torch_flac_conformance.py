"""Port parity of the FLAC conformance runner (``cli/flac_conformance``)
against examples/test_flac_decoder.py.

- The corpus: the port's jax-free copies of ``generate_corpus`` and
  ``install_independent_corpus`` write the same file names and bytes as the
  JAX runner's. ``tools/flacgen.make_flac`` is deterministic, so both run
  through one memo of its results keyed by the call's arguments (a call
  the other runner did not make misses the memo and shows as different
  bytes). Two calls take minutes in Python (the 32-bit LPC fits of seeds 59
  and 11): for them the memo returns a stand-in derived from the arguments,
  so the comparison still covers their arguments and what the runners do
  with the result, and the decode checks below leave those two files out
  (chip_smoke.py phase 18 runs the whole real corpus on the card).
- The runner: a seeded subset of the corpus, every category and the reject,
  accept and hardened classes, run through ``run_suite`` on the CPU with a
  ``WarmCliPool`` of 2 workers, gets the committed JAX report's
  (build/test_results/test_report.json) ``status``, ``parity`` and ``md5``
  for every file; each decoded file's PCM equals JAX's ``FLACDecoder``.
"""

import hashlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from esp_audio_libs_tpu.models.flac import FLACDecoder as JaxFLAC
from esp_audio_libs_tpu.utils.errors import FLACDecoderResult as JaxResult
from esp_audio_libs_tpu_torch.cli import flac_conformance as fc

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import flacgen  # noqa: E402

SLOW_SEEDS = {59, 11}   # depth-32 LPC fits: minutes each in Python
STAND_IN = b"stand-in:"
REPORT = json.loads((REPO / "build" / "test_results" / "test_report.json").read_text())


def _jax_runner():
    spec = importlib.util.spec_from_file_location("jax_flac_conformance",
                                                  REPO / "examples" / "test_flac_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _canonical(v):
    if isinstance(v, flacgen.SubframePlan):
        return ("SubframePlan", sorted(vars(v).items()))
    if isinstance(v, (list, tuple)):
        return [_canonical(x) for x in v]
    if isinstance(v, dict):
        return sorted((k, _canonical(x)) for k, x in v.items())
    return v


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both runners' corpora: {"port"|"jax": (root, [calls])}."""
    real = flacgen.make_flac
    memo = {}
    calls = []

    def make_flac(**kw):
        key = repr(_canonical(kw))
        calls.append(key)
        if key not in memo:
            if kw.get("rng_seed") in SLOW_SEEDS and kw.get("depth") == 32:
                memo[key] = (STAND_IN + hashlib.sha256(key.encode()).digest(), None)
            else:
                memo[key] = real(**kw)
        return memo[key]

    out = {}
    runners = {"port": fc, "jax": _jax_runner()}
    mp = pytest.MonkeyPatch()
    mp.setattr(flacgen, "make_flac", make_flac)
    try:
        for name, runner in runners.items():
            root = tmp_path_factory.mktemp(f"corpus_{name}")
            start = len(calls)
            runner.generate_corpus(root)
            runner.install_independent_corpus(root)
            out[name] = (root, calls[start:])
    finally:
        mp.undo()
    return out


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.flac"))}


def test_generated_corpus_matches_jax(corpora):
    (port_root, port_calls), (jax_root, jax_calls) = corpora["port"], corpora["jax"]
    assert port_calls == jax_calls
    port, jax = _files(port_root), _files(jax_root)
    assert port.keys() == jax.keys()
    assert len(port) == REPORT["summary"]["total"]
    for name, blob in port.items():
        assert blob == jax[name], name
    assert sum(blob.startswith(STAND_IN) for blob in port.values()) == len(SLOW_SEEDS)


def _subset(root, tmp):
    """A seeded subset of the corpus with every category and class, copied
    into its own corpus tree; the stand-ins are left out."""
    rng = np.random.default_rng(12)
    picked = []
    for cat in fc.CATEGORIES:
        files = [p for p in sorted((root / cat).glob("*.flac"))
                 if not p.read_bytes().startswith(STAND_IN)]
        special = [p for p in files if p.name.startswith(("reject_", "accept_", "hardened_"))]
        rest = [p for p in files if p not in special]
        n = {"subset": 4, "uncommon": 2, "faulty": 3, "independent": 3}[cat]
        picked += special + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
    for p in picked:
        dst = tmp / p.parent.name / p.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(p, dst)
    return picked


def test_runner_subset_matches_jax_report(corpora, tmp_path):
    root = corpora["port"][0]
    picked = _subset(root, tmp_path / "corpus")
    assert len(picked) >= 15
    report = fc.run_suite(tmp_path / "corpus", tmp_path / "out", device="cpu", cli=True,
                          workers=2)
    assert json.loads((tmp_path / "out" / "test_report.json").read_text()) == report
    want = {(cat, r["file"]): r for cat, rs in REPORT["categories"].items() for r in rs}
    got = {(cat, r["file"]): r for cat, rs in report["categories"].items() for r in rs}
    assert got.keys() == {(p.parent.name, p.name) for p in picked}
    for key, r in got.items():
        assert r.keys() == want[key].keys()
        for field in ("status", "parity", "md5"):
            assert r[field] == want[key][field], (key, field)
        assert r["reference_match"] is None
        assert r["cli"] is True, key
    s = report["summary"]
    assert s["passed"] == s["total"] == len(picked) and s["cli_mode"] == "warm-pool"
    assert {r["parity"] for r in got.values()} == {"decode", "reject"}

    # each decoded file's PCM (the CLI's WAV payload) equals JAX's decode
    for (cat, name), r in got.items():
        if r["parity"] != "decode":
            continue
        blob = (root / cat / name).read_bytes()
        jdec = JaxFLAC()
        assert jdec.read_header(blob) == JaxResult.SUCCESS
        jpcm, _ = jdec.decode_stream(blob[jdec.get_bytes_index():])
        wav = tmp_path / "out" / "wav" / cat / (Path(name).stem + ".wav")
        assert fc.wav_data_payload(wav) == jpcm, name

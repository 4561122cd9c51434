"""Port parity of the serving surface: ``cli/serve_fleet`` against
examples/serve_fleet.py, and ``cli/cli_worker``'s ``WarmCliPool``.

- serve_fleet: the port (``--device cpu``) and the JAX original
  (``JAX_PLATFORMS=cpu``) run as subprocesses, all at once, in the modes of
  tests/test_serve_fleet_cli.py that run on one device (ragged MP3 with
  ``--verify``, continuous batching 4 -> 9 slots, the FLAC fleet) and the
  composed ``--rate 16000`` mode without a mesh. Every JSON line must be
  equal except the timing keys, and ``verified`` must be true. The composed
  mode over a mesh: JAX's ``--mesh 8`` on its 8 virtual CPU devices against
  the port's ``serve_mp3`` in-process over ``stream_mesh(["cpu"] * 8)``
  (``--mesh N`` on the command line names N distinct devices, and the CPU is
  one). The MP3
  corpora of the two (tools/mp3frames.py in the port, the JAX tests'
  frame maker in the original) are byte-identical. ``--device cuda`` without a
  card exits non-zero naming CUDA.
- cli_worker: a ``WarmCliPool`` drives the port's ``flac_to_wav`` and
  ``mp3_to_wav`` on a corpus/independent file and on tonal frames; the
  output files equal those of direct ``convert`` calls byte for byte. A job
  that raises answers rc 99, and the pool goes on serving.
- profile_serve_flac: the FLAC fleet's stage profile at a small size.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.cli import (flac_to_wav, mp3_to_wav, profile_serve_flac,
                                          serve_fleet)
from esp_audio_libs_tpu_torch.cli.cli_worker import WarmCliPool

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import mp3frames as mf  # noqa: E402

TIMING = {"ms", "msps", "realtime_streams"}
MODES = {
    "ragged": ["--codec", "mp3", "--streams", "5", "--min-frames", "3", "--max-frames", "6",
               "--run-frames", "3", "--verify", "--seed", "11"],
    "recycling": ["--codec", "mp3", "--streams", "4", "--total-streams", "9",
                  "--min-frames", "3", "--max-frames", "6", "--run-frames", "3", "--verify",
                  "--seed", "11"],
    "flac": ["--codec", "flac", "--streams", "3", "--min-frames", "2", "--max-frames", "3",
             "--seed", "4"],
    "composed": ["--codec", "mp3", "--streams", "4", "--min-frames", "4", "--max-frames", "4",
                 "--run-frames", "2", "--rate", "16000", "--verify", "--seed", "9"],
}
MESH_COMPOSED = ["--codec", "mp3", "--streams", "8", "--min-frames", "4", "--max-frames", "4",
                 "--run-frames", "2", "--rate", "16000", "--verify", "--seed", "9"]
CORPUS_ARGS = [(6, 2, 5, 3, False), (4, 4, 4, 9, True)]   # (n, min, max, seed, uniform)
JAX_CORPUS = """
import hashlib, json, sys
sys.path.insert(0, "examples")
import serve_fleet
out = [[hashlib.sha256(s.tobytes()).hexdigest() for s in serve_fleet._mp3_corpus(*a)[0]]
       for a in json.loads(sys.argv[1])]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                JAX_COMPILATION_CACHE_DIR=str(REPO / "build" / "jax_cache"))


@pytest.fixture(scope="module")
def runs():
    """Every mode through both programs, all processes started together;
    also JAX's corpus digests. {(mode, "jax"|"port"): (rc, stdout, stderr)}."""
    cmds = {}
    for mode, args in MODES.items():
        cmds[mode, "jax"] = [sys.executable, str(REPO / "examples" / "serve_fleet.py"), *args]
        cmds[mode, "port"] = [sys.executable, "-m", "esp_audio_libs_tpu_torch.cli.serve_fleet",
                              *args, "--device", "cpu"]
    cmds["corpus", "jax"] = [sys.executable, "-c", JAX_CORPUS, json.dumps(CORPUS_ARGS)]
    cmds["composed_mesh", "jax"] = [sys.executable, str(REPO / "examples" / "serve_fleet.py"),
                                    *MESH_COMPOSED, "--mesh", "8"]
    env8 = _env()
    env8["XLA_FLAGS"] = (env8.get("XLA_FLAGS", "")
                         + " --xla_force_host_platform_device_count=8").strip()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env8 if k[0] == "composed_mesh" else _env(), cwd=REPO)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _lines(res):
    rc, stdout, stderr = res
    assert rc == 0, stdout + stderr
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_fleet_matches_jax(runs, mode):
    want, got = _lines(runs[mode, "jax"]), _lines(runs[mode, "port"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k not in TIMING} == \
               {k: v for k, v in w.items() if k not in TIMING}
    agg = got[-1]
    assert agg["verified"] is True and agg["samples"] > 0
    if mode == "recycling":
        assert sum(r["recycled"] for r in got[:-1]) == 9 - 4
    if mode == "composed":
        assert agg["samples"] == 4 * 4 * 2 * 576 * 2   # B x frames x granules x 576 x ch


def test_serve_fleet_mesh_matches_jax(runs):
    """Port of tests/test_serve_fleet_cli.py::
    test_serve_fleet_mp3_composed_mesh_verified: the composed mode over an
    8-device mesh, the PCM split over it between the stages, every JSON line
    equal to JAX's ``--mesh 8`` except the timing keys, verified."""
    from esp_audio_libs_tpu_torch.parallel.mesh import stream_mesh

    args = serve_fleet.parser().parse_args([*MESH_COMPOSED, "--device", "cpu"])
    streams, metas = serve_fleet.mp3_corpus(8, 4, 4, 9, True)
    split = []
    _pcm, lines, agg = serve_fleet.serve_mp3(
        args, streams, metas, mesh=stream_mesh(["cpu"] * 8),
        on_run=lambda r, slots, bufs, res, out: split.append((res[0].axis, out[0].axis)))
    want = _lines(runs["composed_mesh", "jax"])
    got = [*lines, agg]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k not in TIMING} == \
               {k: v for k, v in w.items() if k not in TIMING}
    assert agg["verified"] is True
    assert agg["samples"] == 8 * 4 * 2 * 576 * 2      # B x frames x granules x 576 x ch
    assert split == [(0, 1)] * len(lines)              # PCM [B, n], output [chunks, B, bytes]
    # on the command line --mesh N needs N visible devices: the CPU is one
    assert serve_fleet.main([*MESH_COMPOSED, "--device", "cpu", "--mesh", "8"]) == 1


def test_mp3_corpus_matches_jax(runs):
    rc, stdout, stderr = runs["corpus", "jax"]
    assert rc == 0, stderr
    want = json.loads(stdout.strip().splitlines()[-1])
    for args, digests in zip(CORPUS_ARGS, want):
        streams, metas = serve_fleet.mp3_corpus(*args)
        assert [hashlib.sha256(s.tobytes()).hexdigest() for s in streams] == digests
        assert len({m[0]["mode"] for m in metas}) == (1 if args[4] else 2)


def test_serve_fleet_in_process_returns_pcm():
    """With ``--verify``, ``serve_mp3`` hands back each stream's PCM, which
    adds up to the aggregate's samples; every run goes through ``on_run``,
    whose slot map gathers the same PCM. Without ``--verify`` it keeps no
    PCM."""
    argv = ["--streams", "3", "--total-streams", "4", "--min-frames", "2", "--max-frames", "3",
            "--run-frames", "2", "--seed", "5", "--device", "cpu"]
    streams, metas = serve_fleet.mp3_corpus(4, 2, 3, 5, False)
    seen, gathered = [], [[] for _ in streams]

    def on_run(r, slots, bufs, res, out):
        seen.append((r, sum(b is not None for b in bufs), out))
        assert [s is None for s in slots] == [b is None for b in bufs]
        for i, sid in enumerate(slots):
            if sid is not None:
                gathered[sid] += [p for _e, p, _c in res[i] if p is not None]

    pcm, runs_, agg = serve_fleet.serve_mp3(
        serve_fleet.parser().parse_args([*argv, "--verify"]), streams, metas, on_run=on_run)
    assert agg["verified"] is True
    assert [r for r, _, _ in seen] == [line["run"] for line in runs_]
    assert [a for _, a, _ in seen] == [line["active"] for line in runs_]
    assert all(out is None for _, _, out in seen)
    assert sum(p.size for per in pcm for p in per) == agg["samples"] > 0
    assert agg["streams"] == 4 and agg["slots"] == 3
    for per, got, (cfg, n) in zip(pcm, gathered, metas):
        assert sum(p.size for p in per) == n * 1152 * (1 if cfg["mode"] == 3 else 2)
        assert len(got) == len(per) and all(map(np.array_equal, got, per))
    one = serve_fleet.parser().parse_args(["--streams", "1", "--run-frames", "1", "--device", "cpu"])
    pcm, _runs, agg = serve_fleet.serve_mp3(one, streams[:1], metas[:1])
    assert pcm is None and agg["verified"] is None and agg["samples"] > 0


def test_serve_fleet_cuda_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    res = subprocess.run([sys.executable, "-m", "esp_audio_libs_tpu_torch.cli.serve_fleet",
                          "--streams", "2", "--min-frames", "2", "--max-frames", "2"],
                         capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert res.returncode != 0
    assert "CUDA" in res.stdout + res.stderr
    assert not [line for line in res.stdout.splitlines() if line.startswith("{")]


def test_profile_serve_flac_stages(capsys, monkeypatch):
    """The FLAC stage profile runs at a small size on the CPU and prints
    every stage; it raises for ``cuda`` without a card."""
    assert profile_serve_flac.main(["--streams", "2", "--min-frames", "2", "--max-frames", "2",
                                    "--reps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["streams"] == 2
    assert set(out["stage_ms"]) == {"construct", "headers", "decode", "parse", "md5"}
    assert all(v >= 0 for v in out["stage_ms"].values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_serve_flac.main(["--streams", "1", "--device", "cuda"])


# ---------------------------------------------------------------- cli_worker


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("worker")
    mp3 = d / "tonal.mp3"
    mp3.write_bytes(mf.tonal_stream(dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0), 3, 3))
    flac = sorted((REPO / "corpus" / "independent").glob("*.flac"))[0]
    return d, {"flac": flac, "mp3": mp3}


@pytest.mark.parametrize("codec", ["flac", "mp3"])
def test_warm_pool_output_equals_direct_convert(inputs, codec):
    d, src = inputs
    convert = {"flac": flac_to_wav.convert, "mp3": mp3_to_wav.convert}[codec]
    direct = d / f"{codec}_direct.wav"
    assert convert(str(src[codec]), str(direct), device="cpu") == 0
    pool = WarmCliPool(codec, n_workers=2, device="cpu")
    try:
        outs = [d / f"{codec}_pool{k}.wav" for k in range(3)]
        results = [pool.drive(src[codec], out) for out in outs]
        assert all(rc == 0 and "wrote" in stdout for rc, stdout in results)
        for out in outs:
            assert out.read_bytes() == direct.read_bytes()
        # a job whose convert raises answers 99; the worker keeps serving
        rc, stdout = pool.drive(src[codec], d / "bad.wav", no_such_option=1)
        assert rc == 99 and "worker exception" in stdout
        again = d / f"{codec}_again.wav"
        assert pool.drive(src[codec], again)[0] == 0
        assert again.read_bytes() == direct.read_bytes()
        # a convert error is its exit code, not a worker failure
        assert pool.drive(d / "missing.bin", d / "x.wav")[0] == 1
    finally:
        pool.close()


def test_warm_pool_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WarmCliPool("flac", n_workers=1)

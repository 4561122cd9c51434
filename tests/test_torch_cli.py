"""Port parity of the file CLIs: each ``python -m
esp_audio_libs_tpu_torch.cli.<name> --device cpu`` against its JAX original
in examples/ (``JAX_PLATFORMS=cpu``), as subprocesses on the same small
generated inputs, run side by side. The output files must be byte-identical
(header and payload) and the exit codes equal.

- mix_wav: three inputs of unequal length with gains and a shift, the
  shift-0 int16 wraparound, the resampled leg (the exact ``Resampler``), and
  a positive gain rejected;
- resample_wav: exact mode with and without subsample interpolation, and
  ``--fast`` (with interpolation JAX's lerp is contracted on the CPU: see
  the test);
- mp3_to_wav: tonal frames and one bad frame (zero-filled);
- flac_to_wav: a corpus/independent file (12-bit: WAVE_FORMAT_EXTENSIBLE).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from esp_audio_libs_tpu_torch.cli.wav_io import write_wav_header

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import mp3frames as mf  # noqa: E402

HEADER = 44      # the PCM header write_wav_header writes for 16-bit mono or stereo


def _make_wav(path: Path, rate: int, ch: int, frames: int, seed: int, amp: float = 18000.0):
    rng = np.random.default_rng(seed)
    t = np.arange(frames * ch)
    pcm = (np.sin(t * (0.011 + 0.003 * seed)) * amp
           + rng.integers(-64, 64, frames * ch)).astype(np.int16)
    with open(path, "wb") as f:
        write_wav_header(f, rate, ch, 16, frames, 2)
        f.write(pcm.tobytes())
    return path


def run_both(tmp_path: Path, name: str, make_args):
    """Run examples/<name>.py and the port's CLI at once, each writing its
    own output (``make_args(out_path)`` gives the arguments); returns the
    two (exit code, output bytes or None) pairs after checking the exit
    codes are equal."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {k: tmp_path / f"{name}_{k}.out" for k in ("jax", "port")}
    cmds = {"jax": [sys.executable, str(REPO / "examples" / f"{name}.py"),
                    *make_args(outs["jax"])],
            "port": [sys.executable, "-m", f"esp_audio_libs_tpu_torch.cli.{name}",
                     *make_args(outs["port"]), "--device", "cpu"]}
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=REPO) for k, c in cmds.items()}
    res = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=600)
        res[k] = (p.returncode, outs[k].read_bytes() if outs[k].exists() else None, out + err)
    assert res["port"][0] == res["jax"][0], res
    return res["jax"][:2], res["port"][:2]


def _assert_same_file(jax_res, port_res):
    assert jax_res[0] == 0, "the JAX CLI failed"
    assert port_res[1] is not None and port_res[1] == jax_res[1]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    return {
        "a": _make_wav(d / "a.wav", 16000, 2, 3000, 1),
        "b": _make_wav(d / "b.wav", 16000, 2, 2200, 2, amp=30000.0),
        "c": _make_wav(d / "c.wav", 16000, 2, 2600, 3, amp=32000.0),
        "slow": _make_wav(d / "slow.wav", 22050, 2, 2500, 4),
        "cd": _make_wav(d / "cd.wav", 44100, 2, 3000, 5),
    }


@pytest.mark.parametrize("case", ["gains_shift", "wraparound", "resampled", "positive_gain"])
def test_mix_wav(tmp_path, wavs, case):
    ins = [str(wavs[k]) for k in ("a", "b", "c")]
    extra = {
        "gains_shift": ["--gain-db", "-3", "--gain-db", "-6", "--gain-db", "-1.5",
                        "--shift", "1"],
        "wraparound": ["--shift", "0"],
        "resampled": ["--rate", "16000"],
        "positive_gain": ["--gain-db", "0", "--gain-db", "2", "--gain-db", "0"],
    }[case]
    if case == "resampled":
        ins = [str(wavs["slow"]), str(wavs["a"])]
    jax_res, port_res = run_both(tmp_path, "mix_wav", lambda out: [str(out), *ins, *extra])
    if case == "positive_gain":
        assert jax_res == port_res == (1, None)
        return
    _assert_same_file(jax_res, port_res)
    if case == "wraparound":
        x = [np.frombuffer(Path(p).read_bytes()[HEADER:], np.int16).astype(np.int32)
             for p in ins]
        assert max(len(v) for v in x) * 2 + HEADER == len(port_res[1])
        n = min(len(v) for v in x)
        assert np.any(np.abs(sum(((v[:n] * 32767) >> 15) for v in x)) > 32767)


@pytest.mark.parametrize("mode", ["exact", "exact_no_interpolate", "fast"])
def test_resample_wav(tmp_path, wavs, mode):
    """Exact mode without subsample interpolation and the fast leg write
    byte-identical files. With interpolation (the default) XLA on the CPU
    contracts JAX's mode-2 lerp into an FMA while the port keeps the C
    order, so there the payload is held to the rule of
    tests/test_torch_exact_resampler.py: within 1 LSB in under 2 % of the
    samples, the header byte for byte."""
    args = ["--rate", "16000"] + {"exact": [], "exact_no_interpolate": ["--no-interpolate"],
                                  "fast": ["--fast"]}[mode]
    jax_res, port_res = run_both(tmp_path, "resample_wav",
                                 lambda out: [str(wavs["cd"]), str(out), *args])
    if mode != "exact":
        _assert_same_file(jax_res, port_res)
        return
    assert jax_res[0] == 0 and len(port_res[1]) == len(jax_res[1])
    assert port_res[1][:HEADER] == jax_res[1][:HEADER]
    d = np.abs(np.frombuffer(port_res[1][HEADER:], np.int16).astype(np.int32)
               - np.frombuffer(jax_res[1][HEADER:], np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_mp3_to_wav(tmp_path):
    """Seven tonal frames with a bad frame between them (a valid header over
    broken side info): the bad frame is zero-filled by both, the rest
    decoded."""
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
    rng = np.random.default_rng(11)
    frames = [mf.craft_tonal_frame(cfg, rng) for _ in range(7)]
    bad = bytearray(frames[3])
    bad[4:] = bytes(len(bad) - 4)
    bad[6:12] = b"\xff" * 6
    src = tmp_path / "in.mp3"
    src.write_bytes(b"".join(frames[:3]) + bytes(bad) + b"".join(frames[3:]))
    jax_res, port_res = run_both(tmp_path, "mp3_to_wav", lambda out: [str(src), str(out)])
    _assert_same_file(jax_res, port_res)
    assert np.any(np.frombuffer(port_res[1][HEADER:], np.int16))


def test_flac_to_wav(tmp_path):
    src = REPO / "corpus" / "independent" / "enc2_depth12.flac"
    jax_res, port_res = run_both(tmp_path, "flac_to_wav", lambda out: [str(src), str(out)])
    _assert_same_file(jax_res, port_res)

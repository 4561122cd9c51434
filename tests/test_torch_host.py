"""Port parity, host control plane: the PyTorch package's jax-free copies of
the host modules must give bit-identical filterbanks, folded banks, phase
grids and dry-run counts to the JAX package (both load the same native
library)."""

import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.ops import biquad as jbq
from esp_audio_libs_tpu.ops import quantization as jq
from esp_audio_libs_tpu.ops import sinc as jsinc
from esp_audio_libs_tpu.runtime import native as jnative
from esp_audio_libs_tpu_torch.ops import biquad as tbq
from esp_audio_libs_tpu_torch.ops import quantization as tq
from esp_audio_libs_tpu_torch.ops import sinc as tsinc
from esp_audio_libs_tpu_torch.runtime import native as tnative
from esp_audio_libs_tpu_torch.runtime import phase_grid as tpg

torch.set_num_threads(2)

# the runtime package re-exports the function under the module's name
jpg = importlib.import_module("esp_audio_libs_tpu.runtime.phase_grid")

FLAGS = tsinc.SUBSAMPLE_INTERPOLATE | tsinc.INCLUDE_LOWPASS


def test_flag_constants_match():
    assert (tsinc.SUBSAMPLE_INTERPOLATE, tsinc.BLACKMAN_HARRIS, tsinc.INCLUDE_LOWPASS) == \
        (jsinc.SUBSAMPLE_INTERPOLATE, jsinc.BLACKMAN_HARRIS, jsinc.INCLUDE_LOWPASS)
    assert tpg.HISTORY_MARGIN == jpg.HISTORY_MARGIN


@pytest.mark.parametrize("taps,nf,lp,flags", [
    (16, 32, 0.3, FLAGS), (64, 32, 0.33, FLAGS), (64, 32, 1.0, tsinc.SUBSAMPLE_INTERPOLATE),
    (256, 256, 0.9, FLAGS | tsinc.BLACKMAN_HARRIS)])
def test_filterbank_bitidentical(taps, nf, lp, flags):
    a = tnative.design_filterbank_native(taps, nf, lp, flags)
    b = jnative.design_filterbank_native(taps, nf, lp, flags)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("taps,nf", [(6, 32), (64, 1), (2048, 32)])
def test_validate_params_rejects_like_jax(taps, nf):
    with pytest.raises(ValueError) as e_t:
        tsinc.validate_params(taps, nf)
    with pytest.raises(ValueError) as e_j:
        jsinc.validate_params(taps, nf)
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("cutoff", [0.1, 0.181, 0.33])
def test_biquad_design_and_fold_bitidentical(cutoff):
    ct = tbq.biquad_init(tbq.biquad_lowpass(cutoff), 1.0)
    cj = jbq.biquad_init(jbq.biquad_lowpass(cutoff), 1.0)
    np.testing.assert_array_equal(ct.view(np.uint32), cj.view(np.uint32))
    assert tbq.fir_len_for(ct) == jbq.fir_len_for(cj)
    assert tbq.fir_len_for(ct, cap=8192) == jbq.fir_len_for(cj, cap=8192)
    np.testing.assert_array_equal(tbq.biquad_impulse(ct, 300), jbq.biquad_impulse(cj, 300))

    taps = 64
    bank = jnative.design_filterbank_native(taps, 32, 0.33, FLAGS)
    fl = tbq.fir_len_for(ct)
    ft, dt, ot = tbq.fold_biquad_into_filterbank(bank, ct, fl, half=taps // 2)
    fj, dj, oj = jbq.fold_biquad_into_filterbank(bank, cj, fl, half=taps // 2)
    assert ot == oj
    np.testing.assert_array_equal(ft.view(np.uint32), fj.view(np.uint32))
    np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))


@pytest.mark.parametrize("taps,nf,ratio,frames", [
    (16, 32, 16000 / 44100, 1024), (64, 32, 16000 / 44100, 1024),
    (64, 32, 44100 / 16000, 1024), (64, 32, 48000 / 44100, 700)])
def test_phase_grid_and_dry_runs_bitidentical(taps, nf, ratio, frames):
    ratio = np.float32(ratio)
    st_t, st_j = tpg.PhaseState.initial(taps), jpg.PhaseState.initial(taps)
    st_t.advance(taps / 2.0)
    st_j.advance(taps / 2.0)
    out_free = int(np.ceil(frames * float(ratio))) + 8
    for _ in range(4):
        assert tpg.required_samples(st_t, out_free, ratio) == \
            jpg.required_samples(st_j, out_free, ratio)
        assert tpg.expected_output(st_t, frames, ratio) == \
            jpg.expected_output(st_j, frames, ratio)
        gt = tpg.phase_grid(st_t, nf, FLAGS, ratio, frames, out_free)
        gj = jpg.phase_grid(st_j, nf, FLAGS, ratio, frames, out_free)
        assert (gt.input_used, gt.output_generated) == (gj.input_used, gj.output_generated)
        for f in ("win0", "idx1", "idx2", "mode"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
        np.testing.assert_array_equal(gt.weight.view(np.uint32), gj.weight.view(np.uint32))
        assert st_t.offset.view(np.uint32) == st_j.offset.view(np.uint32)
        assert st_t.input_index == st_j.input_index
        assert st_t.position == st_j.position


@pytest.mark.parametrize("bits", [8, 12, 16, 24, 32])
@pytest.mark.parametrize("gain_db", [0.0, -6.0, 3.5])
def test_gain_factor_bitidentical(bits, gain_db):
    assert tq.bytes_per_sample(bits) == jq.bytes_per_sample(bits)
    assert tq.gain_factor(bits, gain_db).view(np.uint32) == \
        jq.gain_factor(bits, gain_db).view(np.uint32)


_BUILD_AND_LOAD = """
import ctypes, sys, time
from pathlib import Path
from esp_audio_libs_tpu_torch.runtime.native import build_host_library
ready, go, lib = (Path(a) for a in sys.argv[1:4])
ready.touch()
while not go.exists():
    time.sleep(0.01)
h = ctypes.CDLL(str(build_host_library(lib)))
assert h.eal_design_filterbank(16, 4, ctypes.c_float(0.9), 0, (ctypes.c_float * 80)()) == 0
print("loaded")
"""


def test_concurrent_first_builds_load_a_complete_library(tmp_path):
    """Two processes build the host library into one empty build/ at once
    (the first use under pytest-xdist): both load a complete library, and
    the directory holds the library and the lock, no temporary file."""
    repo = Path(__file__).resolve().parent.parent
    build = tmp_path / "build"
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path / f"ready{i}"),
                               str(go), str(build / "libeal_host.so")], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    deadline = time.monotonic() + 120
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    go.touch()
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert sorted(f.name for f in build.iterdir()) == [".libeal_host.lock", "libeal_host.so"]

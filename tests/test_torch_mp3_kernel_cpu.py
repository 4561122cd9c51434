"""The MP3 granule kernel's CUDA source, run on the CPU.

``esp_audio_libs_tpu_torch/csrc/mp3_granules.cu`` is compiled with g++
(``-std=c++20 -fsanitize=undefined``) against ``tools/cuda_cpu_shim.h``,
which stands in for the CUDA runtime (one std::thread per CUDA thread,
std::barrier for the block and warp barriers), and its C entry point
``eal_mp3_granules`` is called through ctypes on numpy buffers. Its PCM,
carried state and reference-UB flag are held byte for byte to
``mp3_granules_plain`` on real parsed runs (tools/mp3frames.py): mono and
stereo, joint and intensity stereo, MPEG-1 and MPEG-2, tonal, window-type
and fuzz frames, B in {1, 3, 5}, and two runs in a row (the second from the
first's state, at another FIFO phase). Any undefined behaviour the
sanitizer reports (signed overflow, a shift out of range) fails the test.
Every ``--mp3`` variant of tools/kernel_variants.py is compiled the same
way (syntax only), so that an edit gone stale fails here and not on a card.

The test needs g++ (skipped without it) and no card.
"""

import ctypes as C
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import mp3_pipeline
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
from esp_audio_libs_tpu_torch.runtime import kernels

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import kernel_variants as kv  # noqa: E402
import mp3frames as mf  # noqa: E402

MONO, STEREO, JOINT_MS, MPEG2 = mf.BATCH_CFGS
INTENSITY = dict(ver_bits=3, bitrate_idx=9, sr_idx=1, mode=1, mode_ext=3)
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,>]+)(?:,.*?)?>>>\(")


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be compiled for the CPU")
    return path


def shim_source(cu: Path, tmp: Path, launches: int = 1) -> Path:
    """``cu`` as a C++ file in ``tmp`` that compiles against the shim: its
    ``launches`` ``<<<>>>`` launches rewritten into ``eal_shim_launch``, a
    ``cuda_runtime.h`` there that includes tools/cuda_cpu_shim.h, and the
    headers of csrc/ that it includes (unless ``tmp`` holds one already)."""
    (tmp / "cuda_runtime.h").write_text(f'#include "{REPO / "tools" / "cuda_cpu_shim.h"}"\n')
    text = cu.read_text()
    for header in re.findall(r'#include "([\w.]+)"', text):
        if not (tmp / header).exists() and (kernels.CSRC / header).exists():
            shutil.copy(kernels.CSRC / header, tmp / header)
    src, n = LAUNCH.subn(r"eal_shim_launch(\1, \2, \3, ", text)
    assert n == launches, f"{cu.name} should launch {launches} kernel(s), launches {n}"
    out = tmp / (cu.stem + ".cpp")
    out.write_text(src)
    return out


@pytest.fixture(scope="module")
def shim_lib(gxx, tmp_path_factory):
    """csrc/mp3_granules.cu built for the CPU through the shim, with its C
    signatures bound. UBSan reports go to the process's stderr (the
    sanitizer reads its options from the environment the process started
    with), which the tests capture with ``capfd``. The plain version runs on
    two torch threads meanwhile, beside the shim's 288 std::threads; the
    count is restored when the module's tests end."""
    tmp = tmp_path_factory.mktemp("mp3_shim")
    src = shim_source(kernels.CSRC / "mp3_granules.cu", tmp)
    lib = tmp / "libmp3_shim.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-fPIC", "-shared",
                          "-pthread", "-I", str(tmp), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield kernels.bind(C.CDLL(str(lib)), ("eal_mp3_consts_layout", "eal_mp3_granules"))
    torch.set_num_threads(threads)


def shim_granules(lib, huff, side, state, vindex, fmt):
    """One eal_mp3_granules call on numpy copies of the operands: (pcm
    [B, G, 576 nch], state, undef)."""
    ver, sr_idx, nch, cutoff = fmt
    G, B = huff.shape[:2]
    h = np.ascontiguousarray(huff.numpy())
    sd = np.ascontiguousarray(side.numpy())
    consts = mk._consts_np(ver, sr_idx)
    st = [np.ascontiguousarray(t.numpy()).copy() for t in state]
    pcm = np.zeros((B, G, 576 * nch), np.int16)
    undef = np.zeros(B, np.int32)
    rc = lib.eal_mp3_granules(h.ctypes.data, sd.ctypes.data, consts.ctypes.data,
                              *(t.ctypes.data for t in st), pcm.ctypes.data, undef.ctypes.data,
                              G, B, nch, vindex, cutoff, None)
    assert rc == 0
    return pcm, st, undef


def check_run(lib, capfd, huff, side, state, vindex, fmt, label):
    """The shim-built kernel against mp3_granules_plain, byte for byte, and
    no sanitizer report on stderr; returns the plain version's new state."""
    ver, sr_idx, nch, cutoff = fmt
    capfd.readouterr()
    pcm, st, undef = shim_granules(lib, huff, side, state, vindex, fmt)
    err = capfd.readouterr().err
    assert "runtime error" not in err, f"{label}: {err}"
    want_pcm, want_state, want_undef = mk.mp3_granules_plain(
        huff, side, *state, vindex, ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    np.testing.assert_array_equal(pcm, want_pcm.transpose(0, 1).numpy(), err_msg=f"{label}: pcm")
    for name, a, b in zip(("over", "prev_type", "prev_win_switch", "num_prev", "vbuf"), st,
                          want_state):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{label}: {name}")
    np.testing.assert_array_equal(undef != 0, want_undef.numpy(), err_msg=f"{label}: ref_undef")
    return want_state


def zero_state(B):
    return tuple(torch.zeros(s, dtype=torch.int32)
                 for s in ((B, 2, 288), (B, 2), (B, 2), (B, 2), (B, 2176)))


def streams_of(kind, cfg, B, n_frames, seed):
    if kind == "tonal":
        return [mf.tonal_stream(cfg, seed + i, n_frames) for i in range(B)]
    return [mf.mixed_stream(cfg, seed + i, n_frames, fuzz=kind == "fuzz") for i in range(B)]


def test_consts_layout(shim_lib):
    sizes = np.zeros(64, np.int32)
    n = shim_lib.eal_mp3_consts_layout(sizes.ctypes.data)
    assert tuple(sizes[:n]) == tuple(size for _, size in mk.CONST_LAYOUT)


@pytest.mark.parametrize("kind, cfg, B, n_frames", [
    ("tonal", STEREO, 3, 4),
    ("tonal", MONO, 1, 4),
    ("mixed", JOINT_MS, 5, 3),
    ("mixed", INTENSITY, 3, 3),
    ("fuzz", STEREO, 5, 3),
    ("mixed", MPEG2, 3, 4),
], ids=["tonal-stereo", "tonal-mono", "mixed-ms", "mixed-intensity", "fuzz-stereo",
        "mixed-mpeg2"])
def test_shim_kernel_matches_plain(shim_lib, capfd, kind, cfg, B, n_frames):
    streams = streams_of(kind, cfg, B, n_frames, 300 + B)
    runs = list(parsed_runs(BatchedMP3Decoder(B, device="cpu"), streams, n_frames))
    assert runs
    for fmt, vindex, _, huff, side in runs:
        check_run(shim_lib, capfd, torch.as_tensor(huff), torch.as_tensor(side),
                  zero_state(huff.shape[1]), vindex, fmt, f"{kind} {cfg} group {fmt}")


@pytest.mark.parametrize("cfg", [STEREO, MONO], ids=["stereo", "mono"])
def test_shim_kernel_two_runs(shim_lib, capfd, cfg):
    """A second run from the first's state, at the FIFO phase it left."""
    B, nf = 3, 3
    streams = streams_of("mixed", cfg, B, 2 * nf, 900)
    (fmt, vindex, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"),
                                                [s[: len(s) // 2] for s in streams], nf)
    state = check_run(shim_lib, capfd, torch.as_tensor(huff), torch.as_tensor(side), zero_state(B),
                      vindex, fmt, "run 0")
    v1 = mp3_pipeline._advance_vindex(vindex, huff.shape[0])
    assert v1 != vindex
    (fmt, _, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"),
                                           [s[len(s) // 2:] for s in streams], nf)
    check_run(shim_lib, capfd, torch.as_tensor(huff), torch.as_tensor(side), state, v1, fmt, "run 1")


def test_shim_kernel_random_state(shim_lib, capfd):
    """A run from random carried state at FIFO phase 5: overlap, block types,
    IMDCT block counts, and a ring whose two copies disagree (the kernel
    reads each carried value from the copy the step-by-step FIFO reads)."""
    B, nf = 3, 3
    streams = streams_of("mixed", STEREO, B, nf, 700)
    (fmt, _, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"), streams, nf)
    rng = np.random.default_rng(5)
    state = tuple(torch.as_tensor(a) for a in (
        rng.integers(-(1 << 20), 1 << 20, (B, 2, 288)).astype(np.int32),
        rng.integers(0, 4, (B, 2)).astype(np.int32), np.zeros((B, 2), np.int32),
        rng.integers(0, 33, (B, 2)).astype(np.int32),
        rng.integers(-(1 << 24), 1 << 24, (B, 2176)).astype(np.int32)))
    check_run(shim_lib, capfd, torch.as_tensor(huff), torch.as_tensor(side), state, 5, fmt,
              "random state")


@pytest.mark.parametrize("variant", sorted(kv.MP3_VARIANTS))
def test_kernel_variant_compiles(gxx, tmp_path, monkeypatch, variant):
    """Each ``--mp3`` variant of tools/kernel_variants.py, its edits applied
    to csrc/mp3_granules.cu, still compiles (g++ -fsyntax-only through the
    shim): the tool builds every variant at once on the card and stops at
    the first that nvcc refuses."""
    monkeypatch.setattr(kv, "OUT", tmp_path / "variants")
    cu = kv.make_variant(f"mp3_{variant}", "mp3_granules.cu", kv.MP3_VARIANTS[variant],
                         [kernels.CSRC / "mp3_granules.cu"]) / "mp3_granules.cu"
    src = shim_source(cu, cu.parent)
    res = subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-I", str(cu.parent), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, f"{variant}: {res.stderr[-2000:]}"

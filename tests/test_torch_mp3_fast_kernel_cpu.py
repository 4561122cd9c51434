"""The relaxed MP3 tiers' CUDA sources, run on the CPU.

``csrc/mp3_granules_f32.cu`` (the mirror tier's whole-run kernel) and both
entry points of ``csrc/mp3_mxu_step.cu`` (the MXU tier's granule-step
kernels) are compiled with g++ (``-std=c++20 -ffp-contract=off
-fsanitize=undefined``) against ``tools/cuda_cpu_shim.h``, as
tests/test_torch_mp3_kernel_cpu.py compiles csrc/mp3_granules.cu, and called
through ctypes against their plain versions on real parsed runs
(tools/mp3frames.py): mono, stereo, joint mid-side and intensity stereo,
MPEG-1 and MPEG-2, tonal, window-type and fuzz frames, B in {1, 3}, two runs
in a row (the second from the first's state, at another FIFO phase) and a
random carried state whose FIFO ring copies disagree (also as the state of
a second run). The edges of the f32 kernel's layout are cases too: G = 1
(no granule's PQMF overlaps another's IMDCT), an odd G (the run ends on the
other history) and mono at B = 3. The MXU kernels are held to their plain
versions step by step inside ``mp3mxu.mxu_run``, each step continuing from
the kernel's own results. With ``-ffp-contract=off`` the kernels' f32 sums
run in the plain versions' order, so PCM and state must equal the plain
versions' bit for bit. The one operation that is not the kernels' own is the
dequantizer's exp2f / log2f: the shim links the C library's, which differ
from torch's CPU exp2 by 1 ulp on some inputs, so the mirror tier is held
bit for bit to its plain version with ``torch.exp2`` / ``torch.log2`` taken
from that C library, and within 1 LSB of PCM and 1e-5 of the f32 state's
scale to the plain version as it is (the tolerance of the card, where nvcc
may also contract products into FMAs: tests/test_torch_kernels.py). Any
sanitizer report fails the test. ``eal_mp3_mxu_post`` is also held to
``mxu_post_plain`` bit for bit on chip_smoke.mxu_post_cases (accumulators
past int16 and on half-ties, masks mixed within groups of four, wide PCM
rows), and must refuse operands its 16- and 8-byte words cannot take.

The test needs g++ (skipped without it) and no card.
"""

import ctypes as C
import ctypes.util
import subprocess

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import mp3_pipeline
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
from esp_audio_libs_tpu_torch.ops import mp3mxu
from esp_audio_libs_tpu_torch.runtime import kernels
from tests.test_torch_mp3_kernel_cpu import gxx  # noqa: F401 (the g++ fixture)
from tests.test_torch_mp3_kernel_cpu import (INTENSITY, JOINT_MS, MONO, MPEG2, STEREO, kv,
                                             shim_source, streams_of)

STATE_RTOL = 1e-5
TIERS = ["mirror", "mxu"]
LIBM = C.CDLL(ctypes.util.find_library("m") or "libm.so.6")


def _build(gxx, tmp, name, launches, entries):
    src = shim_source(kernels.CSRC / name, tmp, launches)
    lib = tmp / f"lib{src.stem}.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fsanitize=undefined",
                          "-fPIC", "-shared", "-pthread", "-I", str(tmp), "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return kernels.bind(C.CDLL(str(lib)), entries)


@pytest.fixture(scope="module")
def libs(gxx, tmp_path_factory):
    """Both sources built for the CPU through the shim; the plain versions
    run on two torch threads beside the shim's threads."""
    tmp = tmp_path_factory.mktemp("mp3_fast_shim")
    built = {"mirror": _build(gxx, tmp, "mp3_granules_f32.cu", 1, ("eal_mp3_granules_f32",)),
             "mxu": _build(gxx, tmp, "mp3_mxu_step.cu", 2, ("eal_mp3_mxu_pre",
                                                             "eal_mp3_mxu_post"))}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield built
    torch.set_num_threads(threads)


STATE = ("over", "prev_type", "prev_win_switch", "num_prev", "vbuf")


def _same_state(got, want, label, names=STATE):
    """Each tensor equal bit for bit (f32 compared as its bit patterns)."""
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{label}: {name} dtype"
        if a.dtype == np.float32:
            n = int((a.view(np.int32) != b.view(np.int32)).sum())
            err = float(np.abs(a.astype(np.float64) - b).max(initial=0.0))
            assert n == 0, f"{label}: {name} differs in {n} values, max |d| {err:.3g}"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {name}")


def _close_state(got, want, label):
    """f32 state within STATE_RTOL of each tensor's largest magnitude, the
    rest equal."""
    for name, a, b in zip(STATE, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:
            scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
            err = float(np.abs(a.astype(np.float64) - b).max(initial=0.0))
            assert err <= STATE_RTOL * scale, f"{label}: {name} max |d| {err:.3g} of {scale:.3g}"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{label}: {name}")


def _libm_f32(name):
    """torch.<op> for one f32 tensor through the C library's ``name``f."""
    fn = getattr(LIBM, name)
    fn.restype, fn.argtypes = C.c_float, [C.c_float]

    def op(t):
        return torch.tensor([fn(v) for v in t.reshape(-1).tolist()],
                            dtype=torch.float32).reshape(t.shape)
    return op


def _same_pcm(got, want, label):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) == 0, f"{label}: pcm differs by {int(d.max())} in {int((d > 0).sum())}"


def shim_f32(lib, huff, side, state, vindex, fmt):
    """One eal_mp3_granules_f32 call on numpy copies: (pcm [G, B, 576 nch], state)."""
    ver, sr_idx, nch, cutoff = fmt
    G, B = huff.shape[:2]
    st = [np.ascontiguousarray(t.numpy()).copy() for t in state]
    pcm = np.zeros((B, G, 576 * nch), np.int16)
    h, sd = np.ascontiguousarray(huff.numpy()), np.ascontiguousarray(side.numpy())
    consts = mk._consts_np(ver, sr_idx)
    rc = lib.eal_mp3_granules_f32(h.ctypes.data, sd.ctypes.data, consts.ctypes.data,
                                  *(t.ctypes.data for t in st), pcm.ctypes.data, G, B, nch,
                                  vindex, cutoff, None)
    assert rc == 0
    return pcm.swapaxes(0, 1), tuple(torch.as_tensor(t) for t in st)


def shim_mxu(lib, huff, side, state, vindex, fmt, monkeypatch, label):
    """``mp3mxu.mxu_run`` with its two step kernels built through the shim,
    each held to its plain version on the same inputs at every step."""
    nch = fmt[2]

    def pre(yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
        want = mp3mxu.mxu_pre_plain(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        ofvc = torch.empty((ip.shape[0], mk.MXU_IN))
        args = [t.contiguous() for t in (yx, ip, over, pt, pws, npv, vbuf, px)]
        rc = lib.eal_mp3_mxu_pre(*(t.data_ptr() for t in args), ofvc.data_ptr(), over.shape[0],
                                 nch, None)
        assert rc == 0
        for t, new in zip((over, pt, pws, npv), args[2:6]):
            t.copy_(new)
        _same_state((ofvc.numpy(), over, pt, pws, npv), (want[0].numpy(), *want[1:]),
                    f"{label}: pre", ("[of | vc]",) + STATE[:4])
        return ofvc

    def post(acc, newv, vbuf, keep, out, *, nch):
        want_pcm, want_vbuf = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        rc = lib.eal_mp3_mxu_post(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(),
                                  keep.data_ptr(), out.data_ptr(), out.stride(0), vbuf.shape[0],
                                  nch, None)
        assert rc == 0
        _same_pcm(out.numpy(), want_pcm.numpy(), f"{label}: post")
        _same_state((vbuf,), (want_vbuf,), f"{label}: post", ("vbuf",))

    monkeypatch.setattr(mp3mxu, "mp3_mxu_pre_cuda", pre)
    monkeypatch.setattr(mp3mxu, "mp3_mxu_post_cuda", post)
    ver, sr_idx, _, cutoff = fmt
    pcm, st, _ = mp3mxu.mxu_run(huff, side, *state, vindex, ver=ver, sr_idx=sr_idx, nch=nch,
                                cutoff=cutoff)
    monkeypatch.undo()
    return pcm.numpy(), st


def check_run(libs, capfd, monkeypatch, tier, huff, side, state, vindex, fmt, label):
    """The shim-built kernel(s) of ``tier`` against the tier's plain run;
    returns the plain run's new state."""
    ver, sr_idx, nch, cutoff = fmt
    kw = dict(ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    capfd.readouterr()
    if tier == "mirror":
        pcm, st = shim_f32(libs["mirror"], huff, side, state, vindex, fmt)
        loose_pcm, loose_state, _ = mk.mp3_granules_f32_plain(huff, side, *state, vindex, **kw)
        d = np.abs(pcm.astype(np.int32) - loose_pcm.numpy().astype(np.int32)).max(initial=0)
        assert d <= 1, f"{label}: pcm differs from the plain version by {int(d)}"
        _close_state(st, loose_state, label)
        with pytest.MonkeyPatch.context() as mp:     # the shim's exp2f / log2f
            mp.setattr(torch, "exp2", _libm_f32("exp2f"))
            mp.setattr(torch, "log2", _libm_f32("log2f"))
            want_pcm, want_state, _ = mk.mp3_granules_f32_plain(huff, side, *state, vindex, **kw)
    else:
        pcm, st = shim_mxu(libs["mxu"], huff, side, state, vindex, fmt, monkeypatch, label)
        want_pcm, want_state, _ = mp3mxu.mxu_run(huff, side, *state, vindex, **kw)
    err = capfd.readouterr().err
    assert "runtime error" not in err, f"{label}: {err}"
    _same_pcm(pcm, want_pcm.numpy(), label)
    _same_state(st, want_state, label)
    return want_state


def zero_state(B):
    return (torch.zeros((B, 2, 288)), torch.zeros((B, 2), dtype=torch.int32),
            torch.zeros((B, 2), dtype=torch.int32), torch.zeros((B, 2), dtype=torch.int32),
            torch.zeros((B, 2176)))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind, cfg, B, n_frames", [
    ("tonal", STEREO, 3, 4),
    ("tonal", MONO, 1, 4),
    ("mixed", JOINT_MS, 3, 3),
    ("mixed", INTENSITY, 3, 3),
    ("fuzz", STEREO, 3, 3),
    ("mixed", MPEG2, 3, 4),
    ("tonal", MONO, 3, 4),
    ("tonal", MPEG2, 3, 1),
    ("mixed", MPEG2, 3, 3),
], ids=["tonal-stereo", "tonal-mono", "mixed-ms", "mixed-intensity", "fuzz-stereo",
        "mixed-mpeg2", "tonal-mono-b3", "tonal-mpeg2-g1", "mixed-mpeg2-g3"])
def test_shim_kernels_match_plain(libs, capfd, monkeypatch, tier, kind, cfg, B, n_frames):
    streams = streams_of(kind, cfg, B, n_frames, 400 + B)
    runs = list(parsed_runs(BatchedMP3Decoder(B, device="cpu"), streams, n_frames))
    assert runs
    if cfg is MPEG2 and n_frames < 4:     # the layout's edges: G = 1 and an odd G
        assert {h.shape[0] for _, _, _, h, _ in runs} == {n_frames}
    for fmt, vindex, _, huff, side in runs:
        check_run(libs, capfd, monkeypatch, tier, torch.as_tensor(huff), torch.as_tensor(side),
                  zero_state(huff.shape[1]), vindex, fmt, f"{tier} {kind} {cfg} {fmt}")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("cfg", [STEREO, MONO], ids=["stereo", "mono"])
def test_shim_kernels_two_runs(libs, capfd, monkeypatch, tier, cfg):
    """A second run from the first's state, at the FIFO phase it left."""
    B, nf = 3, 3
    streams = streams_of("mixed", cfg, B, 2 * nf, 910)
    (fmt, vindex, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"),
                                                [s[: len(s) // 2] for s in streams], nf)
    state = check_run(libs, capfd, monkeypatch, tier, torch.as_tensor(huff),
                      torch.as_tensor(side), zero_state(B), vindex, fmt, "run 0")
    v1 = mp3_pipeline._advance_vindex(vindex, huff.shape[0])
    assert v1 != vindex
    (fmt, _, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"),
                                           [s[len(s) // 2:] for s in streams], nf)
    check_run(libs, capfd, monkeypatch, tier, torch.as_tensor(huff), torch.as_tensor(side),
              state, v1, fmt, "run 1")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("second", [False, True], ids=["first-run", "second-run"])
def test_shim_kernels_random_state(libs, capfd, monkeypatch, tier, second):
    """A run from random carried state at FIFO phase 5: overlap, block
    types, IMDCT block counts, and a ring whose two copies disagree (the f32
    kernel's first granule reads each carried value from the copy the
    step-by-step FIFO reads). ``second``: that run continues from the state
    of a first run (at the phase it left), its ring's two copies made to
    disagree in between."""
    B, nf = 3, 3
    streams = streams_of("mixed", STEREO, B, 2 * nf, 710)
    fleet = BatchedMP3Decoder(B, device="cpu")
    (fmt, _, _, huff, side), = parsed_runs(fleet, [s[: len(s) // 2] for s in streams], nf)
    rng = np.random.default_rng(6)
    state = tuple(torch.as_tensor(a) for a in (
        (rng.standard_normal((B, 2, 288)) * 1e5).astype(np.float32),
        rng.integers(0, 4, (B, 2)).astype(np.int32), np.zeros((B, 2), np.int32),
        rng.integers(0, 33, (B, 2)).astype(np.int32),
        (rng.standard_normal((B, 2176)) * 1e5).astype(np.float32)))
    vindex = 5
    if second:
        state = check_run(libs, capfd, monkeypatch, tier, torch.as_tensor(huff),
                          torch.as_tensor(side), state, vindex, fmt, "random state, run 0")
        vindex = mp3_pipeline._advance_vindex(vindex, huff.shape[0])
        vbuf = state[4].clone().reshape(B, 34, 8, 8)
        vbuf[:, :, 1::2] += torch.as_tensor(rng.standard_normal((B, 34, 4, 8)).astype(np.float32))
        state = (*state[:4], vbuf.reshape(B, 2176))
        (fmt, _, _, huff, side), = parsed_runs(BatchedMP3Decoder(B, device="cpu"),
                                               [s[len(s) // 2:] for s in streams], nf)
    check_run(libs, capfd, monkeypatch, tier, torch.as_tensor(huff), torch.as_tensor(side), state,
              vindex, fmt, "random state" + (", run 1" if second else ""))


def shim_post(lib):
    """``mp3_mxu_post_cuda``'s contract through the shim's eal_mp3_mxu_post."""
    def post(acc, newv, vbuf, keep, out, *, nch):
        rc = lib.eal_mp3_mxu_post(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(),
                                  keep.data_ptr(), out.data_ptr(), out.stride(0), vbuf.shape[0],
                                  nch, None)
        assert rc == 0
    return post


@pytest.mark.parametrize("nch", [1, 2])
def test_shim_mxu_post_cases(libs, capfd, nch):
    """eal_mp3_mxu_post against ``mxu_post_plain`` bit for bit on the
    direct check's cases (chip_smoke.mxu_post_cases): accumulators past the
    int16 range and on half-ties, the eight probed masks and masks mixed
    within groups of four, B of 1, 3 and 37, PCM rows wider than a granule;
    the rows' padding untouched."""
    keeps = list(mp3mxu.device_operators(torch.device("cpu"))["keep"])
    cases = [c for c in kv.cs.mxu_post_cases(keeps, "cpu") if c[1] == nch]
    capfd.readouterr()
    assert kv.cs.mxu_post_mismatches(shim_post(libs["mxu"]), cases) == []
    err = capfd.readouterr().err
    assert "runtime error" not in err, err


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("operand", ["acc", "newv", "vbuf", "keep", "pcm", "pitch"])
def test_shim_mxu_post_refuses_misaligned(libs, operand, nch):
    """eal_mp3_mxu_post returns cudaErrorInvalidValue, and writes nothing,
    unless acc, newv, vbuf and keep are 16-byte aligned and the PCM base and
    row pitch are multiples of its 8 nch-byte stores."""
    B, width = 2, 576 * nch
    acc, newv, vbuf, keep = (torch.zeros(n + 4) for n in (B * nch * 576, B * nch * 1088,
                                                         B * 2176, 1088))
    pitch = width + (4 * nch - 1 if operand == "pitch" else 0)
    buf = torch.full((B * pitch + 8,), 7, dtype=torch.int16)
    ptr = {k: t.data_ptr() for k, t in (("acc", acc), ("newv", newv), ("vbuf", vbuf),
                                        ("keep", keep), ("pcm", buf))}
    ptr[operand] = ptr.get(operand, 0) + (2 if operand == "pcm" else 4)
    if operand == "pitch":
        ptr.pop("pitch")
    rc = libs["mxu"].eal_mp3_mxu_post(ptr["acc"], ptr["newv"], ptr["vbuf"], ptr["keep"],
                                      ptr["pcm"], pitch, B, nch, None)
    assert rc == 1   # cudaErrorInvalidValue
    assert bool((buf == 7).all()) and not vbuf.any()
    good = libs["mxu"].eal_mp3_mxu_post(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(),
                                        keep.data_ptr(), buf.data_ptr(), width, B, nch, None)
    assert good == 0 and not bool((buf[:B * width] == 7).any())


VARIANT_CASES = ([("mp3_granules_f32.cu", 1, name, edits)
                  for name, edits in sorted(kv.MP3F32_VARIANTS.items())]
                 + [("mp3_mxu_step.cu", 2, name, edits)
                    for name, edits in sorted(kv.MXU_PRE_VARIANTS.items())]
                 + [("mp3_mxu_step.cu", 2, f"post_{name}", edits)
                    for name, edits in sorted(kv.MXU_POST_VARIANTS.items())])


@pytest.mark.parametrize("source, launches, variant, edits", VARIANT_CASES,
                         ids=[f"{s.split('.')[0]}-{n}" for s, _, n, _ in VARIANT_CASES])
def test_kernel_variant_compiles(gxx, tmp_path, monkeypatch, source, launches, variant, edits):
    """Each ``--mp3f32``, ``--mxu-pre`` and ``--mxu-post`` variant of
    tools/kernel_variants.py, its edits applied to its source, still
    compiles (g++ -fsyntax-only through the shim): the tool builds every
    variant at once on the card and stops at the first that nvcc refuses."""
    monkeypatch.setattr(kv, "OUT", tmp_path / "variants")
    cu = kv.make_variant(f"{variant}", source, edits, [kernels.CSRC / source]) / source
    src = shim_source(cu, cu.parent, launches)
    res = subprocess.run([gxx, "-std=c++20", "-fsyntax-only", "-I", str(cu.parent), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, f"{variant}: {res.stderr[-2000:]}"

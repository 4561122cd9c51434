"""The unpack-gain-extend kernel's CUDA source, run on the CPU.

``esp_audio_libs_tpu_torch/csrc/pcm_unpack16.cu`` is compiled with g++
(``-std=c++20 -fsanitize=undefined -ffp-contract=off``) against
``tools/cuda_cpu_shim.h`` (one std::thread per CUDA thread, blocks one
after another over both grid axes) and its C entry point
``eal_unpack16_extend`` is called through ctypes on the CPU tensors of
``chip_smoke.unpack16_cases``: the cells' shapes scaled down (H = 72, 326
and 0, the fast slab's padded tail), a chunk inside a wider row, row starts
at 1-, 2-, 4-, 8- and 16-byte alignment, an odd L, a strided history, gains
of 0, -6.02 and +12 dB and a subnormal gain factor, -32768 and 32767, B = 1,
frames = 0 and L = H + frames. The slab is held to
``unpack16_extend_plain`` bit for bit; any undefined behaviour the sanitizer
reports fails the test. The entry point refuses L < H + frames, negative
sizes, a missing history and a misaligned slab, writing nothing; the
wrapper refuses operands of the wrong dtype or shape before any launch.

The test needs g++ (skipped without it) and no card.
"""

import ctypes as C
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk
from esp_audio_libs_tpu_torch.runtime import kernels
from tests.test_torch_mp3_kernel_cpu import REPO, gxx, shim_source  # noqa: F401


@pytest.fixture(scope="module")
def unpack_lib(gxx, tmp_path_factory):  # noqa: F811
    """csrc/pcm_unpack16.cu built for the CPU through the shim, with its C
    signature bound."""
    tmp = tmp_path_factory.mktemp("unpack_shim")
    src = shim_source(kernels.CSRC / "pcm_unpack16.cu", tmp)
    lib = tmp / "libunpack_shim.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-ffp-contract=off",
                          "-fPIC", "-shared", "-pthread", "-I", str(tmp), "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return kernels.bind(C.CDLL(str(lib)), ("eal_unpack16_extend",))


def hist_args(hist):
    return (0, 0, 0, 0, 0) if hist is None else (hist.data_ptr(), *hist.stride(), hist.shape[2])


def shim_unpack(lib):
    """eal_unpack16_extend with the wrapper's arguments, on CPU tensors, into
    a slab filled with NaN first."""
    def unpack(data, frames, factor, hist, L):
        out = torch.full((data.shape[0], 2, L), chip_smoke.UNPACK_FILL)
        rc = lib.eal_unpack16_extend(data.data_ptr(), data.stride(0), frames, float(factor),
                                     *hist_args(hist), out.data_ptr(), L, data.shape[0], None)
        assert rc == 0
        return out
    return unpack


CASES = chip_smoke.unpack16_cases("cpu")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shim_unpack_matches_plain(unpack_lib, capfd, case):
    capfd.readouterr()
    assert chip_smoke.unpack16_mismatches(shim_unpack(unpack_lib), [case]) == []
    err = capfd.readouterr().err
    assert "runtime error" not in err, err


@pytest.mark.parametrize("case", ["L < H + frames", "negative frames", "missing history",
                                  "misaligned slab"])
def test_shim_unpack_refuses_bad_arguments(unpack_lib, case):
    """A refused launch returns cudaErrorInvalidValue and writes nothing."""
    B, frames, H = 2, 33, 5
    data = torch.randint(0, 256, (B, frames * 4), dtype=torch.uint8)
    hist = torch.rand((B, 2, H))
    buf = torch.full((B * 2 * (H + frames) + 1,), 7.0)
    base, L, n, h = buf.data_ptr(), H + frames, frames, hist_args(hist)
    if case == "L < H + frames":
        L -= 1
    elif case == "negative frames":
        n = -1
    elif case == "missing history":
        h = (0, *h[1:])
    else:
        base += 2
    rc = unpack_lib.eal_unpack16_extend(data.data_ptr(), data.stride(0), n, 1.0 / 32768, *h,
                                        base, L, B, None)
    assert rc != 0
    assert bool((buf == 7.0).all())


def test_unpack16_extend_refuses_bad_operands():
    """The wrapper raises on operands of the wrong dtype or shape, on the
    CPU as on the card, before it runs anything."""
    data = torch.zeros((2, 40), dtype=torch.uint8)
    hist = torch.zeros((2, 2, 3))
    for label, args in (("data dtype", (data.to(torch.int16), 10, 1.0, hist, 13)),
                        ("data rank", (data[0], 10, 1.0, hist, 13)),
                        ("short rows", (data, 11, 1.0, hist, 14)),
                        ("negative frames", (data, -1, 1.0, hist, 13)),
                        ("hist dtype", (data, 10, 1.0, hist.double(), 13)),
                        ("hist streams", (data, 10, 1.0, hist[:1], 13)),
                        ("mono hist", (data, 10, 1.0, hist[:, :1], 13)),
                        ("L < H + frames", (data, 10, 1.0, hist, 12))):
        with pytest.raises(ValueError):
            qk.unpack16_extend_cuda(*args)
            pytest.fail(label)
    with pytest.raises(ValueError, match="device"):
        qk.unpack16_extend_cuda(data.to("meta"), 10, 1.0, hist.to("meta"), 13)


def test_unpack16_extend_routes_cpu_to_plain():
    """On CPU tensors the wrapper runs its plain version and launches
    nothing: the slab equals the history cat of int_to_float(
    unpack_pcm16_planar2(...)) padded with zeros, bit for bit."""
    from esp_audio_libs_tpu_torch.ops import quantization as q
    qk.reset_launch_counts()
    assert chip_smoke.unpack16_mismatches(qk.unpack16_extend_cuda, CASES) == []
    _, data, frames, gain, hist, L = CASES[1]
    factor = q.gain_factor(16, gain)
    got = qk.unpack16_extend_cuda(data, frames, factor, hist, L)
    x = q.int_to_float(q.unpack_pcm16_planar2(data), factor)
    want = torch.cat([hist, x, torch.zeros((x.shape[0], 2, L - hist.shape[2] - frames))], -1)
    assert got.shape == (3, 2, L)
    assert np.array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    assert qk.unpack16_extend_cuda.launches == 0

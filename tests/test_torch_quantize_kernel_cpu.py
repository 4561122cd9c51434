"""The quantize-and-pack kernel's CUDA source, run on the CPU.

``esp_audio_libs_tpu_torch/csrc/pcm_quantize16.cu`` is compiled with g++
(``-std=c++20 -fsanitize=undefined -ffp-contract=off``) against
``tools/cuda_cpu_shim.h`` (one std::thread per CUDA thread, the warp
shuffles of the clip-count reduction through the shim's per-warp slots) and
its C entry point ``eal_quantize_pack16`` is called through ctypes on the
CPU tensors of ``chip_smoke.quantize16_cases``: NaN, infinities, +-2^31 and
+-2^31 / 32768 with their neighbours, subnormals, half-ties, values either
side of +-1, gen < T, gen = 0 and past T, odd T (the up cell's 22587),
strided inputs, output rows inside wider padded rows, B = 1, T = 0. Bytes
(the padding included) and clip counts are held to
``quantize_pack16_plain`` byte for byte; any undefined behaviour the
sanitizer reports fails the test. The entry point refuses a misaligned
output, a pitch shorter than a row and a negative gen, writing nothing.

The test needs g++ (skipped without it) and no card.
"""

import ctypes as C
import subprocess

import pytest
import torch

import chip_smoke
from esp_audio_libs_tpu_torch.runtime import kernels
from tests.test_torch_mp3_kernel_cpu import REPO, gxx, shim_source  # noqa: F401


@pytest.fixture(scope="module")
def quant_lib(gxx, tmp_path_factory):  # noqa: F811
    """csrc/pcm_quantize16.cu built for the CPU through the shim, with its C
    signature bound."""
    tmp = tmp_path_factory.mktemp("quant_shim")
    src = shim_source(kernels.CSRC / "pcm_quantize16.cu", tmp)
    lib = tmp / "libquant_shim.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-ffp-contract=off",
                          "-fPIC", "-shared", "-pthread", "-I", str(tmp), "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return kernels.bind(C.CDLL(str(lib)), ("eal_quantize_pack16",))


def shim_quantize(lib):
    """eal_quantize_pack16 with the wrapper's arguments, on CPU tensors."""
    def quantize(x, gen, out, clips):
        B, _, T = x.shape
        rc = lib.eal_quantize_pack16(x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(),
                                     out.stride(0) // 4, clips.data_ptr(), B, T, min(gen, T),
                                     None)
        assert rc == 0
    return quantize


CASES = chip_smoke.quantize16_cases("cpu")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shim_quantize_matches_plain(quant_lib, capfd, case):
    capfd.readouterr()
    assert chip_smoke.quantize16_mismatches(shim_quantize(quant_lib), [case]) == []
    err = capfd.readouterr().err
    assert "runtime error" not in err, err


@pytest.mark.parametrize("case", ["misaligned output", "short pitch", "negative gen"])
def test_shim_quantize_refuses_bad_arguments(quant_lib, case):
    """A refused launch returns cudaErrorInvalidValue and writes nothing."""
    B, T = 2, 33
    x = torch.rand((B, 2, T)) * 2 - 1
    buf = torch.full((B, T * 4 + 8), chip_smoke.QUANT_PAD, dtype=torch.uint8)
    clips = torch.full((B,), -1, dtype=torch.int64)
    base, pitch, gen = buf.data_ptr(), buf.stride(0) // 4, T
    if case == "misaligned output":
        base += 1
    elif case == "short pitch":
        pitch = T - 1
    else:
        gen = -1
    rc = quant_lib.eal_quantize_pack16(x.data_ptr(), x.stride(0), x.stride(1), base, pitch,
                                       clips.data_ptr(), B, T, gen, None)
    assert rc != 0
    assert bool((buf == chip_smoke.QUANT_PAD).all()) and bool((clips == -1).all())

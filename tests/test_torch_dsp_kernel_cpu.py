"""The exact dot kernel's CUDA source, run on the CPU.

``esp_audio_libs_tpu_torch/csrc/dotprod_exact.cu`` is compiled with g++
(``-std=c++20 -fsanitize=undefined -ffp-contract=off``) against
``tools/cuda_cpu_shim.h`` (one std::thread per CUDA thread, std::barrier for
the block barrier; ``mul_ftz``/``add_ftz`` as flushed IEEE f32 ops in place
of the PTX ``.rn.ftz`` helpers of ``exact_async.cuh``), and its C entry
point ``eal_dotprod_exact`` is called through ctypes on numpy buffers. Its
output is held bit for bit to ``dotprod_exact_plain`` on ragged shapes (n
from 0 to several tiles, rows that do not fill a row group), through both
copy paths (tensor copies of 32-column boxes, zero past n and R, where every
row starts 16-byte aligned; 4-byte copies where a pitch or a base is not
aligned), with the ring wrapping (more tiles than stages) and persistent
blocks walking several row groups (the shim's grid has at most two blocks),
on operands whose products fall into the subnormal range, and against a
numpy left-to-right loop. Any undefined behaviour the sanitizer reports
fails the test, and an mbarrier that receives more arrivals than its phase
expects, or whose waiter falls two phases behind, aborts the process.

The test needs g++ (skipped without it) and no card.
"""

import ctypes as C
import subprocess

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.ops.dsp_kernels import dotprod_exact_plain
from esp_audio_libs_tpu_torch.runtime import kernels
from tests.test_torch_mp3_kernel_cpu import REPO, gxx, shim_source  # noqa: F401


@pytest.fixture(scope="module")
def dot_lib(gxx, tmp_path_factory):  # noqa: F811
    """csrc/dotprod_exact.cu built for the CPU through the shim, with its C
    signature bound; an ``exact_async.cuh`` beside the copy maps the PTX
    helpers to the shim's stand-ins."""
    tmp = tmp_path_factory.mktemp("dot_shim")
    (tmp / "exact_async.cuh").write_text(
        f'#pragma once\n#include "{REPO / "tools" / "cuda_cpu_shim.h"}"\n')
    src = shim_source(kernels.CSRC / "dotprod_exact.cu", tmp)
    lib = tmp / "libdot_shim.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-ffp-contract=off",
                          "-fPIC", "-shared", "-pthread", "-I", str(tmp), "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return kernels.bind(C.CDLL(str(lib)), ("eal_dotprod_exact",))


def shim_dot(lib, a, b, offset=0, pitch=None):
    """eal_dotprod_exact on rows of ``a`` and ``b`` ([R, n] f32), each
    placed ``offset`` floats into its buffer (an unaligned base for offsets
    that are not multiples of 4), rows ``pitch`` floats apart (n by
    default); the gaps between rows hold NaN, which no sum may reach."""
    R, n = a.shape
    pitch = n if pitch is None else pitch
    bufs = []
    for x in (a, b):
        buf = np.full(offset + R * pitch + 4, np.nan, np.float32)
        rows = buf[offset:offset + R * pitch].reshape(R, pitch)
        rows[:, :n] = x
        bufs.append(buf)
    out = np.full(R, np.nan, np.float32)
    rc = lib.eal_dotprod_exact(bufs[0].ctypes.data + 4 * offset, pitch, bufs[1].ctypes.data
                               + 4 * offset, pitch, out.ctypes.data, R, n, None)
    assert rc == 0
    return out


def check_dot(lib, capfd, a, b, **layout):
    """shim_dot bit for bit against the plain version and the numpy loop,
    with no sanitizer report."""
    capfd.readouterr()
    got = shim_dot(lib, a, b, **layout)
    err = capfd.readouterr().err
    assert "runtime error" not in err, err
    want = dotprod_exact_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), left_to_right(a, b).view(np.uint32))


def left_to_right(a, b):
    """numpy f32 loop in the C order, no subnormal flush (callers keep the
    operands where none arises)."""
    acc = np.zeros(a.shape[0], np.float32)
    for i in range(a.shape[1]):
        acc = (acc + (a[:, i] * b[:, i]).astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("R, n, offset", [
    (1, 0, 0), (3, 1, 0), (33, 17, 0), (5, 128, 0), (40, 260, 0), (7, 4099, 0),
    (9, 256, 1), (70, 64, 2), (2, 4100, 3),
])
def test_shim_dot_matches_plain(dot_lib, capfd, R, n, offset):
    """Ragged n (0, 1, 17, 4099), tiles exactly full (128, 256, 4100), rows
    past a group's 32, both copy paths: tensor copies where the pitch n is a
    multiple of 4 and the base aligned, 4-byte copies for odd n or an odd
    base offset."""
    rng = np.random.default_rng(R * 1000 + n + offset)
    a = rng.standard_normal((R, n)).astype(np.float32)
    b = rng.standard_normal((R, n)).astype(np.float32)
    check_dot(dot_lib, capfd, a, b, offset=offset)


@pytest.mark.parametrize("R, n, offset, pitch", [
    (5, 1280, 0, None),     # 10 tensor-copied tiles through a 4-stage ring: it wraps twice
    (3, 1283, 0, None),     # 11 tiles of 4-byte copies: the ring wraps on that path too
    (200, 100, 0, None),    # 7 row groups on the shim's 2 blocks, tensor copies
    (161, 33, 0, None),     # 6 row groups (the last of 1 row), 4-byte copies
    (70, 600, 0, 602),      # pitch 602, not a multiple of 4: 4-byte copies, 3 groups
    (40, 262, 0, 264),      # tensor copies; a 6-column tail box, zero past n
    (5, 20, 0, None),       # tensor copies: one box past the rows and the columns
    (97, 300, 2, 301),      # odd pitch, unaligned base: 4-byte copies, 4 groups
])
def test_shim_dot_ring_and_groups(dot_lib, capfd, R, n, offset, pitch):
    """The redesign's edges: a ring that wraps, persistent blocks that walk
    several row groups (the ring running on across group boundaries), both
    copy paths, tail boxes past n and R. The gaps between rows hold NaN, so
    a copy past a row's n columns would show."""
    rng = np.random.default_rng(R * 1000 + n + offset)
    a = rng.standard_normal((R, n)).astype(np.float32)
    b = rng.standard_normal((R, n)).astype(np.float32)
    check_dot(dot_lib, capfd, a, b, offset=offset, pitch=pitch)


def test_shim_dot_flushes_subnormals(dot_lib):
    """Products that underflow into the subnormal range and subnormal
    operands count as zeros of their sign; sums that would end subnormal
    flush too. +0 + (-0) stays +0."""
    rng = np.random.default_rng(7)
    R, n = 36, 300
    a = (rng.standard_normal((R, n)) * 1e-20).astype(np.float32)
    b = (rng.standard_normal((R, n)) * 1e-19).astype(np.float32)
    a[0, :] = 1e-39
    b[0, :] = 1.0
    a[1, :5] = [1.5e-38, -1.4e-38, 3e-38, -3e-38, 1e-39]
    b[1, :5] = 1.0
    a[2, :] = -0.0
    got = shim_dot(dot_lib, a, b)
    want = dotprod_exact_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == 0 and got[2] == 0 and not np.signbit(got[2])


def test_shim_dot_copy_paths_agree(dot_lib, capfd):
    """The same 70 rows (three row groups) through the tensor copies (an
    aligned contiguous [R, n]) and through the 4-byte copies (the same rows
    one float past an aligned base) give the same bits as each other and as
    the plain version."""
    rng = np.random.default_rng(70)
    a = rng.standard_normal((70, 200)).astype(np.float32)
    b = rng.standard_normal((70, 200)).astype(np.float32)
    capfd.readouterr()
    tensor = shim_dot(dot_lib, a, b)
    words = shim_dot(dot_lib, a, b, offset=1)
    err = capfd.readouterr().err
    assert "runtime error" not in err, err
    np.testing.assert_array_equal(tensor.view(np.uint32), words.view(np.uint32))
    want = dotprod_exact_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(tensor.view(np.uint32), want.view(np.uint32))

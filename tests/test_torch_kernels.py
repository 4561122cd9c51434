"""The port's CUDA kernels and their wrappers, without JAX.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed (skipping the JAX-configuring conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` hold each kernel against its plain PyTorch version
at the slice's shapes and skip without a card; the others check the
wrappers' routing on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.ops import polyphase as tpoly
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.runtime import kernels

torch.set_num_threads(2)

# the banded contraction's tolerance (tests/test_polyphase_banded.py:131):
# f32 sums of ~300 products taken in another order
RTOL, ATOL = 2e-6, 4e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' bmm
    return torch.device("cuda")


def random_banded(rng, nt, K, band):
    """Weight tiles with one random band of ``band`` taps per column."""
    Wt = np.zeros((nt, K, 128), np.float32)
    for i in range(nt):
        for j in range(128):
            o = rng.integers(0, K - band)
            Wt[i, o:o + band, j] = rng.standard_normal(band).astype(np.float32)
    return Wt


def fused_inputs(seed, M=32):
    """Raw int16 slabs and gain-folded weights with one column of huge
    weights: its products overflow int32 -> INT_MIN -> clip to NEGATIVE
    full scale."""
    rng = np.random.default_rng(seed)
    L, nt, K = 1024, 3, 512
    x = rng.integers(-32768, 32768, (M, L), dtype=np.int16)
    Wt = (rng.standard_normal((nt, K, 128)) * 0.02).astype(np.float32)
    Wt[:, 300:, :] = 0.0
    Wt[0, :300, 5] = 1e6
    starts = np.array([0, 128, 256], np.int32)
    return x, Wt * np.float32(1.0 / 32768.0), starts


def test_plain_banded_shared_weight_tile():
    """The post-filter conv passes one weight block broadcast over all
    tiles (tile stride 0); the result equals the materialized tiles."""
    rng = np.random.default_rng(9)
    M, nt, K = 6, 5, 256
    W = torch.from_numpy(random_banded(rng, 1, K, 100)[0])
    x = torch.from_numpy(rng.standard_normal((M, nt * 128 + K)).astype(np.float32))
    starts = torch.arange(nt, dtype=torch.int32) * 128
    a = pk.polyphase_banded_cuda(x, W[None].expand(nt, K, 128), starts, T=nt * 128 - 7)
    b = tpoly.polyphase_banded(x, W[None].repeat(nt, 1, 1), starts, T=nt * 128 - 7)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_tensors_take_the_plain_versions():
    x, Wt, starts = (torch.from_numpy(a) for a in fused_inputs(3))
    pk.reset_launch_counts()
    s, c = pk.polyphase_fused16_cuda(x, Wt, starts)
    s_p, c_p = pk.polyphase_fused16_plain(x, Wt, starts)
    assert torch.equal(s, s_p) and torch.equal(c, c_p)
    y = pk.polyphase_banded_cuda(x.float(), Wt, starts, T=300)
    assert torch.equal(y, tpoly.polyphase_banded(x.float(), Wt, starts, T=300))
    assert pk.polyphase_banded_cuda.launches == pk.polyphase_fused16_cuda.launches == 0


def test_build_skips_nvcc_when_library_is_current(tmp_path, monkeypatch):
    lib = tmp_path / "libeal_kernels.so"
    lib.write_bytes(b"")
    newest = max(p.stat().st_mtime for p in kernels.CSRC.iterdir())
    os.utime(lib, (newest + 10, newest + 10))
    monkeypatch.setattr(kernels, "LIB_PATH", lib)
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail("nvcc invoked"))
    assert kernels.build() == lib


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "LIB_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 640), device="meta")
    W = torch.zeros((1, 512, 128), device="meta")
    s = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        pk.polyphase_banded_cuda(x, W, s, T=128)
    with pytest.raises(ValueError, match="device"):
        pk.polyphase_fused16_cuda(x.to(torch.int16), W, s)


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,nt,K,step", [
    (4096, 8576, 24, 768, 359),       # 44.1k -> 16k main contraction
    (512, 23296, 177, 512, 128),      # 16k -> 44.1k post-filter conv
    (37, 2100, 6, 512, 310)])         # ragged rows, unaligned starts
def test_banded_kernel_matches_plain(cuda, M, L, nt, K, step):
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, L)).astype(np.float32)).to(cuda)
    Wt = torch.from_numpy(random_banded(rng, nt, K, min(318, K - 1))).to(cuda)
    starts = torch.from_numpy(np.minimum(np.arange(nt) * step, L - K).astype(np.int32)).to(cuda)
    T = nt * 128 - 11
    before = pk.polyphase_banded_cuda.launches
    got = pk.polyphase_banded_cuda(x, Wt, starts, T=T)
    torch.cuda.synchronize()
    assert pk.polyphase_banded_cuda.launches == before + 1
    torch.testing.assert_close(got, tpoly.polyphase_banded(x, Wt, starts, T=T),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_banded_kernel_shared_weight_tile(cuda):
    rng = np.random.default_rng(2)
    M, nt, K = 70, 9, 512
    W = torch.from_numpy(random_banded(rng, 1, K, 400)[0]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((M, nt * 128 + K)).astype(np.float32)).to(cuda)
    starts = torch.arange(nt, dtype=torch.int32, device=cuda) * 128
    got = pk.polyphase_banded_cuda(x, W[None].expand(nt, K, 128), starts, T=nt * 128 - 3)
    ref = tpoly.polyphase_banded(x, W[None].repeat(nt, 1, 1), starts, T=nt * 128 - 3)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused16_kernel_matches_plain(cuda):
    x, Wt, starts = (torch.from_numpy(a).to(cuda) for a in fused_inputs(11, M=100))
    s_k, c_k = pk.polyphase_fused16_cuda(x, Wt, starts)
    torch.cuda.synchronize()
    s_p, c_p = pk.polyphase_fused16_plain(x, Wt, starts)
    a, b = s_k.cpu().numpy().astype(np.int32), s_p.cpu().numpy().astype(np.int32)
    assert np.abs(a - b).max() <= 1
    same = a == b
    np.testing.assert_array_equal(c_k.cpu().numpy()[same], c_p.cpu().numpy()[same])
    assert (a[:, 5] == -32768).all()


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst,fused", [
    (44100.0, 16000.0, False), (44100.0, 16000.0, True), (16000.0, 44100.0, False)])
def test_resampler_on_card_matches_cpu(cuda, monkeypatch, src, dst, fused):
    if fused:
        monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    cfg = ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32)
    B, frames, n = 32, 2048, 3
    data = np.random.default_rng(1).integers(0, 256, (B, n * frames * 4), dtype=np.uint8)
    outs = []
    for dev in (cuda, "cpu"):
        r = Resampler(batch=B, exact=False, device=dev)
        r.initialize(cfg)
        outs.append((*r.resample_stream(data, frames, n), r.history.cpu()))
    (pg, gg, cg, hg), (pc, gc, cc, hc) = outs
    assert gg == gc
    a = pg.cpu().numpy().view(np.int16).astype(np.int32)
    b = pc.numpy().view(np.int16).astype(np.int32)
    d = np.abs(a - b)
    assert d.max() <= 1
    assert np.abs(cg.astype(np.int64) - cc.astype(np.int64)).sum() <= (d > 0).sum()
    assert torch.equal(hg, hc)

"""The port's CUDA kernels and their wrappers, without JAX.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed (skipping the JAX-configuring conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` hold each kernel against its plain PyTorch version
at the slice's shapes and skip without a card; the others check the
wrappers' routing on the CPU, the plain band-range function, and a CPU
emulation of the kernels' 3xTF32 arithmetic on a chunk's real operands,
which predicts what the card shows. The FLAC frame kernel is held to its
plain version byte for byte on the real parsed buckets of
tools/flac_kernel_fleet.py (numpy and the port only), the fleet that
chip_smoke.py checks too. The exact-mode kernels (csrc/biquad_exact.cu and
csrc/polyphase_exact.cu) are held to their plain versions bit for bit
(NaN positions equal, every other f32 bit pattern equal). The MP3 granule
kernel (csrc/mp3_granules.cu) is held to its plain version byte for byte,
new state included, on real parsed runs of tools/mp3frames.py streams; the
relaxed tiers' kernels (csrc/mp3_granules_f32.cu, csrc/mp3_mxu_step.cu) to
theirs within 1 LSB of PCM and a relative tolerance of state, step by step
for the MXU tier's two step kernels, with the escape tier and ragged B;
mp3_mxu_post, which rounds nothing but floor(acc + 0.5), bit for bit, also
on chip_smoke.mxu_post_cases, and its wrapper raises on misaligned operands.
The exact dot kernel (csrc/dotprod_exact.cu) is held to its plain version
bit for bit on ragged, unaligned and subnormal operands; the quantize-and-pack
kernel (csrc/pcm_quantize16.cu) byte for byte, clip counts included, on
chip_smoke.quantize16_cases and inside exact resample_stream calls; the DSP layer
(ops/dsp.py) and the MP3 fleet's pipelined runs and checkpoints on the card
to CPU runs.
"""

import dataclasses
import math
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.models import mp3_pipeline
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
from esp_audio_libs_tpu_torch.ops import biquad as tbq
from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
from esp_audio_libs_tpu_torch.ops import dsp
from esp_audio_libs_tpu_torch.ops import dsp_kernels as dk
from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
from esp_audio_libs_tpu_torch.ops import polyphase as tpoly
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.ops import quantization as q
from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk
from esp_audio_libs_tpu_torch.runtime import kernels, transport
from esp_audio_libs_tpu_torch.runtime.phase_grid import HISTORY_MARGIN, PhaseState, phase_grid

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import chip_smoke  # noqa: E402
import flac_kernel_fleet as fleet  # noqa: E402
import mp3frames as mf  # noqa: E402

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


@pytest.mark.parametrize("newer", ["polyphase_exact.cu", "exact_async.cuh"])
def test_build_reruns_nvcc_when_a_source_or_header_is_newer(tmp_path, monkeypatch, newer):
    """A library older than one csrc file, a shared header included, is
    rebuilt: the build reaches for nvcc."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    lib = tmp_path / "libeal_kernels.so"
    lib.write_bytes(b"")
    os.utime(lib, (1000, 1000))
    for p in csrc.iterdir():
        os.utime(p, (500, 500))
    os.utime(csrc / newer, (2000, 2000))
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "LIB_PATH", lib)
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail(f"rebuilt for {newer}"))
    with pytest.raises(pytest.fail.Exception, match=f"rebuilt for {newer}"):
        kernels.build()


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


def _band_cases():
    rng = np.random.default_rng(5)
    K = 256
    banded = random_banded(rng, 3, K, 90)
    zero = np.zeros((2, K, 128), np.float32)
    zero[1] = random_banded(rng, 1, K, 40)[0]              # tile 0 all zero
    past_gen = random_banded(rng, 2, K, 60)
    past_gen[1, :, 70:] = 0.0                                # columns at or past gen
    edges = np.zeros((1, K, 128), np.float32)
    edges[0, 0, 3] = 1.0                                     # row 0, group 0
    edges[0, K - 1, 40] = -2.0                               # row K-1, group 1
    edges[0, 5:9, 100] = -0.0                                # -0.0 is empty (group 3)
    edges[0, 17, 70] = np.nan                                # NaN counts (group 2)
    return {"random_banded": banded, "zero_tile": zero, "past_gen": past_gen,
            "edges": edges}


@pytest.mark.parametrize("case", ["random_banded", "zero_tile", "past_gen", "edges", "stride0"])
def test_band_ranges_plain(case):
    """The band-range kernel's plain version against a per-column scan of
    ``Wt != 0``: first and last nonzero K-row per 32-column group, (K, -1)
    when a group is empty; one tile when the tile stride is 0."""
    cases = _band_cases()
    if case == "stride0":
        W = torch.from_numpy(cases["random_banded"][1])[None].expand(6, -1, -1)
        ref_tiles = cases["random_banded"][1:2]
    else:
        W = torch.from_numpy(cases[case])
        ref_tiles = cases[case]
    K = W.shape[1]
    got = pk.band_ranges(W).numpy()
    assert got.shape == (ref_tiles.shape[0], 128 // pk.GROUP, 2) and got.dtype == np.int32
    for i, tile in enumerate(ref_tiles):
        for grp in range(128 // pk.GROUP):
            rows = np.nonzero((tile[:, grp * pk.GROUP:(grp + 1) * pk.GROUP] != 0).any(1))[0]
            want = (rows[0], rows[-1]) if rows.size else (K, -1)
            assert tuple(got[i, grp]) == want, (i, grp)
    assert torch.equal(pk.band_ranges_cuda(W), pk.band_ranges(W))       # CPU routing
    if case == "edges":
        assert tuple(got[0, 0]) == (0, 0) and tuple(got[0, 1]) == (K - 1, K - 1)
        assert tuple(got[0, 2]) == (17, 17) and tuple(got[0, 3]) == (K, -1)


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: round the magnitude to 10
    mantissa bits, ties away from zero (finite inputs)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a: torch.Tensor):
    big = _tf32_rna(a)
    return big, _tf32_rna(a - big)


def emulate_3xtf32(xext: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The kernels' contraction as the card computes it: both operands split
    into TF32 big + small halves; per 8-row step, small*big + big*small +
    big*big summed from zero (TF32 products are exact; the step's sum is
    taken in f64 and rounded once, as the tensor core rounds its result)
    and added to an f32 accumulator with one round-to-nearest add per step.
    Returns f32 ``[M, nt * 128]``."""
    nt, K, _ = Wt.shape
    M, _ = xext.shape
    cols = starts.long()[:, None] + torch.arange(K)
    slabs = xext[:, cols].permute(1, 0, 2)                                  # [nt, M, K]
    ab, as_ = _split(slabs)
    bb, bs = _split(Wt.contiguous())
    acc = torch.zeros((nt, M, 128), dtype=torch.float32)
    for k in range(0, K, 8):
        sl = slice(k, k + 8)
        d = (torch.bmm(as_[..., sl].double(), bb[:, sl].double())
             + torch.bmm(ab[..., sl].double(), bs[:, sl].double())
             + torch.bmm(ab[..., sl].double(), bb[:, sl].double()))
        acc = acc + d.float()
    return acc.permute(1, 0, 2).reshape(M, nt * 128)


def _chunk_operands(batch: int, frames: int):
    """The first chunk's real contraction operands of a CPU Resampler at the
    slice's configuration (44.1 kHz -> 16 kHz stereo s16, 64 taps, 32
    filters): raw int16 slabs [M, L], weight tiles, starts, out_max, the
    PCM gain factor."""
    r = Resampler(batch=batch, exact=False, device="cpu")
    r.initialize(ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32))
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, frames * 4), dtype=np.uint8))
    out_max = math.ceil(frames * float(r.sample_ratio)) + 8
    (grid_t,), (gen,), _ = r._schedule(dataclasses.replace(r.phase), frames, out_max, 1)
    L = r._slab_len(frames)
    Wt, starts = tpoly.banded_weights_device(r._filters, r._direct, *grid_t, gen,
                                             K=r._K, taps_p=r._taps_p, L=L)
    raw = q.unpack_pcm16_planar2_raw(data)
    raw = torch.nn.functional.pad(torch.cat([torch.zeros_like(raw[..., :r.hist_len]), raw], -1),
                                  (0, L - r.hist_len - frames))
    return raw.reshape(-1, L).contiguous(), Wt, starts, out_max, float(q.gain_factor(16, 0.0))


def test_3xtf32_emulation_within_contract():
    """On a chunk's real operands (B = 8 streams), the 3xTF32 arithmetic of
    the kernels stays within the banded tolerance of the plain f32
    contraction, and within 1 LSB of it after the 16-bit quantize, both on
    the f32 path (x scaled) and on the fused int16 path (gain in Wt); plain
    one-pass TF32 does not hold the tolerance."""
    x2, Wt, starts, out_max, factor = _chunk_operands(8, 8192)
    xf = x2.float() * factor
    ref = tpoly.polyphase_banded(xf, Wt, starts, T=out_max)
    emu = emulate_3xtf32(xf, Wt, starts)[:, :out_max]
    torch.testing.assert_close(emu, ref, rtol=RTOL, atol=ATOL)
    s_e, _ = q.float_to_int(emu, 16)
    s_r, _ = q.float_to_int(ref, 16)
    assert (s_e.int() - s_r.int()).abs().max() <= 1

    Wf = Wt * factor
    s_p, c_p = pk.polyphase_fused16_plain(x2, Wf, starts)
    s_k, c_k = pk._quantize16(emulate_3xtf32(x2.float(), Wf, starts))
    d = (s_k.int() - s_p.int()).abs()
    assert d.max() <= 1
    assert torch.equal(c_k[d == 0], c_p[d == 0])

    one_pass = tpoly.polyphase_banded(_tf32_rna(xf), _tf32_rna(Wt.contiguous()), starts, T=out_max)
    assert not torch.allclose(one_pass, ref, rtol=RTOL, atol=ATOL)


def test_flac_frame_wrapper_routes_cpu_to_plain():
    """The shared fleet covers every case it names, and on the CPU the
    wrapper runs the plain version without launching."""
    buckets = fleet.fleet_buckets("cpu")
    assert fleet.missing(fleet.coverage(buckets)) == {}
    fk.reset_launch_counts()
    for _, arrays, kw in buckets:
        t, kwt = fleet.on_device(arrays, kw, "cpu")
        assert torch.equal(fk.flac_frame_cuda(*t, **kwt), fk.flac_frame_plain(*t, **kwt))
    assert fk.flac_frame_cuda.launches == 0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal f32 tensors bit for bit, except that any two NaNs match (the
    card and the CPU may give NaNs other payloads)."""
    a, b = a.float().cpu(), b.float().cpu()
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    keep = ~a.isnan()
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def exact_poly_operands(taps, nf, flags, ratio, M, n_in, n_out, lowpass=0.9, seed=0):
    """A real exact-mode chunk: filterbank, the phase grid of n_out outputs
    (entries past the generated count stay as the grid leaves them: mode 0,
    window 0) and random history + chunk rows."""
    from esp_audio_libs_tpu_torch.ops import sinc
    from esp_audio_libs_tpu_torch.runtime.native import design_filterbank_native
    lp, fl = sinc.normalize_lowpass(lowpass, flags)
    filters = torch.as_tensor(np.asarray(design_filterbank_native(taps, nf, float(lp), fl),
                                         np.float32))
    g = phase_grid(PhaseState.initial(taps), nf, fl, ratio, n_in, n_out)
    hist = taps + HISTORY_MARGIN
    grid = [torch.as_tensor(a) for a in (g.win0 + hist, g.idx1, g.idx2, g.weight,
                                          g.mode.astype(np.int32))]
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal((M, hist + n_in)),
                        dtype=torch.float32)
    return x, filters, grid, bool(fl & sinc.SUBSAMPLE_INTERPOLATE)


def test_exact_wrappers_route_cpu_to_plain():
    """On CPU tensors the exact-mode wrappers run their plain versions and
    launch nothing."""
    bk.reset_launch_counts()
    pk.reset_launch_counts()
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((3, 2, 300)), dtype=torch.float32)
    c = torch.as_tensor(tbq.biquad_init(tbq.biquad_lowpass(0.2), 1.0))
    st = tuple(torch.as_tensor(rng.standard_normal((3, 2)), dtype=torch.float32)
               for _ in range(4))
    for first, vl in ((False, None), (True, 120)):
        y, s = bk.biquad_df1_cuda(x, c, st, first_order=first, valid_len=vl)
        y_p, s_p = bk.biquad_df1_plain(x, c, st, first_order=first, valid_len=vl)
        assert same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(s, s_p))
    p1, p2 = torch.full((3, 2), -1.2), torch.full((3, 2), 0.4)
    y, s = bk.iir2_sequential_cuda(x, p1, p2, st[0], st[1])
    assert same_bits(y, bk.iir2_sequential_plain(x, p1, p2, st[0], st[1])[0])
    xe, fb, grid, second = exact_poly_operands(64, 16, 1, 16000 / 44100, 5, 300, 200)
    assert same_bits(pk.polyphase_exact_cuda(xe, fb, *grid, half=32, compute_second=second),
                     pk.polyphase_exact_plain(xe, fb, *grid, half=32, compute_second=second))
    assert bk.biquad_df1_cuda.launches == bk.iir2_sequential_cuda.launches == 0
    assert pk.polyphase_exact_cuda.launches == 0


def test_dotprod_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    rng = np.random.default_rng(8)
    a = torch.as_tensor(rng.standard_normal((3, 5, 70)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((5, 70)), dtype=torch.float32)
    dk.reset_launch_counts()
    assert same_bits(dk.dotprod_exact_cuda(a, b), dk.dotprod_exact_plain(a, b))
    assert same_bits(dsp.dotprod_f32(a, b), dk.dotprod_exact_plain(a, b))
    assert dk.dotprod_exact_cuda.launches == 0
    with pytest.raises(ValueError, match="device"):
        dk.dotprod_exact_cuda(torch.zeros((2, 8), device="meta"), torch.zeros(8, device="meta"))


def test_exact_wrappers_refuse_other_devices():
    x = torch.zeros((2, 64), device="meta")
    z = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="device"):
        bk.biquad_df1_cuda(x, torch.zeros(5, device="meta"), (z, z, z, z))
    with pytest.raises(ValueError, match="device"):
        bk.iir2_sequential_cuda(x, z, z, z, z)
    g = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        pk.polyphase_exact_cuda(x, torch.zeros((3, 16), device="meta"), g, g, g,
                                torch.zeros(8, device="meta"), g, half=8)


def test_plain_biquad_rounds_each_op():
    """The plain DF-I rounds each product and sum on its own: on random
    data it differs from the same recurrence with the x-side multiply-adds
    fused (what an FMA-contracting build would give), and equals an f64
    emulation of separately rounded f32 ops."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 400)).astype(np.float32)
    c = tbq.biquad_init(tbq.biquad_lowpass(0.11), 1.0).astype(np.float64)
    y, _ = bk.biquad_df1_plain(torch.from_numpy(x), torch.from_numpy(c.astype(np.float32)),
                               tuple(torch.zeros(4) for _ in range(4)))
    r = lambda v: v.astype(np.float32).astype(np.float64)          # one f32 rounding
    sep, fused = [np.zeros(4) for _ in range(2)], [np.zeros(4) for _ in range(2)]
    i = [np.zeros(4), np.zeros(4)]
    want, want_fma = [], []
    for t in range(x.shape[1]):
        xv = x[:, t].astype(np.float64)
        acc = r(r(r(xv * c[0]) + r(i[0] * c[1])) + r(i[1] * c[2]))
        v = r(r(acc - r(c[3] * sep[0])) - r(c[4] * sep[1]))
        acc_f = r(r(xv * c[0] + i[0] * c[1]) + i[1] * c[2])
        vf = r(r(acc_f - c[3] * fused[0]) - c[4] * fused[1])
        want.append(v)
        want_fma.append(vf)
        sep, fused, i = [v, sep[0]], [vf, fused[0]], [xv, i[0]]
    want = np.stack(want, -1).astype(np.float32)
    assert np.array_equal(y.numpy().view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(want, np.stack(want_fma, -1).astype(np.float32))


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,nt,K,step", [
    (4096, 8576, 24, 768, 359),       # 44.1k -> 16k main contraction
    (512, 23296, 177, 512, 128),      # 16k -> 44.1k post-filter conv
    (37, 2100, 6, 512, 310),          # ragged rows, unaligned starts
    (5, 2100, 6, 512, 301)])          # fewer rows than one warp's fragment
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_banded", "zero_tile", "past_gen", "edges", "stride0"])
def test_band_ranges_kernel_matches_plain(cuda, case):
    cases = _band_cases()
    if case == "stride0":
        W = torch.from_numpy(cases["random_banded"][1]).to(cuda)[None].expand(6, -1, -1)
    else:
        W = torch.from_numpy(cases[case]).to(cuda)
    got = pk.band_ranges_cuda(W)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.band_ranges(W))


@pytest.mark.cuda
def test_banded_kernel_nan_weight_in_band_reaches_output(cuda):
    rng = np.random.default_rng(3)
    M, L, nt, K = 40, 1024, 3, 512
    x = torch.from_numpy(rng.standard_normal((M, L)).astype(np.float32)).to(cuda)
    Wt = torch.from_numpy(random_banded(rng, nt, K, 200)).to(cuda)
    col = Wt[1, :, 77]
    k = int(torch.nonzero(col)[5])
    Wt[1, k, 77] = float("nan")
    starts = torch.tensor([0, 200, 400], dtype=torch.int32, device=cuda)
    got = pk.polyphase_banded_cuda(x, Wt, starts, T=nt * 128)
    torch.cuda.synchronize()
    assert torch.isnan(got[:, 128 + 77]).all()
    finite = torch.ones_like(got, dtype=torch.bool)
    finite[:, 128 + 77] = False
    assert torch.isfinite(got[finite]).all()


@pytest.mark.cuda
def test_kernels_all_zero_tile_gives_zeros(cuda):
    rng = np.random.default_rng(4)
    M, L, nt, K = 300, 2048, 4, 512
    Wt = torch.from_numpy(random_banded(rng, nt, K, 150)).to(cuda)
    Wt[2] = 0.0
    starts = torch.tensor([0, 300, 600, 900], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(rng.standard_normal((M, L)).astype(np.float32)).to(cuda)
    y = pk.polyphase_banded_cuda(x, Wt, starts, T=nt * 128)
    x16 = torch.from_numpy(rng.integers(-32768, 32768, (M, L), dtype=np.int16)).to(cuda)
    s16, clip = pk.polyphase_fused16_cuda(x16, Wt * (1.0 / 32768.0), starts)
    torch.cuda.synchronize()
    assert not y[:, 256:384].any() and y[:, :256].abs().sum() > 0
    assert not s16[:, 256:384].any() and not clip[:, 256:384].any()


@pytest.mark.cuda
def test_fused16_kernel_main_shape(cuda):
    """M = 4096 rows, L = 8576, 24 tiles of K = 768 with 318-tap bands."""
    rng = np.random.default_rng(16)
    M, L, nt, K = 4096, 8576, 24, 768
    x = torch.from_numpy(rng.integers(-32768, 32768, (M, L), dtype=np.int16)).to(cuda)
    Wt = torch.from_numpy(random_banded(rng, nt, K, 318) * np.float32(0.05 / 32768.0)).to(cuda)
    starts = torch.from_numpy(np.minimum(np.arange(nt) * 359, L - K).astype(np.int32)).to(cuda)
    s_k, c_k = pk.polyphase_fused16_cuda(x, Wt, starts)
    torch.cuda.synchronize()
    s_p, c_p = pk.polyphase_fused16_plain(x, Wt, starts)
    d = (s_k.int() - s_p.int()).abs()
    assert int(d.max()) <= 1
    assert torch.equal(c_k[d == 0], c_p[d == 0])
    assert 0 < int(c_p.sum()) < c_p.numel()            # both clipped and unclipped samples


@pytest.mark.cuda
def test_kernels_refuse_unaligned_row_pitch(cuda):
    W = torch.zeros((2, 512, 128), device=cuda)
    s = torch.tensor([0, 128], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        pk.polyphase_banded_cuda(torch.zeros((8, 1027), device=cuda), W, s, T=256)
    with pytest.raises(ValueError, match="16 bytes"):
        pk.polyphase_fused16_cuda(torch.zeros((8, 1028), dtype=torch.int16, device=cuda), W, s)


@pytest.mark.cuda
def test_flac_frame_kernel_matches_plain(cuda):
    """Each real bucket of the shared fleet in every specialisation it can
    take (order class, accumulator, plane width, escape tier):
    byte-identical to the plain version."""
    for bkey, arrays, kw in fleet.fleet_buckets(cuda):
        t, kwt = fleet.on_device(arrays, kw, cuda)
        want = fk.flac_frame_plain(*t, **kwt)
        for label, plane, esc, kwv in fleet.kernel_variants(arrays, kw):
            extra = {} if esc is None else dict(zip(("esc_pos", "esc_val"),
                                                    fleet.on_device(esc, {}, cuda)[0]))
            before = fk.flac_frame_cuda.launches
            got = fk.flac_frame_cuda(torch.as_tensor(plane, device=cuda), *t[1:], **kwv, **extra)
            torch.cuda.synchronize()
            assert fk.flac_frame_cuda.launches == before + 1
            assert torch.equal(got, want), (bkey, label)


def synthetic_frames(seed, F, C, T, W, big=False):
    """Frame-kernel operands [F, C, T] with orders 0..W (order T where T <=
    W), shifts including -1, 33 and 70, wasted bits including 33 (all
    shifted out), every stereo channel assignment, and residuals that fit
    int8 except at the first and last sample of each row, at tile edges
    (63, 64, 65, 95, 96, 97, 127, 128) and at random places: the escapes of
    the int8 tier. ``big``: int32 residuals of up to 2^24 and coefficients of
    up to 2^14, whose dots overflow int32."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-100, 100, (F, C, T)).astype(np.int32)
    edges = [t for t in (0, 63, 64, 65, 95, 96, 97, 127, 128, T - 1) if t < T]
    data[..., edges] = rng.integers(-30000, 30000, (F, C, len(edges)))
    data[rng.random((F, C, T)) < 0.01] = 1000
    if big:
        data = rng.integers(-(1 << 24), 1 << 24, (F, C, T)).astype(np.int32)
    order = rng.integers(0, W + 1, (F, C)).astype(np.int32)
    order.reshape(-1)[:3] = (W, 0, min(W, T))
    cmax = 1 << 14 if big else 1 << 9
    coeffs = np.zeros((F, C, 32), np.int32)
    for f in range(F):
        for c in range(C):
            coeffs[f, c, :order[f, c]] = rng.integers(-cmax, cmax, order[f, c])
    shift = rng.integers(0, 14, (F, C)).astype(np.int32)
    shift.reshape(-1)[-3:] = (-1, 33, 70)
    wasted = rng.integers(0, 3, (F, C)).astype(np.int32)
    wasted.reshape(-1)[-1] = 33
    ca = (rng.choice([0, 1, 8, 9, 10], F) if C == 2 else np.full(F, C - 1)).astype(np.int32)
    return data, coeffs, order, shift, wasted, ca


def _frame_planes(data, device):
    """The residual plane as int8 + escape sideband, int16 and int32 (the
    first two only where the values fit int16)."""
    out = [("int32", torch.as_tensor(data, device=device), {})]
    if np.abs(data).max() < 32768:
        narrow = data.astype(np.int8)
        (pos,), (val,) = transport.escape_sideband_blocked(
            (narrow != data).reshape(1, -1), data.reshape(1, -1), np.int32)
        esc = {"esc_pos": torch.as_tensor(pos, device=device),
               "esc_val": torch.as_tensor(val, device=device)}
        out += [("int8+esc", torch.as_tensor(narrow, device=device), esc),
                ("int16", torch.as_tensor(data.astype(np.int16), device=device), {})]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("W", fk.ORDER_CLASSES)
def test_flac_frame_kernel_synthetic(cuda, W, C):
    """Every order class and accumulator, 1/2/3/8 channels, frames not a
    multiple of a group's (3 groups and one frame), rows of 16-byte
    multiples and not (T = 1024, 1000), int8 + escapes, int16 and int32
    planes, and int32 overflow: byte-identical to the plain version."""
    F = 3 * (32 // C) + 1
    for T, big in ((1024, False), (1000, False), (1000, True)):
        arrays = synthetic_frames(W * 10 + C + T + big, F, C, T, W, big=big)
        params = [torch.as_tensor(a, device=cuda) for a in arrays[1:]]
        for use64 in (False, True):
            kw = dict(depth=16, nch=C, mode32=C == 3, use64=use64, max_order=W)
            want = fk.flac_frame_plain(torch.as_tensor(arrays[0], device=cuda), *params, **kw)
            for label, plane, esc in _frame_planes(arrays[0], cuda):
                before = fk.flac_frame_cuda.launches
                got = fk.flac_frame_cuda(plane, *params, **kw, **esc)
                torch.cuda.synchronize()
                assert fk.flac_frame_cuda.launches == before + 1
                assert torch.equal(got, want), (T, big, use64, label)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [512, 4096])
def test_flac_frame_kernel_dispatch_shape(cuda, F):
    """The composed chain's launches: a dispatch of 512 frames and the whole
    4096-frame bucket, stereo 16-bit, 4096 steps, int8 + escapes (and the
    int16 and int32 planes they stand for), order class 8, the 32-bit
    accumulator."""
    arrays = synthetic_frames(F, F, 2, 4096, 8)
    params = [torch.as_tensor(a, device=cuda) for a in arrays[1:]]
    kw = dict(depth=16, nch=2, mode32=False, use64=False, max_order=8)
    want = fk.flac_frame_plain(torch.as_tensor(arrays[0], device=cuda), *params, **kw)
    for label, plane, esc in _frame_planes(arrays[0], cuda):
        got = fk.flac_frame_cuda(plane, *params, **kw, **esc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label


@pytest.mark.parametrize("table", ["VARIANTS", "BIQUAD_VARIANTS", "EXACT_VARIANTS",
                                   "FLAC_VARIANTS", "MP3_VARIANTS", "DOT_VARIANTS",
                                   "MP3F32_VARIANTS", "MXU_PRE_VARIANTS", "MXU_POST_VARIANTS",
                                   "QUANT16_VARIANTS"])
def test_kernel_variant_edits_apply(tmp_path, monkeypatch, table):
    """Every text edit of tools/kernel_variants.py still matches the
    sources it edits exactly once (the tool stops on the card otherwise)."""
    import kernel_variants as kv
    monkeypatch.setattr(kv, "OUT", tmp_path)
    target = {"VARIANTS": "banded_tile.cuh", "BIQUAD_VARIANTS": "biquad_exact.cu",
              "EXACT_VARIANTS": "polyphase_exact.cu", "FLAC_VARIANTS": "flac_frame.cu",
              "MP3_VARIANTS": "mp3_granules.cu", "DOT_VARIANTS": "dotprod_exact.cu",
              "MP3F32_VARIANTS": "mp3_granules_f32.cu",
              "MXU_PRE_VARIANTS": "mp3_mxu_step.cu", "MXU_POST_VARIANTS": "mp3_mxu_step.cu",
              "QUANT16_VARIANTS": "pcm_quantize16.cu"}[table]
    sources = sorted(kernels.CSRC.glob("*.cu*"))
    for name, edits in getattr(kv, table).items():
        assert (kv.make_variant(name, target, edits, sources) / target).exists()


@pytest.mark.cuda
def test_flac_frame_kernel_refuses_bad_arguments(cuda):
    data = torch.zeros((1, 2, 64), dtype=torch.int16, device=cuda)
    params = [torch.zeros(s, dtype=torch.int32, device=cuda)
              for s in ((1, 2, 32), (1, 2), (1, 2), (1, 2), (1,))]
    with pytest.raises(ValueError, match="max_order"):
        fk.flac_frame_cuda(data, *params, depth=16, nch=2, mode32=False, max_order=7)
    with pytest.raises(ValueError, match="int8"):
        fk.flac_frame_cuda(data, *params, depth=16, nch=2, mode32=False, max_order=8,
                           esc_pos=params[-1], esc_val=params[-1])
    with pytest.raises(ValueError, match="coeffs"):
        fk.flac_frame_cuda(data, params[1], *params[1:], depth=16, nch=2, mode32=False,
                           max_order=8)


@pytest.mark.cuda
@pytest.mark.parametrize("first_order,valid_len,per_lane", [
    (False, None, False), (True, None, False), (False, 0, False), (False, 1, True),
    (False, 777, False), (True, 64, True), (False, 1000, False)])
def test_biquad_kernel_matches_plain(cuda, first_order, valid_len, per_lane):
    """37 lanes (a ragged warp), T = 1000 (a ragged tile), random state."""
    rng = np.random.default_rng(31 + (valid_len or 0))
    x = torch.as_tensor(rng.standard_normal((37, 1000)), dtype=torch.float32, device=cuda)
    if per_lane:
        c = np.stack([tbq.biquad_init(tbq.biquad_highpass(f), 1.0)
                      for f in rng.uniform(0.02, 0.45, 37)])
    elif first_order:
        c = np.array([0.3, 0.3, 0.0, -0.4, 0.0], np.float32)
    else:
        c = tbq.biquad_init(tbq.biquad_lowpass(0.18), 1.0)
    c = torch.as_tensor(c, device=cuda)
    st = tuple(torch.as_tensor(rng.standard_normal(37), dtype=torch.float32, device=cuda)
               for _ in range(4))
    before = bk.biquad_df1_cuda.launches
    y, s = bk.biquad_df1_cuda(x, c, st, first_order=first_order, valid_len=valid_len)
    torch.cuda.synchronize()
    assert bk.biquad_df1_cuda.launches == before + 1
    y_p, s_p = bk.biquad_df1_plain(x, c, st, first_order=first_order, valid_len=valid_len)
    assert same_bits(y, y_p)
    assert all(same_bits(a, b) for a, b in zip(s, s_p))


@pytest.mark.cuda
def test_biquad_kernel_subnormals_nan_inf(cuda):
    """A burst then silence (the tail decays through the subnormal range
    and flushes), subnormal inputs and state (taken as zeros by the math,
    carried as bits), and NaN / inf inputs: the kernel equals the plain
    version, and no output is subnormal."""
    x = torch.zeros((64, 700), device=cuda)
    x[:, :8] = torch.as_tensor(np.random.default_rng(2).standard_normal((64, 8)) * 1e-30,
                               dtype=torch.float32, device=cuda)
    x[5, 300] = 1e-39
    x[6, 400] = -3e-45
    x[7, 100] = float("nan")
    x[8, 200] = float("inf")
    x[9, 250] = -float("inf")
    st = [torch.zeros(64, device=cuda) for _ in range(4)]
    st[0][10] = 1e-39
    st[2][11] = -1e-39
    c = torch.as_tensor(tbq.biquad_init(tbq.biquad_lowpass(0.18), 1.0), device=cuda)
    y, s = bk.biquad_df1_cuda(x, c, tuple(st))
    y_p, s_p = bk.biquad_df1_plain(x, c, tuple(st))
    torch.cuda.synchronize()
    assert same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(s, s_p))
    fin = y[y.isfinite()]
    assert not ((fin != 0) & (fin.abs() < 2.0 ** -126)).any()
    assert y[7, 100:].isnan().all() and (y[:12, -20:][:7] == 0).all()


@pytest.mark.cuda
def test_iir2_kernel_matches_plain(cuda):
    rng = np.random.default_rng(41)
    f = torch.as_tensor(rng.standard_normal((45, 530)), dtype=torch.float32, device=cuda)
    f[3, 17] = float("nan")
    f[4, 10:] = 0.0
    p1 = torch.as_tensor(rng.uniform(-1.5, 1.5, 45), dtype=torch.float32, device=cuda)
    p2 = torch.as_tensor(rng.uniform(0.1, 0.7, 45), dtype=torch.float32, device=cuda)
    y1, y2 = (torch.as_tensor(rng.standard_normal(45), dtype=torch.float32, device=cuda)
              for _ in range(2))
    before = bk.iir2_sequential_cuda.launches
    y, (a, b) = bk.iir2_sequential_cuda(f, p1, p2, y1, y2)
    torch.cuda.synchronize()
    assert bk.iir2_sequential_cuda.launches == before + 1
    y_p, (a_p, b_p) = bk.iir2_sequential_plain(f, p1, p2, y1, y2)
    assert same_bits(y, y_p) and same_bits(a, a_p) and same_bits(b, b_p)


def _misaligned(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a contiguous f32 tensor whose data starts 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(a.size + 4, dtype=torch.float32, device=device)
    t = buf[1:1 + a.size].view(a.shape)
    t.copy_(torch.from_numpy(a))
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,T,valid_len,first_order,misaligned", [
    (1, 8192, None, False, False),     # one lane: a block with 31 empty rows
    (31, 1000, None, False, False),
    (33, 1000, 500, True, False),      # one lane into a second block
    (4096, 8192, None, False, False),  # the main pre-filter chunk's lanes
    (40, 1, None, False, False), (40, 1, 0, False, False), (40, 1, 1, True, False),
    (40, 63, None, False, False), (40, 64, None, False, False), (40, 65, None, False, False),
    (40, 130, None, False, False),
    (40, 130, 64, False, False), (40, 130, 128, False, False),   # valid_len at a tile edge
    (40, 130, 63, True, False), (40, 130, 65, False, False),
    (40, 128, None, False, False), (40, 129, 128, False, False),  # one 128-step tile, and one more
    (40, 256, 128, True, False), (40, 260, 256, False, False),
    (40, 1001, 1000, False, False),    # a row pitch that is not a multiple of 16 bytes
    (40, 1000, 999, False, True)])     # 16-byte pitch, data 4 bytes off alignment
def test_biquad_kernel_shapes_and_edges(cuda, lanes, T, valid_len, first_order, misaligned):
    """Lane counts around a block, T around the 64- and 128-step tile sizes,
    valid_len at and around tile edges, both copy paths (bulk copies of
    16-byte rows, 4-byte copies otherwise): bit-identical to the plain
    version."""
    rng = np.random.default_rng(lanes * 7919 + T)
    xn = rng.standard_normal((lanes, T)).astype(np.float32)
    x = _misaligned(xn, cuda) if misaligned else torch.from_numpy(xn).to(cuda)
    c = torch.as_tensor(np.array([0.3, 0.3, 0.0, -0.4, 0.0], np.float32) if first_order
                        else tbq.biquad_init(tbq.biquad_lowpass(0.18), 1.0), device=cuda)
    st = tuple(torch.as_tensor(rng.standard_normal(lanes), dtype=torch.float32, device=cuda)
               for _ in range(4))
    before = bk.biquad_df1_cuda.launches
    y, s = bk.biquad_df1_cuda(x, c, st, first_order=first_order, valid_len=valid_len)
    torch.cuda.synchronize()
    assert bk.biquad_df1_cuda.launches == before + 1
    y_p, s_p = bk.biquad_df1_plain(x, c, st, first_order=first_order, valid_len=valid_len)
    assert same_bits(y, y_p)
    assert all(same_bits(a, b) for a, b in zip(s, s_p))


@pytest.mark.cuda
def test_biquad_kernel_upsampling_post_filter_shape(cuda):
    """The exact upsampling post-filter's launch: 16 kHz -> 44.1 kHz at
    batch 256, [256, 2, out_max] with valid_len = the first chunk's
    generated count, the resampler's own coefficients."""
    r = Resampler(batch=256, device="cpu")
    r.initialize(ResamplerConfiguration(16000.0, 44100.0, 16, 16, 2, True, True, 64, 32))
    frames = 8192
    out_max = math.ceil(frames * float(r.sample_ratio)) + 8
    g = phase_grid(dataclasses.replace(r.phase), r.config.number_of_filters, r.bank_flags,
                   r.sample_ratio, frames, out_max)
    assert r.post_filter and out_max % 4 == 0 and 0 < g.output_generated < out_max
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.standard_normal((256, 2, out_max)) * 0.3, dtype=torch.float32,
                        device=cuda)
    st = tuple(torch.zeros((256, 2), device=cuda) for _ in range(4))
    c = r._coeffs_dev.to(cuda)
    y, s = bk.biquad_df1_cuda(x, c, st, valid_len=g.output_generated)
    torch.cuda.synchronize()
    y_p, s_p = bk.biquad_df1_plain(x, c, st, valid_len=g.output_generated)
    assert same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(s, s_p))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,T", [(33, 65), (5, 1001), (1, 130), (70, 64)])
def test_iir2_kernel_ragged(cuda, lanes, T):
    """iir2 at ragged lane counts and lengths (1001: the 4-byte copies)."""
    rng = np.random.default_rng(lanes + T)
    f = torch.as_tensor(rng.standard_normal((lanes, T)), dtype=torch.float32, device=cuda)
    p1 = torch.as_tensor(rng.uniform(-1.5, 1.5, lanes), dtype=torch.float32, device=cuda)
    p2 = torch.as_tensor(rng.uniform(0.1, 0.7, lanes), dtype=torch.float32, device=cuda)
    y1, y2 = (torch.as_tensor(rng.standard_normal(lanes), dtype=torch.float32, device=cuda)
              for _ in range(2))
    y, (a, b) = bk.iir2_sequential_cuda(f, p1, p2, y1, y2)
    torch.cuda.synchronize()
    y_p, (a_p, b_p) = bk.iir2_sequential_plain(f, p1, p2, y1, y2)
    assert same_bits(y, y_p) and same_bits(a, a_p) and same_bits(b, b_p)


def _windows_off_both_ends(x, grid):
    """The schedule with the first outputs' windows moved before x[0] and
    the last ones' past x[L-1] (all as one-dot or lerp outputs), so that
    they read NaN at both ends."""
    win, i1, i2, w, mode = (g.clone() for g in grid)
    L, n = x.shape[-1], win.shape[0]
    win[:40] -= win[0] + 200                 # windows from -200 on, some wholly before x
    win[n - 40:] = L - 30 + torch.arange(40, dtype=win.dtype)
    mode[:40] = mode[n - 40:] = 2
    mode[:20:3] = mode[n - 20::3] = 1
    return [win, i1, i2, w, mode]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "no_second", "ragged", "upsample", "low_ratio",
                                  "big_bank", "past_gen", "rows_1", "rows_13", "rows_4097",
                                  "T_1", "T_129", "odd_pitch", "misaligned", "nan_both_ends",
                                  "low_ratio_rows_35", "upsample_full"])
def test_polyphase_exact_kernel_matches_plain(cuda, case):
    """Real schedules: the slice's configuration (64 taps, 32 filters,
    interpolation), without the second dot, a ragged row and output count,
    upsampling (windows advance by 0 or 1), a ratio whose tile spans more
    than one staged fill, a filterbank too large for shared memory, and the
    padded mode-0 outputs past a chunk's generated count whose windows run
    past the input. Then the redesign's edges: row counts that leave a
    partial work item (1, 13, 4097: more work items than resident blocks),
    output counts around the 128-output tile (1, 129), rows whose pitch
    (odd) or base (4 bytes off) is not 16-byte aligned (the 4-byte copy
    path), windows off both ends of the input (NaN), the multi-fill low
    ratio over rows that fill two items of 16 and part of a third, and the
    exact upsampling chunk at full width (16 -> 44.1 kHz at batch 256)."""
    from esp_audio_libs_tpu_torch.ops import sinc
    interp = sinc.SUBSAMPLE_INTERPOLATE | sinc.BLACKMAN_HARRIS
    down = 16000 / 44100
    args = {"main": (64, 32, interp, down, 64, 2048, 743),
            "no_second": (64, 32, sinc.BLACKMAN_HARRIS, down, 64, 2048, 743),
            "ragged": (16, 8, interp, 0.5, 13, 1000, 501),
            "upsample": (64, 32, interp, 44100 / 16000, 24, 512, 1411),
            "low_ratio": (64, 32, interp, 0.05, 16, 8192, 400),
            "big_bank": (1024, 256, interp, 0.5, 9, 3000, 1000),
            "past_gen": (64, 32, interp, down, 10, 40, 300),
            "rows_1": (64, 32, interp, down, 1, 2048, 743),
            "rows_13": (64, 32, interp, down, 13, 2048, 743),
            "rows_4097": (64, 32, interp, down, 4097, 512, 129),
            "T_1": (64, 32, interp, down, 20, 512, 1),
            "T_129": (64, 32, interp, down, 20, 512, 129),
            "odd_pitch": (64, 32, interp, down, 20, 1001, 300),
            "misaligned": (64, 32, interp, down, 20, 1000, 300),
            "nan_both_ends": (64, 32, interp, down, 20, 2048, 743),
            "low_ratio_rows_35": (64, 32, interp, 0.05, 35, 8192, 400),
            "upsample_full": (64, 32, interp, 44100 / 16000, 512, 8192, 22588)}[case]
    taps = args[0]
    x, fb, grid, second = exact_poly_operands(*args[:4], M=args[4], n_in=args[5], n_out=args[6])
    if case == "odd_pitch":
        assert x.shape[-1] % 2 == 1
    if case == "nan_both_ends":
        grid = _windows_off_both_ends(x, grid)
    x = _misaligned(x.numpy(), cuda) if case == "misaligned" else x.to(cuda)
    fb, grid = fb.to(cuda), [g.to(cuda) for g in grid]
    before = pk.polyphase_exact_cuda.launches
    got = pk.polyphase_exact_cuda(x, fb, *grid, half=taps // 2, compute_second=second)
    torch.cuda.synchronize()
    assert pk.polyphase_exact_cuda.launches == before + 1
    want = pk.polyphase_exact_plain(x, fb, *grid, half=taps // 2, compute_second=second)
    assert same_bits(got, want)
    if case == "main":
        assert {0, 1, 2} >= set(grid[4].tolist()) and (grid[4] == 2).any()
    if case == "nan_both_ends":
        assert got[:, :40].isnan().all() and got[:, -40:].isnan().all()
        assert not got[:, 40:-40].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_exact_resampler_on_card_equals_cpu(cuda, src, dst):
    """Exact mode on the card and on the CPU: every output byte, count and
    state bit equal."""
    cfg = ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32)
    B, frames, n = 8, 2048, 3
    data = np.random.default_rng(2).integers(0, 256, (B, n * frames * 4), dtype=np.uint8)
    outs = []
    for dev in (cuda, "cpu"):
        r = Resampler(batch=B, device=dev)
        r.initialize(cfg)
        outs.append((*r.resample_stream(data, frames, n), r.get_state()))
    (pg, gg, cg, sg), (pc, gc, cc, sc) = outs
    assert gg == gc and np.array_equal(cg, cc)
    assert torch.equal(pg.cpu(), pc)
    np.testing.assert_array_equal(sg["history"].view(np.uint32), sc["history"].view(np.uint32))
    for a_stage, b_stage in zip(sg["biquad"], sc["biquad"]):
        for a, b in zip(a_stage, b_stage):
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# ------------------------------------------------------------------ MP3

# the batched-decoder formats plus intensity stereo, MPEG-1 (with mid-side)
# and MPEG-2
MP3_CFGS = mf.BATCH_CFGS + [dict(ver_bits=3, bitrate_idx=9, sr_idx=1, mode=1, mode_ext=3),
                            dict(ver_bits=2, bitrate_idx=7, sr_idx=1, mode=1, mode_ext=1)]


def mp3_runs(cfg, B, n_frames, fuzz, seed, n_runs=2):
    """Real parsed runs of B mixed streams of one format (tools/mp3frames.py):
    ``n_runs`` consecutive runs of ``n_frames`` frames, each a list of
    (fmt, vindex, streams, huff_gs, side_gs) per format group. The FIFO
    phase of a run follows the granules of the run before."""
    bat = BatchedMP3Decoder(B, device="cpu")
    streams = [mf.mixed_stream(cfg, seed + i, n_frames * n_runs, fuzz=fuzz) for i in range(B)]
    runs = []
    for r in range(n_runs):
        # frames of one format have one size: run r starts at frame r * n_frames
        run = list(parsed_runs(bat, [s[len(s) * r // n_runs:] for s in streams], n_frames))
        for _, vindex, ids, huff_gs, _ in run:
            for s in ids:
                bat._vindex[s] = mp3_pipeline._advance_vindex(vindex, huff_gs.shape[0])
        runs.append(run)
    return runs


def check_mp3_kernel(fmt, vindex, huff_gs, side_gs, state, dev, label):
    """One launch against the plain version on the same CUDA tensors; returns
    the kernel's new state."""
    ver, sr_idx, nch, cutoff = fmt
    h = torch.as_tensor(huff_gs, device=dev)
    sd = torch.as_tensor(side_gs, device=dev)
    kw = dict(ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    got = mk.mp3_granules_cuda(h, sd, *state, vindex, **kw)
    want = mk.mp3_granules_plain(h, sd, *state, vindex, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), f"{label}: PCM differs in {(got[0] != want[0]).sum()}"
    for name, a, b in zip(("over", "prev_type", "prev_win_switch", "num_prev", "vbuf"),
                          got[1], want[1]):
        assert torch.equal(a, b), f"{label}: {name} differs"
    assert torch.equal(got[2], want[2]), f"{label}: ref_undef differs"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_i", range(len(MP3_CFGS)))
@pytest.mark.parametrize("B,n_frames,fuzz", [(5, 8, False), (3, 1, False), (7, 4, True)])
def test_mp3_granules_kernel_matches_plain(cuda, cfg_i, B, n_frames, fuzz):
    """Every block type (tonal and window-type frames in turn, so nonzero
    overlap meets each window), both FIFO parities, G = 1 (MPEG-2 one
    frame; fuzz runs cut short by an error frame), 2 and 16, B = 3, 5, 7;
    the state of the first run carries into the second."""
    cfg = MP3_CFGS[cfg_i]
    gen = torch.Generator().manual_seed(cfg_i)
    seen, state = set(), None
    for r_i, run in enumerate(mp3_runs(cfg, B, n_frames, fuzz, 100 * cfg_i + B)):
        for fmt, vindex, ids, huff_gs, side_gs in run:
            if state is None or len(ids) != state[0].shape[0]:
                # a group of its own: zero state, or random state after run 0
                scale = 0 if state is None else 1
                n = len(ids)
                state = tuple(t.to(cuda) for t in (
                    torch.randint(-2 ** 20, 2 ** 20, (n, 2, 288), generator=gen,
                                  dtype=torch.int32) * scale,
                    torch.randint(0, 4, (n, 2), generator=gen, dtype=torch.int32) * scale,
                    torch.zeros((n, 2), dtype=torch.int32),
                    torch.randint(0, 33, (n, 2), generator=gen, dtype=torch.int32) * scale,
                    torch.randint(-2 ** 24, 2 ** 24, (n, 2176), generator=gen,
                                  dtype=torch.int32) * scale))
            state = check_mp3_kernel(fmt, vindex, huff_gs, side_gs, state, cuda,
                                     f"run {r_i} G={huff_gs.shape[0]} B={len(ids)} v={vindex}")[1]
            seen.add(huff_gs.shape[0])
    assert seen


@pytest.mark.cuda
def test_mp3_granules_kernel_escape_tier(cuda, monkeypatch):
    """The int8 + escape-sideband transport (widen and scatter on the card,
    then one launch) gives the int16 plane's bytes; fuzz spectra carry
    escapes."""
    cfg = mf.BATCH_CFGS[1]
    streams = [mf.fuzz_stream(cfg, 700 + i, 4) for i in range(6)]
    for fmt, vindex, ids, huff_gs, side_gs in parsed_runs(
            BatchedMP3Decoder(6, device="cpu"), streams, 4):
        monkeypatch.setattr(mp3_pipeline, "ESC_MAX_DENSITY", 1.0)
        narrowed = mp3_pipeline._pack_huff8(huff_gs)
        assert narrowed is not None
        plane8, pos, val = (torch.as_tensor(a, device=cuda) for a in narrowed)
        state = tuple(torch.zeros(s, dtype=torch.int32, device=cuda)
                      for s in ((len(ids), 2, 288), (len(ids), 2), (len(ids), 2), (len(ids), 2),
                                (len(ids), 2176)))
        sd = torch.as_tensor(side_gs, device=cuda)
        got = mp3_pipeline._granules_scan_esc_for(*fmt)(plane8, pos, val, sd, *state, vindex)
        want = mk.mp3_granules_plain(torch.as_tensor(huff_gs, device=cuda), sd, *state, vindex,
                                     ver=fmt[0], sr_idx=fmt[1], nch=fmt[2], cutoff=fmt[3])
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_mp3_batched_decoder_on_card_equals_cpu(cuda, monkeypatch):
    """decode_run on the card (sliced dispatch, a mixed fleet of four
    formats) gives the CPU decoder's results, state and flags; one launch
    per dispatch slice and format group."""
    streams = [mf.mixed_stream(c, 300 + i, 6, fuzz=False) for i, c in enumerate(mf.BATCH_CFGS)]
    streams += [mf.tonal_stream(mf.BATCH_CFGS[1], 400 + i, 6) for i in range(3)]
    # the four-stream group (12 granules of stereo) dispatches in two slices
    monkeypatch.setattr(transport, "MP3_SLICE_PCM_BYTES", 2 * 12 * 576 * 2 * 2)
    card = BatchedMP3Decoder(len(streams))
    cpu = BatchedMP3Decoder(len(streams), device="cpu")
    mk.reset_launch_counts()
    got, want = card.decode_run(streams, 6), cpu.decode_run(streams, 6)
    assert mk.mp3_granules_cuda.launches == 5   # 3 one-stream groups + 2 slices
    for rg, rw in zip(got, want):
        assert [(int(e), c) for e, _, c in rg] == [(int(e), c) for e, _, c in rw]
        for (_, pg, _), (_, pw, _) in zip(rg, rw):
            np.testing.assert_array_equal(pg, pw)
    assert card.last_frame_reference_defined == cpu.last_frame_reference_defined
    for a, b in zip(card._state(), cpu._state()):
        assert torch.equal(a.cpu(), b)


# the relaxed tiers: f32 kernels held to their plain versions by tolerance
# (nvcc contracts products and sums into FMAs; cuBLAS and the plain
# version's products sum in other orders)
FAST_STATE_RTOL = 1e-5   # of each f32 state tensor's largest magnitude


def close_tensors(names, got, want, label):
    """f32 tensors within FAST_STATE_RTOL of their largest magnitude, the
    others equal."""
    for name, a, b in zip(names, got, want):
        if a.dtype == torch.float32:
            err, scale = float((a - b.to(a.device)).abs().max()), float(b.abs().max())
            assert err <= FAST_STATE_RTOL * max(scale, 1e-30), f"{label}: {name} {err} of {scale}"
        else:
            assert torch.equal(a, b.to(a.device)), f"{label}: {name} differs"


def close_pcm(got, want, label):
    d = (got.to(torch.int32) - want.to(got.device).to(torch.int32)).abs()
    assert int(d.max()) <= 1, f"{label}: PCM differs by {int(d.max())}"


def close_mp3_run(got, want, label):
    """PCM within 1 LSB, f32 state within FAST_STATE_RTOL, the rest equal."""
    close_pcm(got[0], want[0], label)
    close_tensors(("over", "prev_type", "prev_win_switch", "num_prev", "vbuf"), got[1], want[1],
                  label)


def random_fast_state(n, gen, dev, scale=1.0):
    return tuple(t.to(dev) for t in (
        torch.randn((n, 2, 288), generator=gen) * 1e5 * scale,
        (torch.randint(0, 4, (n, 2), generator=gen, dtype=torch.int32) * int(scale)),
        torch.zeros((n, 2), dtype=torch.int32),
        (torch.randint(0, 33, (n, 2), generator=gen, dtype=torch.int32) * int(scale)),
        torch.randn((n, 2176), generator=gen) * 1e5 * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_i", range(len(MP3_CFGS)))
@pytest.mark.parametrize("B,n_frames,fuzz", [(5, 8, False), (7, 4, True), (300, 2, False),
                                             (400, 2, False)])
def test_mp3_granules_f32_kernel_matches_plain(cuda, cfg_i, B, n_frames, fuzz):
    """The mirror tier's kernel against its plain version on the card, on
    the exact kernel's runs: every block type, both FIFO parities, runs cut
    short by errors, zero state, then random state (a ring whose copies
    disagree) for the second run. B = 300 and 400 are more blocks than the
    SMs hold at once (two and three blocks an SM)."""
    cfg = MP3_CFGS[cfg_i]
    gen = torch.Generator().manual_seed(cfg_i)
    seen = set()
    for r_i, run in enumerate(mp3_runs(cfg, B, n_frames, fuzz, 100 * cfg_i + B)):
        for fmt, vindex, ids, huff_gs, side_gs in run:
            state = random_fast_state(len(ids), gen, cuda, scale=float(r_i))
            h, sd = (torch.as_tensor(a, device=cuda) for a in (huff_gs, side_gs))
            kw = dict(ver=fmt[0], sr_idx=fmt[1], nch=fmt[2], cutoff=fmt[3])
            got = mk.mp3_granules_f32_cuda(h, sd, *state, vindex, **kw)
            want = mk.mp3_granules_f32_plain(h, sd, *state, vindex, **kw)
            torch.cuda.synchronize()
            close_mp3_run(got, want, f"run {r_i} G={h.shape[0]} B={len(ids)} v={vindex}")
            assert not got[2].any()
            seen.add(h.shape[0])
    assert seen


def mxu_steps_checked(monkeypatch, label):
    """Route ``mp3mxu.mxu_run``'s two step kernels through wrappers that
    also run each step's plain version on the same CUDA tensors and hold
    the kernel to it, the run continuing from the kernel's results."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu

    def pre(yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
        want = mp3mxu.mxu_pre_plain(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        got = mk.mp3_mxu_pre_cuda(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        torch.cuda.synchronize()
        close_tensors(("[of | vc]", "over", "prev_type", "prev_win_switch", "num_prev"),
                      (got, over, pt, pws, npv), want, f"{label}: pre")
        return got

    def post(acc, newv, vbuf, keep, out, *, nch):   # no sum: bit for bit
        want_pcm, want_vbuf = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        mk.mp3_mxu_post_cuda(acc, newv, vbuf, keep, out, nch=nch)
        torch.cuda.synchronize()
        assert torch.equal(out, want_pcm), f"{label}: post PCM"
        assert torch.equal(vbuf.view(torch.int32), want_vbuf.view(torch.int32)), \
            f"{label}: post vbuf"

    monkeypatch.setattr(mp3mxu, "mp3_mxu_pre_cuda", pre)
    monkeypatch.setattr(mp3mxu, "mp3_mxu_post_cuda", post)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_i", range(len(MP3_CFGS)))
@pytest.mark.parametrize("B", [5, 37])
def test_mp3_mxu_step_kernels_match_plain(cuda, monkeypatch, cfg_i, B):
    """Both step kernels of the MXU tier against their plain versions on
    the card at every granule step of real runs (ragged B = 5 and 37), and
    the whole run against the plain run on the CPU."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MP3_CFGS[cfg_i]
    gen = torch.Generator().manual_seed(50 + cfg_i)
    for r_i, run in enumerate(mp3_runs(cfg, B, 4, False, 200 * cfg_i + B)):
        for fmt, vindex, ids, huff_gs, side_gs in run:
            state = random_fast_state(len(ids), gen, cuda, scale=float(r_i))
            h, sd = (torch.as_tensor(a, device=cuda) for a in (huff_gs, side_gs))
            kw = dict(ver=fmt[0], sr_idx=fmt[1], nch=fmt[2], cutoff=fmt[3])
            mxu_steps_checked(monkeypatch, f"run {r_i} B={len(ids)}")
            got = mp3mxu.mxu_run(h, sd, *state, vindex, **kw)
            monkeypatch.undo()
            want = mp3mxu.mxu_run(h.cpu(), sd.cpu(), *(t.cpu() for t in state), vindex, **kw)
            close_mp3_run(got, want, f"run {r_i} card vs CPU")


def mxu_post_cases(device):
    import kernel_variants as kv
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    return kv.cs, kv.cs.mxu_post_cases(list(mp3mxu.device_operators(device)["keep"]), device)


@pytest.mark.cuda
def test_mp3_mxu_post_kernel_cases(cuda):
    """mp3_mxu_post against its plain version bit for bit on the card on
    chip_smoke.mxu_post_cases: accumulators past the int16 range and on
    half-ties, the probed masks and masks mixed within groups of four, mono
    and stereo, B of 1, 3 and 37, PCM rows wider than a granule (the padding
    untouched)."""
    cs, cases = mxu_post_cases(cuda)
    assert cs.mxu_post_mismatches(mk.mp3_mxu_post_cuda, cases) == []


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [1, 2])
def test_mp3_mxu_post_kernel_refuses_misaligned(cuda, nch):
    """A PCM view whose base or row pitch is not a multiple of the kernel's
    8 nch-byte stores, or an accumulator view off 16 bytes, raises; nothing
    is written and nothing falls back."""
    B, width = 3, 576 * nch
    flat = torch.zeros(B * nch * 576 + 1, device=cuda)
    acc, off = flat[:-1].view(B * nch, 576), flat[1:].view(B * nch, 576)   # off: 4 bytes on
    newv = torch.zeros((B * nch, 1088), device=cuda)
    vbuf, keep = torch.zeros((B, 2176), device=cuda), torch.zeros(1088, device=cuda)
    shifted = torch.full((B, width + 8), 7, dtype=torch.int16, device=cuda)
    wide = torch.full((B, width + 4 * nch - 1), 7, dtype=torch.int16, device=cuda)
    for label, a, out in (("pcm base", acc, shifted[:, 1:1 + width]),
                          ("pcm pitch", acc, wide[:, :width]),
                          ("acc", off, shifted[:, :width])):
        mk.reset_launch_counts()
        with pytest.raises(RuntimeError, match="mp3_mxu_post"):
            mk.mp3_mxu_post_cuda(a, newv, vbuf, keep, out, nch=nch)
        torch.cuda.synchronize()
        assert mk.mp3_mxu_post_cuda.launches == 0, label
        assert bool((shifted == 7).all()) and bool((wide == 7).all()), label
    mk.mp3_mxu_post_cuda(acc, newv, vbuf, keep, shifted[:, :width], nch=nch)
    torch.cuda.synchronize()
    assert mk.mp3_mxu_post_cuda.launches == 1 and not bool((shifted[:, :width] == 7).any())


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["mirror", "mxu"])
def test_mp3_fast_kernels_escape_tier(cuda, monkeypatch, tier):
    """The int8 + escape-sideband transport under each relaxed tier: the
    card's run from the narrowed plane equals the plain run from the int16
    plane within the tolerance."""
    cfg = mf.BATCH_CFGS[1]
    streams = [mf.fuzz_stream(cfg, 700 + i, 4) for i in range(6)]
    for fmt, vindex, ids, huff_gs, side_gs in parsed_runs(
            BatchedMP3Decoder(6, device="cpu"), streams, 4):
        monkeypatch.setattr(mp3_pipeline, "ESC_MAX_DENSITY", 1.0)
        narrowed = mp3_pipeline._pack_huff8(huff_gs)
        assert narrowed is not None
        plane8, pos, val = (torch.as_tensor(a, device=cuda) for a in narrowed)
        state = random_fast_state(len(ids), torch.Generator().manual_seed(3), cuda, 0.0)
        sd = torch.as_tensor(side_gs, device=cuda)
        got = mp3_pipeline._granules_scan_esc_for(*fmt, fast=tier)(plane8, pos, val, sd, *state,
                                                                   vindex)
        want = mp3_pipeline._scan_builder(tier)(*fmt)(torch.as_tensor(huff_gs), sd.cpu(),
                                                      *(t.cpu() for t in state), vindex)
        close_mp3_run(got, want, f"escape tier, {tier}")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["mirror", "mxu"])
def test_mp3_fast_fleet_on_card_equals_cpu(cuda, monkeypatch, tier):
    """decode_run of a relaxed fleet on the card (a mixed fleet of four
    formats, sliced dispatch) within 1 LSB of the CPU fleet of the same
    tier, errors and consumed equal; one f32 kernel launch per dispatch
    slice and group (mirror), or two step kernels per granule (mxu)."""
    streams = [mf.mixed_stream(c, 300 + i, 6, fuzz=False) for i, c in enumerate(mf.BATCH_CFGS)]
    streams += [mf.tonal_stream(mf.BATCH_CFGS[1], 400 + i, 6) for i in range(3)]
    monkeypatch.setattr(transport, "MP3_SLICE_PCM_BYTES", 2 * 12 * 576 * 2 * 2)
    card = BatchedMP3Decoder(len(streams), fast=tier)
    cpu = BatchedMP3Decoder(len(streams), device="cpu", fast=tier)
    mk.reset_launch_counts()
    got, want = card.decode_run(streams, 6), cpu.decode_run(streams, 6)
    if tier == "mirror":
        assert mk.mp3_granules_f32_cuda.launches == 5   # 3 one-stream groups + 2 slices
    else:
        assert mk.mp3_mxu_pre_cuda.launches == mk.mp3_mxu_post_cuda.launches > 0
    assert mk.mp3_granules_cuda.launches == 0
    for rg, rw in zip(got, want):
        assert [(int(e), c) for e, _, c in rg] == [(int(e), c) for e, _, c in rw]
        for (_, pg, _), (_, pw, _) in zip(rg, rw):
            if pw is not None:
                assert int(np.abs(pg.astype(np.int32) - pw).max(initial=0)) <= 1
    assert card.last_frame_reference_defined == cpu.last_frame_reference_defined
    assert got.next_pos == want.next_pos


def dot_cases(device):
    """(label, a, b) operands of the exact dot: ragged n, rows past a
    row group, an unaligned row pitch and base (views), broadcasting,
    products and sums in the subnormal range, and the redesign's edges."""
    rng = np.random.default_rng(12)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    cases = [(f"n={n}", t(rng.standard_normal((37, n))), t(rng.standard_normal((37, n))))
             for n in (0, 1, 17, 4099, 256)]
    wide = t(rng.standard_normal((40, 131)))
    cases.append(("pitch 131, base +1", wide[:, 1:130], t(rng.standard_normal((40, 129)))))
    cases.append(("broadcast b", t(rng.standard_normal((3, 9, 300))),
                  t(rng.standard_normal((300,)))))
    tiny = rng.standard_normal((65, 300)) * 1e-20
    tiny[0] = 1e-39
    cases.append(("subnormal", t(tiny), t(rng.standard_normal((65, 300)) * 1e-19)))
    # the persistent ring's edges: R not a multiple of a group's 32 rows, R
    # below the SM count, a tensor-copy box past R and n, more row groups
    # than resident blocks; rows the tensor copies take, the same rows at an
    # unaligned base (4-byte copies), and a pitch of 1026 floats (4-byte)
    for R, n in ((1000, 256), (5, 777), (5, 20), (20000, 96)):
        cases.append((f"R={R} n={n}", t(rng.standard_normal((R, n))),
                      t(rng.standard_normal((R, n)))))
    a, b = rng.standard_normal((2, 300, 1024))
    cases.append(("tensor-copied rows", t(a), t(b)))
    odd = t(np.pad(np.stack([a, b]), ((0, 0), (0, 0), (1, 3))))
    cases.append(("base +4 bytes", odd[0, :, 1:1025], odd[1, :, 1:1025]))
    mixed = t(rng.standard_normal((2, 300, 1026)))
    cases.append(("pitch 1026", mixed[0, :, :1024], mixed[1, :, :1024]))
    return cases


@pytest.mark.cuda
def test_dotprod_exact_kernel_matches_plain(cuda):
    dk.reset_launch_counts()
    cases = dot_cases(cuda)
    for label, a, b in cases:
        got = dk.dotprod_exact_cuda(a, b)
        torch.cuda.synchronize()
        assert same_bits(got, dk.dotprod_exact_plain(a, b)), label
    assert dk.dotprod_exact_cuda.launches == len(cases)


@pytest.mark.cuda
def test_dsp_ops_on_card_equal_cpu(cuda):
    """biquad_f32 (exact: one iir2_sequential launch a call; fast) and the
    int16 ops, shift edge values and a tensor shift included, on the card
    bit for bit as on the CPU."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((6, 2, 2000)).astype(np.float32)
    coef = np.array([0.097631, 0.195262, 0.097631, -0.942809, 0.333333], np.float32)
    w = rng.standard_normal((6, 2, 2)).astype(np.float32) * 0.1
    bk.reset_launch_counts()
    y, nw = dsp.biquad_f32(*(torch.as_tensor(v, device=cuda) for v in (x, coef, w)))
    assert bk.iir2_sequential_cuda.launches == 1
    y_c, nw_c = dsp.biquad_f32(*(torch.as_tensor(v) for v in (x, coef, w)))
    assert same_bits(y.cpu(), y_c) and same_bits(nw.cpu(), nw_c)
    yf, _ = dsp.biquad_f32(*(torch.as_tensor(v, device=cuda) for v in (x, coef, w)), exact=False)
    torch.testing.assert_close(yf.cpu(), y_c, rtol=2e-4, atol=2e-5)
    a, b = (rng.integers(-32768, 32768, (4, 2, 3000), dtype=np.int16) for _ in range(2))
    shifts = [0, 15, 31, 32, 40, -1, rng.integers(-2, 40, (2, 3000)).astype(np.int32)]
    for sh in shifts:
        sh_c = torch.as_tensor(sh) if isinstance(sh, np.ndarray) else sh
        sh_g = torch.as_tensor(sh, device=cuda) if isinstance(sh, np.ndarray) else sh
        got = dsp.add_s16(torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda), sh_g)
        assert torch.equal(got.cpu(), dsp.add_s16(torch.as_tensor(a), torch.as_tensor(b), sh_c))
        got = dsp.mix_s16(torch.as_tensor(a, device=cuda), torch.as_tensor(b[:, 0, 0], device=cuda),
                          sh_g)
        assert torch.equal(got.cpu(), dsp.mix_s16(torch.as_tensor(a), torch.as_tensor(b[:, 0, 0]),
                                                  sh_c))
    for c in (0, -1, 32767, -32768):
        assert torch.equal(dsp.mulc_s16(torch.as_tensor(a, device=cuda), c).cpu(),
                           dsp.mulc_s16(torch.as_tensor(a), c))


@pytest.mark.cuda
def test_mp3_pipelined_and_restored_fleet_on_card(cuda):
    """decode_run_pipelined(to_device=True) on the card equals sequential
    runs on the CPU, and a fleet restored on the card from a CPU fleet's
    snapshot continues as the CPU fleet does."""
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
    streams = [mf.tonal_stream(cfg, 700 + i, 6) for i in range(3)]
    cpu = BatchedMP3Decoder(3, device="cpu")
    pos, want = [0] * 3, []
    for _ in range(3):
        r = cpu.decode_run([s[p:] for s, p in zip(streams, pos)], 2, to_device=True)
        pos = [p + q for p, q in zip(pos, r.next_pos)]
        want.append((r[0], list(r[1]), list(pos)))
    got = list(BatchedMP3Decoder(3).decode_run_pipelined(streams, 2, 3, to_device=True))
    assert len(got) == len(want)
    for (pcm, con, nxt), g in zip(want, got):
        assert g[0].is_cuda and torch.equal(g[0].cpu(), pcm)
        assert list(g[1]) == con and g.next_pos == nxt
    first = BatchedMP3Decoder(3, device="cpu")
    r1 = first.decode_run(streams, 3)
    card = BatchedMP3Decoder(3)
    card.set_state(first.get_state())
    rest = [s[p:] for s, p in zip(streams, r1.next_pos)]
    got, want = card.decode_run(rest, 3), first.decode_run(rest, 3)
    for rg, rw in zip(got, want):
        for (eg, pg, cg), (ew, pw, cw) in zip(rg, rw):
            assert (int(eg), cg) == (int(ew), cw)
            np.testing.assert_array_equal(pg, pw)
    for a, b in zip(card.get_state()["vbuf"], first.get_state()["vbuf"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ quantize and pack


def hot_pcm(seed, B, frames):
    """Interleaved stereo s16 bytes: a full-scale square wave (its filtered
    overshoot clips) over noise, a different period per stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    square = np.where((t[None, :] // (17 + 3 * np.arange(B)[:, None])) % 2, 32767, -32768)
    x = np.stack([square, rng.integers(-9000, 9000, (B, frames))], axis=-1)
    return x.astype(np.int16).reshape(B, -1).view(np.uint8)


def test_quantize_pack16_routes_cpu_to_plain():
    """On CPU tensors the wrapper runs its plain version and launches
    nothing: into the given output views (padding untouched) and counts,
    the same bytes and counts as float_to_int + pack_pcm16_interleave2."""
    qk.reset_launch_counts()
    cases = chip_smoke.quantize16_cases("cpu")
    assert chip_smoke.quantize16_mismatches(qk.quantize_pack16_cuda, cases) == []
    x = cases[0][1]
    packed, clips = qk.quantize_pack16_cuda(x, 100, torch.empty((3, 2981 * 4), dtype=torch.uint8),
                                            torch.empty(3, dtype=torch.int64))
    want = qk.quantize_pack16_plain(x, 100)
    assert torch.equal(packed, want[0]) and torch.equal(clips, want[1])
    samples, clipped = q.float_to_int(x, 16)
    assert torch.equal(packed, q.pack_pcm16_interleave2(samples))
    assert torch.equal(clips, clipped[..., :100].sum((1, 2)))
    assert qk.quantize_pack16_cuda.launches == 0


def test_quantize_pack16_refuses_bad_operands():
    x = torch.zeros((2, 2, 8))
    out, clips = torch.zeros((2, 32), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)
    for label, args in (("x dtype", (x.double(), 8, out, clips)),
                        ("mono x", (x[:, :1], 8, out, clips)),
                        ("negative gen", (x, -1, out, clips)),
                        ("out width", (x, 8, out[:, :28], clips)),
                        ("out dtype", (x, 8, out.short(), clips)),
                        ("clips dtype", (x, 8, out, clips.int())),
                        ("clips shape", (x, 8, out, clips[:1]))):
        with pytest.raises(ValueError):
            qk.quantize_pack16_cuda(*args)
            pytest.fail(label)
    with pytest.raises(ValueError, match="device"):
        qk.quantize_pack16_cuda(x.to("meta"), 8, out.to("meta"), clips.to("meta"))


@pytest.mark.cuda
def test_quantize_pack16_kernel_cases(cuda):
    """The kernel against its plain version byte for byte, clip counts
    included, on chip_smoke.quantize16_cases: NaN, infinities, +-2^31 and
    +-2^31 / 32768 with their neighbours, -0, subnormals, half-ties, values
    either side of +-1, gen < T, 0 and past T, odd T (2981, 22587), strided
    inputs, output rows inside padded rows (the padding untouched), B = 1,
    T = 0. One launch a case."""
    qk.reset_launch_counts()
    cases = chip_smoke.quantize16_cases(cuda)
    assert chip_smoke.quantize16_mismatches(qk.quantize_pack16_cuda, cases) == []
    assert qk.quantize_pack16_cuda.launches == len(cases)


@pytest.mark.cuda
def test_quantize_pack16_kernel_refuses_misaligned(cuda):
    """An output view off 4 bytes in its base or its row pitch, or input
    samples that are not contiguous, raise; nothing is written and nothing
    falls back."""
    B, T = 2, 33
    x = torch.rand((B, 2, T), device=cuda)
    clips = torch.full((B,), -1, dtype=torch.int64, device=cuda)
    shifted = torch.full((B, T * 4 + 8), 7, dtype=torch.uint8, device=cuda)
    wide = torch.full((B, T * 4 + 3), 7, dtype=torch.uint8, device=cuda)
    qk.reset_launch_counts()
    for label, xi, out, match in (
            ("out base", x, shifted[:, 1:1 + T * 4], "aligned"),
            ("out pitch", x, wide[:, :T * 4], "aligned"),
            ("x samples", torch.rand((B, T, 2), device=cuda).transpose(1, 2),
             shifted[:, :T * 4], "contiguous")):
        with pytest.raises(ValueError, match=match):
            qk.quantize_pack16_cuda(xi, T, out, clips)
        torch.cuda.synchronize()
        assert qk.quantize_pack16_cuda.launches == 0, label
        assert bool((shifted == 7).all()) and bool((wide == 7).all()), label
        assert bool((clips == -1).all()), label


@pytest.mark.cuda
def test_unpack16_extend_kernel_cases(cuda):
    """The kernel against its plain version bit for bit on
    chip_smoke.unpack16_cases: the cells' H and L scaled down, a chunk
    inside a wider row, row starts at 1-, 2-, 4-, 8- and 16-byte alignment,
    an odd L, a strided history, three gains and a subnormal factor, B = 1,
    frames = 0. One launch a case."""
    qk.reset_launch_counts()
    cases = chip_smoke.unpack16_cases(cuda)
    assert chip_smoke.unpack16_mismatches(qk.unpack16_extend_cuda, cases) == []
    assert qk.unpack16_extend_cuda.launches == len(cases)
    # bytes two apart within a row: read from a contiguous copy of the chunk
    wide = torch.randint(0, 256, (3, 2 * 4 * 50), dtype=torch.uint8, device=cuda)
    hist = torch.rand((3, 2, 7), device=cuda)
    got = qk.unpack16_extend_cuda(wide[:, ::2], 50, 1 / 32768, hist, 64)
    assert same_bits(got.cpu(), qk.unpack16_extend_plain(wide[:, ::2].cpu(), 50, 1 / 32768,
                                                         hist.cpu(), 64))


@pytest.mark.cuda
@pytest.mark.parametrize("tier, src, dst", [("exact", 44100.0, 16000.0),
                                            ("exact", 16000.0, 44100.0),
                                            ("fast", 44100.0, 16000.0)])
def test_stream_unpacks_once_per_chunk(cuda, tier, src, dst):
    """A resample_stream call of each body the cells run launches
    unpack16_extend once per chunk on the call's input in place; bytes,
    clip counts and history equal a CPU run of the plain path, two calls in
    a row, the second at -6.02 dB."""
    B, frames, n = 4, 1024, 3
    cfg = ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32)
    card = Resampler(B, exact=tier == "exact", device=cuda)
    cpu = Resampler(B, exact=tier == "exact", device="cpu")
    card.initialize(cfg)
    cpu.initialize(cfg)
    for call, gain in enumerate((0.0, -6.02)):
        data = hot_pcm(call, B, frames * n)
        qk.reset_launch_counts()
        pg, gg, cg = card.resample_stream(torch.as_tensor(data, device=cuda), frames, n, gain)
        assert qk.unpack16_extend_cuda.launches == n
        pc, gc, cc = cpu.resample_stream(data, frames, n, gain)
        assert list(gg) == list(gc)
        if tier == "exact":
            assert torch.equal(pg.cpu(), pc)
            np.testing.assert_array_equal(cg, cc)
        else:   # the banded contraction: within 1 LSB of the CPU's order
            d = (pg.cpu().view(torch.int16).int() - pc.view(torch.int16).int()).abs()
            assert int(d.max()) <= 1
        assert same_bits(card.history.cpu(), cpu.history)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_exact_stream_quantizes_once_per_chunk(cuda, src, dst):
    """An exact resample_stream call launches quantize_pack16 once per
    chunk, into the call's output buffer; bytes, generated counts, clip
    counts (some nonzero) and history equal a CPU run of the plain path,
    two calls in a row."""
    B, frames, n = 4, 1024, 3
    cfg = ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32)
    card, cpu = Resampler(B, device=cuda), Resampler(B, device="cpu")
    card.initialize(cfg)
    cpu.initialize(cfg)
    for call in range(2):
        data = hot_pcm(call, B, frames * n)
        qk.reset_launch_counts()
        pg, gg, cg = card.resample_stream(torch.as_tensor(data, device=cuda), frames, n)
        assert qk.quantize_pack16_cuda.launches == n
        pc, gc, cc = cpu.resample_stream(data, frames, n)
        assert pg.shape == pc.shape and pg.dtype == torch.uint8
        assert list(gg) == list(gc) and torch.equal(pg.cpu(), pc)
        np.testing.assert_array_equal(cg, cc)
        assert cc.sum() > 0
        assert torch.equal(card.history.cpu(), cpu.history)


@pytest.mark.cuda
def test_every_kernel_launches_on_the_last_device(cuda):
    """Every kernel launched on the last visible card (the second of a
    two-card machine; the only one of a one-card machine) while PyTorch's
    current device is card 0: each wrapper makes its tensors' device current
    for PyTorch and for the kernel library's own CUDA runtime
    (``runtime.kernels.launch_on``), so the kernel attributes, the SM count
    and the stream all belong to that card. Each launch is counted and
    equals its plain version there."""
    from esp_audio_libs_tpu_torch.ops import sinc

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(5)

    def counted(fn, *a, **k):
        before = fn.launches
        out = fn(*a, **k)
        torch.cuda.synchronize(dev)
        assert fn.launches == before + 1, fn.__name__
        return out

    Wt = torch.as_tensor(random_banded(rng, 3, 512, 300), device=dev)
    x = torch.as_tensor(rng.standard_normal((37, 2176)), dtype=torch.float32, device=dev)
    starts = torch.as_tensor([0, 301, 602], dtype=torch.int32, device=dev)
    assert torch.equal(pk.band_ranges_cuda(Wt), pk.band_ranges(Wt))
    torch.testing.assert_close(counted(pk.polyphase_banded_cuda, x, Wt, starts, T=300),
                               tpoly.polyphase_banded(x, Wt, starts, T=300), rtol=RTOL, atol=ATOL)
    x2, Wf, st = (torch.as_tensor(a, device=dev) for a in fused_inputs(3))
    s_k, c_k = counted(pk.polyphase_fused16_cuda, x2, Wf, st)
    s_p, _ = pk.polyphase_fused16_plain(x2, Wf, st)
    assert int((s_k.int() - s_p.int()).abs().max()) <= 1

    xe, fb, grid, second = exact_poly_operands(
        64, 32, sinc.SUBSAMPLE_INTERPOLATE | sinc.BLACKMAN_HARRIS, 16000 / 44100, M=8,
        n_in=2048, n_out=743)
    xe, fb, grid = xe.to(dev), fb.to(dev), [g.to(dev) for g in grid]
    assert same_bits(counted(pk.polyphase_exact_cuda, xe, fb, *grid, half=32,
                             compute_second=second),
                     pk.polyphase_exact_plain(xe, fb, *grid, half=32, compute_second=second))

    f = torch.as_tensor(rng.standard_normal((37, 1000)), dtype=torch.float32, device=dev)
    c = torch.as_tensor(tbq.biquad_init(tbq.biquad_lowpass(0.18), 1.0), device=dev)
    state = tuple(torch.as_tensor(rng.standard_normal(37), dtype=torch.float32, device=dev)
                  for _ in range(4))
    y, s = counted(bk.biquad_df1_cuda, f, c, state)
    y_p, s_p = bk.biquad_df1_plain(f, c, state)
    assert same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(s, s_p))
    y, (a, b) = counted(bk.iir2_sequential_cuda, f, c[3], c[4], state[0], state[1])
    y_p, (a_p, b_p) = bk.iir2_sequential_plain(f, c[3], c[4], state[0], state[1])
    assert same_bits(y, y_p) and same_bits(a, a_p) and same_bits(b, b_p)

    arrays = synthetic_frames(9, 7, 2, 1000, 8)
    params = [torch.as_tensor(a, device=dev) for a in arrays[1:]]
    kw = dict(depth=16, nch=2, mode32=False, use64=True, max_order=8)
    want = fk.flac_frame_plain(torch.as_tensor(arrays[0], device=dev), *params, **kw)
    for label, plane, esc in _frame_planes(arrays[0], dev):
        assert torch.equal(counted(fk.flac_frame_cuda, plane, *params, **kw, **esc), want), label

    for fmt, vindex, ids, huff_gs, side_gs in mp3_runs(MP3_CFGS[0], 3, 2, False, 9)[0]:
        n = len(ids)
        zeros = tuple(torch.zeros(shape, dtype=torch.int32, device=dev)
                      for shape in ((n, 2, 288), (n, 2), (n, 2), (n, 2), (n, 2176)))
        before = mk.mp3_granules_cuda.launches
        check_mp3_kernel(fmt, vindex, huff_gs, side_gs, zeros, dev, f"mp3 on {dev}")
        assert mk.mp3_granules_cuda.launches == before + 1

    for label, a, b in dot_cases(dev)[3:]:
        assert same_bits(counted(dk.dotprod_exact_cuda, a, b), dk.dotprod_exact_plain(a, b)), label

    xq = torch.as_tensor(rng.uniform(-1.2, 1.2, (37, 2, 1001)), dtype=torch.float32, device=dev)
    packed, clips = counted(qk.quantize_pack16_cuda, xq, 990,
                            torch.empty((37, 1001 * 4), dtype=torch.uint8, device=dev),
                            torch.empty(37, dtype=torch.int64, device=dev))
    want = qk.quantize_pack16_plain(xq.cpu(), 990)
    assert torch.equal(packed.cpu(), want[0]) and torch.equal(clips.cpu(), want[1])

    pcm = torch.as_tensor(rng.integers(0, 256, (37, 4 * 1003 + 6), dtype=np.uint8), device=dev)
    hist = torch.as_tensor(rng.standard_normal((37, 2, 72)), dtype=torch.float32, device=dev)
    slab = counted(qk.unpack16_extend_cuda, pcm[:, 2:2 + 4 * 1001], 1001, 1 / 32768, hist, 1152)
    want = qk.unpack16_extend_plain(pcm[:, 2:2 + 4 * 1001].cpu(), 1001, 1 / 32768, hist.cpu(),
                                    1152)
    assert same_bits(slab.cpu(), want)
    assert torch.cuda.current_device() == 0

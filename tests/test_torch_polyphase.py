"""Port parity, banded polyphase contraction and its two kernels.

On the CPU the kernel wrappers run their plain PyTorch versions; these are
held against the JAX package's functions (the Pallas kernels in interpret
mode, as tests/test_polyphase_banded.py runs them). The CUDA kernels
themselves are held against the plain versions in
tests/test_torch_kernels.py, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esp_audio_libs_tpu.ops import polyphase as jpoly
from esp_audio_libs_tpu.ops import sinc as jsinc
from esp_audio_libs_tpu.ops.polyphase_pallas import (polyphase_banded_pallas,
                                                     polyphase_fused16_pallas)
from esp_audio_libs_tpu.runtime.native import design_filterbank_native
from esp_audio_libs_tpu_torch.ops import polyphase as tpoly
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.runtime.phase_grid import PhaseState, phase_grid

from .test_torch_kernels import fused_inputs, random_banded

torch.set_num_threads(2)

# the banded contraction's tolerance (tests/test_polyphase_banded.py:131):
# f32 sums of ~300 products taken in another order
RTOL, ATOL = 2e-6, 4e-5


@pytest.mark.parametrize("ratio", [16000 / 44100, 44100 / 16000, 48000 / 44100, 1.0,
                                   8000 / 48000, 22050 / 44100, 96000 / 44100, 44100 / 48000])
@pytest.mark.parametrize("taps_p", [16, 64, 318, 1313])
def test_banded_K_equal(ratio, taps_p):
    # the port has only the JAX function's unaligned geometry
    assert tpoly.banded_K(ratio, taps_p) == jpoly.banded_K(ratio, taps_p, aligned=False)


def _grid_tensors(taps, nf, ratio, frames, seed):
    flags = jsinc.SUBSAMPLE_INTERPOLATE | jsinc.INCLUDE_LOWPASS
    bank = np.asarray(design_filterbank_native(
        taps, nf, float(np.float32(min(ratio, 1.0) * 0.9)), flags), np.float32)
    st = PhaseState.initial(taps)
    st.advance(taps / 2.0 + seed)          # a non-trivial phase
    out_free = int(np.ceil(frames * ratio)) + 8
    g = phase_grid(st, nf, flags, np.float32(ratio), frames, out_free)
    hist = taps + 8
    T = -(-out_free // 128) * 128
    win0x = np.zeros(T, np.int32)
    win0x[:out_free] = g.win0 + hist
    win0x[out_free:] = win0x[out_free - 1]
    pad = lambda a: np.pad(a[:out_free], (0, T - out_free))
    direct = np.zeros(taps, np.float32)
    direct[taps // 2 - 1] = 1.0
    K = jpoly.banded_K(ratio, taps)
    L = -(-max(hist + frames, K) // 128) * 128
    arrays = (win0x, pad(g.idx1), pad(g.idx2), pad(g.weight), pad(g.mode.astype(np.int32)))
    return bank, direct, arrays, g.output_generated, out_free, K, L


@pytest.mark.parametrize("taps", [16, 64])
@pytest.mark.parametrize("ratio,frames", [(16000 / 44100, 1024), (44100 / 16000, 700)])
def test_banded_weights_device_matches_jax(taps, ratio, frames):
    """Identical starts and nonzero placement; values within 1 f32 ulp of
    the lerp's terms (the JAX build on XLA:CPU may contract the lerp
    ``f2*w + f1*(1-w)`` into an FMA, esp_audio_libs_tpu/ops/polyphase.py:
    251-255, while eager PyTorch rounds each product and the sum
    separately; where the two terms cancel that one rounding is many ulps
    of the small result, so the bound is 1 ulp of ``|f2*w| + |f1*(1-w)|``,
    which is the same weight build over ``|filters|``)."""
    bank, direct, arrays, gen, _, K, L = _grid_tensors(taps, 32, ratio, frames, 3)
    build = jax.jit(lambda *a: jpoly.banded_weights_device(
        jnp.asarray(bank), jnp.asarray(direct), *a, K=K, taps_p=taps, L=L))
    Wj, sj = build(*map(jnp.asarray, arrays), jnp.int32(gen))
    Wt, st = tpoly.banded_weights_device(
        torch.from_numpy(bank), torch.from_numpy(direct), *map(torch.from_numpy, arrays),
        gen, K=K, taps_p=taps, L=L)
    Wj, sj = np.asarray(Wj), np.asarray(sj)
    assert st.dtype == torch.int32 and Wt.shape == Wj.shape
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(Wt.numpy() != 0, Wj != 0)
    mag, _ = tpoly.banded_weights_device(
        torch.from_numpy(np.abs(bank)), torch.from_numpy(direct),
        *map(torch.from_numpy, arrays), gen, K=K, taps_p=taps, L=L)
    assert (np.abs(Wt.numpy() - Wj) <= np.spacing(mag.numpy())).all()


@pytest.mark.parametrize("unaligned", [False, True])
def test_plain_banded_matches_pallas_interpret(unaligned):
    rng = np.random.default_rng(5)
    B, ch, L, nt, K = 4, 2, 2100, 6, 512
    x = rng.standard_normal((B, ch, L)).astype(np.float32)
    Wt = random_banded(rng, nt, K, 300)
    step = 310 if unaligned else 256
    starts = np.minimum(np.arange(nt) * step, L - K).astype(np.int32)
    T = nt * 128 - 50
    ref = np.asarray(polyphase_banded_pallas(
        jnp.asarray(x), jnp.asarray(Wt), jnp.asarray(starts), T=T, interpret=True))
    before = pk.polyphase_banded_cuda.launches
    got = pk.polyphase_banded_cuda(torch.from_numpy(x), torch.from_numpy(Wt),
                                   torch.from_numpy(starts), T=T)
    assert pk.polyphase_banded_cuda.launches == before  # CPU: plain version, no launch
    assert got.shape == (B, ch, T)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_fused16_matches_pallas_interpret():
    x, Wt, starts = fused_inputs(7)
    s_j, c_j = polyphase_fused16_pallas(jnp.asarray(x), jnp.asarray(Wt),
                                        jnp.asarray(starts), interpret=True)
    before = pk.polyphase_fused16_cuda.launches
    s_t, c_t = pk.polyphase_fused16_cuda(torch.from_numpy(x), torch.from_numpy(Wt),
                                         torch.from_numpy(starts))
    assert pk.polyphase_fused16_cuda.launches == before
    assert s_t.dtype == torch.int16 and c_t.dtype == torch.int8
    a, b = s_t.numpy().astype(np.int32), np.asarray(s_j).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    same = a == b
    np.testing.assert_array_equal(c_t.numpy()[same], np.asarray(c_j)[same])
    # the huge-weight column clipped NEGATIVE despite its positive overflow
    assert (s_t.numpy()[:, 5] == -32768).any() and (c_t.numpy()[:, 5] == 1).all()


@pytest.mark.parametrize("taps,nf,lowpass,flags", [
    (64, 32, 0.9 * 16000 / 44100, jsinc.SUBSAMPLE_INTERPOLATE | jsinc.INCLUDE_LOWPASS),
    (16, 256, 1.0, jsinc.SUBSAMPLE_INTERPOLATE | jsinc.BLACKMAN_HARRIS),
    (1024, 4, 0.45, jsinc.INCLUDE_LOWPASS | jsinc.BLACKMAN_HARRIS),
    (4, 2, 1.0, 0),
])
def test_design_filterbank_matches_jax(taps, nf, lowpass, flags):
    """The numpy filterbank design, bit for bit (both are numpy code)."""
    from esp_audio_libs_tpu_torch.ops import sinc as tsinc
    lp, fl = tsinc.normalize_lowpass(lowpass, flags)
    got = tsinc.design_filterbank(taps, nf, lp, fl)
    want = jsinc.design_filterbank(taps, nf, lp, fl)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("ratio,frames,valid", [(16000 / 44100, 700, None),
                                                (48000 / 44100, 400, 300),
                                                (22050 / 44100, 500, 200)])
def test_build_banded_weights_matches_jax(ratio, frames, valid):
    """The host tile builder, bit for bit, with and without valid_len and
    the start clamp, and a folded direct row."""
    taps, nf = 64, 32
    flags = jsinc.SUBSAMPLE_INTERPOLATE | jsinc.INCLUDE_LOWPASS
    bank = np.asarray(design_filterbank_native(
        taps, nf, float(np.float32(min(ratio, 1.0) * 0.9)), flags), np.float32)
    out_free = int(frames * ratio) + 8
    st = PhaseState.initial(taps)
    st.advance(taps / 2.0)
    g = phase_grid(st, nf, flags, np.float32(ratio), frames, out_free)
    hist = taps + 8
    args = (bank, g.win0.astype(np.int64) + hist, g.idx1, g.idx2, g.weight, g.mode)
    direct = np.random.default_rng(frames).standard_normal(taps).astype(np.float32)
    for kw in (dict(valid_len=valid), dict(valid_len=valid, L=hist + frames + 2048,
                                           direct_row=direct)):
        Wt, starts = tpoly.build_banded_weights(*args, half=taps // 2, **kw)
        Wj, sj = jpoly.build_banded_weights(*args, half=taps // 2, **kw)
        np.testing.assert_array_equal(starts, sj)
        np.testing.assert_array_equal(Wt.view(np.uint32), np.asarray(Wj).view(np.uint32))

"""Port parity: exact mode of the resampler. ``polyphase_apply``, the exact
``Resampler`` and ``BatchedResample`` of the PyTorch port against the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
- ``polyphase_apply(exact=True)``: bit-exact against a numpy f32
  recomputation in the C order (numpy contracts nothing); against JAX
  bit-exact on mode-0/1 outputs and within 1 ulp on mode-2 outputs, since
  XLA on the CPU contracts the lerp into an FMA
  (esp_audio_libs_tpu/ops/polyphase.py:250-255);
- ``polyphase_apply(exact=False)`` and ``BatchedResample(exact=False)``:
  rtol 2e-5 / atol 2e-6 (tests/test_art_resampler.py);
- the exact ``Resampler``: packed samples within 1 LSB in under 2 % of
  samples (tests/test_resampler.py:99-109), generated counts and phase
  equal, history bit-exact, biquad state bit-exact where no lerp output
  reaches a biquad (downsampling: the biquads run before the polyphase;
  upsampling without subsample interpolation); with interpolation on, the
  post-filter state carries the lerp's 1-ulp differences (rtol 1e-5), and
  without it every output byte is equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models.art_resampler import BatchedResample as JaxBatched
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu.ops.polyphase import polyphase_apply as jax_polyphase_apply
from esp_audio_libs_tpu_torch.models import (BatchedResample, Resampler,
                                             ResamplerConfiguration)
from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.ops import sinc
from esp_audio_libs_tpu_torch.ops.polyphase import polyphase_apply
from esp_audio_libs_tpu_torch.runtime.native import design_filterbank_native
from esp_audio_libs_tpu_torch.runtime.phase_grid import HISTORY_MARGIN, PhaseState, phase_grid

torch.set_num_threads(2)

F32 = np.float32
B, FRAMES, CHUNKS, FILTERS = 2, 1024, 3, 32
FAST_TOL = dict(rtol=2e-5, atol=2e-6)

# (taps, filters, lowpass, flags, ratio), from tests/test_art_resampler.py
CONFIGS = [
    (16, 8, 1.0, sinc.BLACKMAN_HARRIS, 0.5),
    (64, 16, 0.9, sinc.BLACKMAN_HARRIS | sinc.SUBSAMPLE_INTERPOLATE, 16000 / 44100),
    (64, 16, 1.0, 0, 2.0),
    (128, 64, 0.84, sinc.SUBSAMPLE_INTERPOLATE, 16000 / 48000),
]


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.uint32)


def ulps(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, F32).view(np.int32).astype(np.int64)
                  - np.asarray(b, F32).view(np.int32).astype(np.int64))


def schedule(taps, nf, lp, flags, ratio, n_in, n_out):
    """A real chunk schedule and filterbank of the configuration."""
    lpn, fl = sinc.normalize_lowpass(lp, flags)
    filters = np.asarray(design_filterbank_native(taps, nf, float(lpn), fl), F32)
    state = PhaseState.initial(taps)
    g = phase_grid(state, nf, fl, ratio, n_in, n_out)
    n = g.output_generated
    return filters, fl, (g.win0[:n] + taps + HISTORY_MARGIN, g.idx1[:n], g.idx2[:n],
                         g.weight[:n], g.mode[:n].astype(np.int32))


def numpy_exact(xext, filters, grid, half, second):
    """The exact polyphase in numpy f32, each op rounded, in the C order."""
    win, i1, i2, w, mode = grid
    f1, f2 = filters[i1], filters[i2]
    acc1 = np.zeros(xext.shape[:-1] + win.shape, F32)
    acc2 = acc1.copy()
    for k in range(filters.shape[1]):
        xg = xext[..., win + k]
        acc1 = acc1 + xg * f1[:, k]
        acc2 = acc2 + xg * f2[:, k]
    lerp = acc2 * w + acc1 * (F32(1.0) - w) if second else acc1
    return np.where(mode == 0, xext[..., win + half - 1], np.where(mode == 1, acc1, lerp))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_polyphase_exact_matches_jax(cfg):
    taps, nf, lp, flags, ratio = cfg
    filters, fl, grid = schedule(*cfg, n_in=700, n_out=900)
    second = bool(fl & sinc.SUBSAMPLE_INTERPOLATE)
    rng = np.random.default_rng(taps)
    xext = rng.standard_normal((2, 2, taps + HISTORY_MARGIN + 700)).astype(F32)
    got = polyphase_apply(torch.from_numpy(xext), torch.from_numpy(filters),
                          *map(torch.from_numpy, grid), half=taps // 2, exact=True,
                          compute_second=second).numpy()
    np.testing.assert_array_equal(bits(got), bits(numpy_exact(xext, filters, grid, taps // 2,
                                                              second)))
    want = np.asarray(jax_polyphase_apply(jnp.asarray(xext), jnp.asarray(filters),
                                          *map(jnp.asarray, grid), half=taps // 2, exact=True,
                                          compute_second=second))
    mode = grid[4]
    np.testing.assert_array_equal(bits(got[..., mode != 2]), bits(want[..., mode != 2]))
    assert ulps(got[..., mode == 2], want[..., mode == 2]).max(initial=0) <= 1
    if second:
        assert (mode == 2).any()


def test_polyphase_exact_modes_and_second_dot_off():
    """All three modes interleaved on a real schedule's windows, and
    compute_second off makes mode 2 return the first dot."""
    taps, nf, flags = 16, 4, 0
    filters, fl, grid = schedule(taps, nf, 0.9, flags, 0.45, n_in=300, n_out=200)
    win, i1, i2, w, mode = (a.copy() for a in grid)
    mode[:] = np.arange(mode.size) % 3
    i2[:] = (i1 + 1) % (nf + 1)
    w[:] = np.random.default_rng(2).uniform(0, 1, w.shape).astype(F32)
    rng = np.random.default_rng(3)
    xext = rng.standard_normal((3, taps + HISTORY_MARGIN + 300)).astype(F32)
    for second in (True, False):
        g = (win, i1, i2, w, mode)
        got = polyphase_apply(torch.from_numpy(xext), torch.from_numpy(filters),
                              *map(torch.from_numpy, g), half=taps // 2, exact=True,
                              compute_second=second).numpy()
        np.testing.assert_array_equal(bits(got), bits(numpy_exact(xext, filters, g, taps // 2,
                                                                  second)))
        np.testing.assert_array_equal(bits(got[..., mode == 0]),
                                      bits(xext[..., win[mode == 0] + taps // 2 - 1]))
    assert {0, 1, 2} <= set(mode.tolist())


def numpy_exact_nan_padded(xext, filters, grid, half, second):
    """numpy_exact with window samples outside [0, L) read as NaN."""
    win = grid[0]
    lo = max(0, -int(win.min()))
    hi = max(0, int(win.max()) + max(filters.shape[1], half) - xext.shape[-1])
    pad = [(0, 0)] * (xext.ndim - 1) + [(lo, hi)]
    return numpy_exact(np.pad(xext, pad, constant_values=np.nan), filters,
                       (win + lo, *grid[1:]), half, second)


def assert_same_bits(a, b):
    """NaN at the same positions, every other f32 bit pattern equal."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)
    np.testing.assert_array_equal(bits(a[keep]), bits(b[keep]))


# The exact kernel's edges (tests/test_torch_kernels.py::
# test_polyphase_exact_kernel_matches_plain) at a CPU size:
# (taps, filters, flags, ratio, rows, n_in, n_out)
_INTERP = sinc.SUBSAMPLE_INTERPOLATE | sinc.BLACKMAN_HARRIS
EDGE_CASES = {
    "rows_1": (64, 32, _INTERP, 16000 / 44100, 1, 600, 200),
    "rows_13": (64, 32, _INTERP, 16000 / 44100, 13, 600, 200),
    "T_1": (64, 32, _INTERP, 16000 / 44100, 4, 600, 1),
    "T_129": (64, 32, _INTERP, 16000 / 44100, 4, 600, 129),
    "odd_pitch": (64, 32, _INTERP, 16000 / 44100, 4, 601, 200),
    "nan_both_ends": (64, 32, _INTERP, 16000 / 44100, 4, 600, 200),
    "low_ratio": (64, 32, _INTERP, 0.05, 3, 4000, 190),
    "upsample": (64, 32, _INTERP, 44100 / 16000, 4, 300, 800),
    "no_second": (64, 32, sinc.BLACKMAN_HARRIS, 16000 / 44100, 4, 600, 200),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_polyphase_exact_plain_matches_jax_at_kernel_edges(case):
    """The exact kernel's reference, polyphase_exact_plain, on the operands
    of the kernel's edge cases, built with numpy from a seed: bit-exact
    against numpy_exact (NaN outside [0, L)), against JAX bit-exact outside
    mode 2 and within 1 ulp on mode-2 outputs (XLA on the CPU contracts the
    lerp). Entries past the generated count stay as the grid leaves them
    (mode 0). In ``nan_both_ends`` the first windows lie wholly before
    x[-L] and the last ones cross x[L-1]: jnp.take fills both with NaN (it
    would wrap an index in [-L, -1], which the port reads as NaN)."""
    taps, nf, flags, ratio, rows, n_in, n_out = EDGE_CASES[case]
    lpn, fl = sinc.normalize_lowpass(0.9, flags)
    filters = np.asarray(design_filterbank_native(taps, nf, float(lpn), fl), F32)
    g = phase_grid(PhaseState.initial(taps), nf, fl, ratio, n_in, n_out)
    L = taps + HISTORY_MARGIN + n_in
    win, i1, i2 = g.win0[:n_out] + taps + HISTORY_MARGIN, g.idx1[:n_out], g.idx2[:n_out]
    w, mode = g.weight[:n_out], g.mode[:n_out].astype(np.int32)
    win, mode = win.astype(np.int32), mode.copy()
    if case == "nan_both_ends":
        win[:20] = -L - 300 + 3 * np.arange(20)
        win[-20:] = L - 30 + np.arange(20)
        mode[:20] = mode[-20:] = 2
        mode[:10:3] = mode[-10::3] = 1
    grid = (win, i1.astype(np.int32), i2.astype(np.int32), w.astype(F32), mode)
    second = bool(fl & sinc.SUBSAMPLE_INTERPOLATE)
    xext = np.random.default_rng(len(case) * 101 + rows).standard_normal((rows, L)).astype(F32)
    got = pk.polyphase_exact_plain(torch.from_numpy(xext), torch.from_numpy(filters),
                                   *map(torch.from_numpy, grid), half=taps // 2,
                                   compute_second=second).numpy()
    assert got.shape == (rows, n_out)
    assert_same_bits(got, numpy_exact_nan_padded(xext, filters, grid, taps // 2, second))
    want = np.asarray(jax_polyphase_apply(jnp.asarray(xext), jnp.asarray(filters),
                                          *map(jnp.asarray, grid), half=taps // 2, exact=True,
                                          compute_second=second))
    assert_same_bits(got[..., mode != 2], want[..., mode != 2])
    lerp = mode == 2
    np.testing.assert_array_equal(np.isnan(got[..., lerp]), np.isnan(want[..., lerp]))
    finite = ~np.isnan(got[..., lerp])
    g_l, w_l = got[..., lerp][finite], want[..., lerp][finite]
    # Where the lerp's two terms nearly cancel, the FMA's one skipped
    # product rounding is many ulps of the result: hold JAX to 1 ulp, or to
    # that rounding (half a spacing of the larger term) and the result's own.
    ones = np.ones_like(mode)             # mode 1: the first dot with idx1, then with idx2
    acc1 = numpy_exact_nan_padded(xext, filters, (win, grid[1], grid[2], grid[3], ones),
                                  taps // 2, second)
    acc2 = numpy_exact_nan_padded(xext, filters, (win, grid[2], grid[2], grid[3], ones),
                                  taps // 2, second)
    wl = grid[3][lerp]
    big = np.maximum(np.abs(acc2[..., lerp] * wl), np.abs(acc1[..., lerp] * (F32(1) - wl)))
    bound = 0.5 * np.spacing(big[finite]) + np.spacing(np.abs(g_l))
    assert ((ulps(g_l, w_l) <= 1) | (np.abs(g_l.astype(np.float64) - w_l) <= bound)).all()
    if case == "nan_both_ends":
        assert np.isnan(got[:, :20]).all() and np.isnan(got[:, -20:]).all()
        assert not np.isnan(got[:, 20:-20]).any()


@pytest.mark.parametrize("cfg", CONFIGS)
def test_polyphase_fast_matches_jax(cfg):
    taps = cfg[0]
    filters, fl, grid = schedule(*cfg, n_in=500, n_out=700)
    rng = np.random.default_rng(taps + 1)
    xext = rng.standard_normal((2, taps + HISTORY_MARGIN + 500)).astype(F32)
    got = polyphase_apply(torch.from_numpy(xext), torch.from_numpy(filters),
                          *map(torch.from_numpy, grid), half=taps // 2, exact=False).numpy()
    want = jax_polyphase_apply(jnp.asarray(xext), jnp.asarray(filters), *map(jnp.asarray, grid),
                               half=taps // 2, exact=False)
    np.testing.assert_allclose(got, np.asarray(want), **FAST_TOL)


# ------------------------------------------------------------ Resampler


def _pair(src, dst, ch, taps, interp=True, batch=B):
    args = (src, dst, 16, 16, ch, True, interp, taps, FILTERS)
    j = JaxResampler(batch=batch)
    j.initialize(JaxConfig(*args))
    t = Resampler(batch=batch, device="cpu")
    t.initialize(ResamplerConfiguration(*args))
    assert j.exact and t.exact
    return j, t


def _pcm(seed, n_frames, ch, batch=B):
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (batch, n_frames * ch)).astype(np.int16)
    return pcm.view(np.uint8).reshape(batch, -1)


def _compare_packed(packed_j, packed_t, exact_bytes: bool) -> int:
    a = np.asarray(packed_j).view(np.int16).astype(np.int32)
    b = packed_t.cpu().numpy().view(np.int16).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    if exact_bytes:
        assert not d.any()
    assert d.max(initial=0) <= 1 and (d > 0).mean() < 0.02
    return int((d > 0).sum())


def _compare_state(j, t, biquad_exact: bool):
    sj, st = j.get_state(), t.get_state()
    assert set(sj) == set(st)
    assert bits(sj["phase_offset"]) == bits(st["phase_offset"])
    assert sj["phase_input_index"] == st["phase_input_index"]
    np.testing.assert_array_equal(bits(sj["history"]), bits(st["history"]))
    assert sj["hist_gain_zero"] == st["hist_gain_zero"]
    for stage_j, stage_t in zip(sj.get("biquad", []), st.get("biquad", [])):
        for a, b in zip(stage_j, stage_t):
            if biquad_exact:
                np.testing.assert_array_equal(bits(a), bits(b))
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("src,dst,ch,taps,interp", [
    (44100.0, 16000.0, 2, 64, True),
    (44100.0, 16000.0, 1, 16, True),
    (16000.0, 44100.0, 2, 64, False),
    (16000.0, 44100.0, 1, 16, True)])
def test_exact_stream_matches_jax(src, dst, ch, taps, interp):
    j, t = _pair(src, dst, ch, taps, interp)
    assert (t.pre_filter, t.post_filter, t.hist_len) == (j.pre_filter, j.post_filter, j.hist_len)
    biquad_exact = t.pre_filter or not interp
    data = _pcm(taps + ch, FRAMES * CHUNKS, ch)
    for _ in range(2):             # the second call continues from the carried state
        pj, gj, cj = j.resample_stream(data, FRAMES, CHUNKS)
        pt, gt, ct = t.resample_stream(torch.from_numpy(data), FRAMES, CHUNKS)
        assert list(gj) == list(gt)
        ndiff = _compare_packed(pj, pt, exact_bytes=not interp)
        assert np.abs(np.asarray(cj).astype(np.int64) - ct.astype(np.int64)).sum() <= ndiff
        _compare_state(j, t, biquad_exact)


@pytest.mark.parametrize("src,dst,ch", [(44100.0, 16000.0, 2), (16000.0, 44100.0, 1)])
def test_exact_per_call_matches_jax(src, dst, ch):
    j, t = _pair(src, dst, ch, 64, interp=False)
    data = _pcm(1, 900, ch)
    out_free = int(900 * dst / src) // 2
    for frames_avail in (900, 517, 64, 900):
        pj, rj = j.resample(data, frames_avail, out_free)
        pt, rt = t.resample(torch.from_numpy(data), frames_avail, out_free)
        assert (rt.frames_used, rt.frames_generated, rt.predicted_frames_used) == \
            (rj.frames_used, rj.frames_generated, rj.predicted_frames_used)
        _compare_packed(pj, pt, exact_bytes=True)
        np.testing.assert_array_equal(rt.clipped_samples, np.asarray(rj.clipped_samples))
        _compare_state(j, t, biquad_exact=True)


def test_exact_state_goes_jax_to_port_to_jax():
    """A stream starts in JAX, continues in the port, and returns to JAX:
    every output byte and the final state equal a JAX-only run."""
    args = (44100.0, 16000.0, 2, 64, False)
    j, t = _pair(*args)
    solo, _ = _pair(*args)
    data = _pcm(13, FRAMES * CHUNKS, 2)
    ref = [solo.resample_stream(data, FRAMES, CHUNKS)[0] for _ in range(3)]
    np.testing.assert_array_equal(np.asarray(j.resample_stream(data, FRAMES, CHUNKS)[0]), ref[0])
    t.set_state(j.get_state())
    np.testing.assert_array_equal(t.resample_stream(data, FRAMES, CHUNKS)[0].numpy(), ref[1])
    j.set_state(t.get_state())
    np.testing.assert_array_equal(np.asarray(j.resample_stream(data, FRAMES, CHUNKS)[0]), ref[2])
    _compare_state(solo, j, biquad_exact=True)


def test_exact_stream_launch_pattern_and_commit(monkeypatch):
    """Per chunk two biquad stages and one polyphase call, through the
    kernel wrappers; a call that fails leaves phase, history and biquad
    state where they were."""
    _, t = _pair(44100.0, 16000.0, 2, 64)
    calls = []
    real_b, real_p = bk.biquad_df1_cuda, pk.polyphase_exact_cuda
    monkeypatch.setattr(bk, "biquad_df1_cuda", lambda *a, **k: calls.append("b") or real_b(*a, **k))
    monkeypatch.setattr(pk, "polyphase_exact_cuda",
                        lambda *a, **k: calls.append("p") or real_p(*a, **k))
    data = _pcm(17, FRAMES * CHUNKS, 2)
    t.resample_stream(data, FRAMES, CHUNKS)
    assert calls == ["b", "b", "p"] * CHUNKS
    before = t.get_state()

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pk, "polyphase_exact_cuda", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.resample_stream(data, FRAMES, CHUNKS)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.resample(data, FRAMES, 300)
    after = t.get_state()
    assert bits(after["phase_offset"]) == bits(before["phase_offset"])
    assert after["phase_input_index"] == before["phase_input_index"]
    np.testing.assert_array_equal(after["history"], before["history"])
    for sa, sb in zip(after["biquad"], before["biquad"]):
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ BatchedResample


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_batched_resample_matches_jax(cfg, exact):
    taps, nf, lp, flags, ratio = cfg
    j = JaxBatched((2, 2), taps, nf, lp, flags, exact=exact)
    t = BatchedResample((2, 2), taps, nf, lp, flags, exact=exact, device="cpu")
    rng = np.random.default_rng(taps + nf)
    second = bool(j.flags & sinc.SUBSAMPLE_INTERPOLATE)
    for n_in, n_out in ((400, 300), (37, 500), (500, 64)):
        x = rng.standard_normal((2, 2, n_in)).astype(F32)
        oj, rj = j.process(jnp.asarray(x), n_out, ratio)
        ot, rt = t.process(torch.from_numpy(x), n_out, ratio)
        assert (rt.input_used, rt.output_generated) == (rj.input_used, rj.output_generated)
        assert tuple(ot.shape) == tuple(oj.shape)
        if not exact:
            np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FAST_TOL)
        elif second:
            assert ulps(ot.numpy(), np.asarray(oj)).max(initial=0) <= 1
        else:
            np.testing.assert_array_equal(bits(ot), bits(oj))
        np.testing.assert_array_equal(bits(t.history), bits(j.history))
        assert t.get_position() == j.get_position()


@pytest.mark.parametrize("exact", [True, False])
def test_batched_resample_dtype_argument_matches_jax(exact):
    """A call written for the JAX API, ``dtype`` given: the history is made
    in that dtype, and outputs and history match the JAX package (bit for
    bit in exact mode: this configuration has no mode-2 lerp, which XLA
    contracts)."""
    taps, nf, lp, flags, ratio = CONFIGS[0]
    j = JaxBatched((2, 2), taps, nf, lp, flags, exact=exact, dtype=jnp.float32)
    t = BatchedResample((2, 2), taps, nf, lp, flags, exact=exact, dtype=torch.float32,
                        device="cpu")
    assert t.history.dtype == torch.float32 and j.history.dtype == jnp.float32
    rng = np.random.default_rng(77)
    for n_in, n_out in ((400, 300), (120, 64)):
        x = rng.standard_normal((2, 2, n_in)).astype(F32)
        oj, rj = j.process(jnp.asarray(x), n_out, ratio)
        ot, rt = t.process(torch.from_numpy(x), n_out, ratio)
        assert (rt.input_used, rt.output_generated) == (rj.input_used, rj.output_generated)
        if exact:
            np.testing.assert_array_equal(bits(ot), bits(oj))
        else:
            np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FAST_TOL)
        assert t.history.dtype == torch.float32
        np.testing.assert_array_equal(bits(t.history), bits(j.history))


def test_batched_resample_queries_and_reset():
    args = (64, 16, 0.9, sinc.BLACKMAN_HARRIS)
    j = JaxBatched((1,), *args)
    t = BatchedResample((1,), *args, device="cpu")
    assert t.exact and t.flags == j.flags and t.lowpass_ratio == j.lowpass_ratio
    np.testing.assert_array_equal(bits(t.filters), bits(j.filters))
    for n in (1, 10, 100, 1000):
        assert t.get_required_samples(n, 0.61) == j.get_required_samples(n, 0.61)
        assert t.get_expected_output(n, 0.61) == j.get_expected_output(n, 0.61)
    t.advance_position(32.0)
    j.advance_position(32.0)
    assert t.get_position() == j.get_position()
    x = np.random.default_rng(4).standard_normal((1, 300)).astype(F32)
    t.process(torch.from_numpy(x), 200, 0.61)
    t.reset()
    assert not t.history.any() and dataclasses.astuple(t.state) == dataclasses.astuple(
        PhaseState.initial(64))
    with pytest.raises(ValueError, match="batch shape"):
        t.process(torch.zeros((2, 300)), 200, 0.61)
    with pytest.raises(ValueError, match="advance forward"):
        t.advance_position(-1.0)

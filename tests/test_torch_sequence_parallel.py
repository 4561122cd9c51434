"""Port parity of sequence parallelism (parallel/sequence.py): the five
contracts of tests/test_sequence_parallel.py, with JAX's functions on the 8
virtual CPU devices of tests/conftest.py and the port's on
``time_mesh(["cpu"] * 8)``, on the same numpy inputs.

Tolerances:
- ``sequence_parallel_resample``: against the port's single-device banded
  contraction of the whole chunk and against JAX's time-split resample,
  rtol 2e-6 / atol 2e-6 (the JAX test's: the band sits at other offsets in
  the slab, so the f32 sums group their addends otherwise); the padded
  per-device slots are exactly zero;
- ``sequence_parallel_iir2``: output and final state bit-identical to one
  sequential solve (the port's, run in the C order on the CPU), over three
  chunks with the state carried, and in a two-stage cascade;
- ``lpc_companion_scan``: bit-identical to ``ops.lpc.lpc_restore(shift=0)``
  and to JAX's scan, whole and split over the time mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esp_audio_libs_tpu.parallel.sequence import lpc_companion_scan as jax_lpc_scan
from esp_audio_libs_tpu.parallel.sequence import sequence_parallel_resample as jax_sp_resample
from esp_audio_libs_tpu.parallel.sequence import time_mesh as jax_time_mesh
from esp_audio_libs_tpu_torch.ops import biquad as bq
from esp_audio_libs_tpu_torch.ops import sinc
from esp_audio_libs_tpu_torch.ops.lpc import lpc_restore
from esp_audio_libs_tpu_torch.ops.polyphase import banded_K, banded_weights_device
from esp_audio_libs_tpu_torch.ops.polyphase_kernels import polyphase_banded_cuda
from esp_audio_libs_tpu_torch.ops.scan import iir2_sequential
from esp_audio_libs_tpu_torch.parallel.mesh import Sharded, shard_streams
from esp_audio_libs_tpu_torch.parallel.sequence import (lpc_companion_scan,
                                                        sequence_parallel_iir2,
                                                        sequence_parallel_resample, time_mesh)
from esp_audio_libs_tpu_torch.runtime.native import design_filterbank_native
from esp_audio_libs_tpu_torch.runtime.phase_grid import PhaseState, phase_grid

D = 8
K_FIXED = {0: [], 1: [1], 2: [-1, 2], 3: [1, -3, 3], 4: [-1, 4, -6, 4]}


@pytest.fixture(scope="module")
def mesh():
    return time_mesh(["cpu"] * D)


def _bits(t) -> np.ndarray:
    if isinstance(t, Sharded):
        t = t.gather("cpu")
    return np.asarray(t).view(np.uint32)


@pytest.mark.parametrize("fold", [False, True])
def test_time_sharded_matches_single_device(mesh, fold):
    taps, nf = 64, 32
    ratio = 16000 / 44100
    flags = sinc.SUBSAMPLE_INTERPOLATE | sinc.INCLUDE_LOWPASS
    bank = np.asarray(design_filterbank_native(
        taps, nf, float(np.float32(ratio * 0.9)), flags), np.float32)
    if fold:
        coeffs = bq.biquad_init(bq.biquad_lowpass(float(np.float32(ratio * 0.45))), 1.0)
        filt, direct, off = bq.fold_biquad_into_filterbank(
            bank, coeffs, bq.fir_len_for(coeffs), half=taps // 2)
    else:
        filt, off = bank, 0
        direct = np.zeros(taps, np.float32)
        direct[taps // 2 - 1] = 1.0
    taps_p = filt.shape[1]
    halo = taps_p + 8
    K = banded_K(ratio, taps_p)
    T_in = D * 2048
    st = PhaseState.initial(taps)
    st.advance(taps / 2.0)
    grid = phase_grid(st, nf, flags, np.float32(ratio), T_in, int(T_in * ratio) + 8)
    gen = grid.output_generated

    class G:                       # the grid with the fold offset applied to win0
        win0 = grid.win0 - off
        idx1, idx2, weight, mode = grid.idx1, grid.idx2, grid.weight, grid.mode
        output_generated = gen

    x = np.random.default_rng(17).standard_normal((2, 2, T_in)).astype(np.float32)
    y, counts = sequence_parallel_resample(torch.from_numpy(x), filt, direct, G, mesh,
                                           taps_p=taps_p, K=K, halo=halo)
    assert isinstance(y, Sharded) and y.axis == 2 and len(counts) == D
    y = y.gather().numpy()
    To = y.shape[-1] // D
    got = np.concatenate([y[..., d * To: d * To + counts[d]] for d in range(D)], axis=-1)
    assert got.shape[-1] == gen
    for d in range(D):            # padded per-device slots are zero, not garbage
        np.testing.assert_array_equal(y[..., d * To + counts[d]:(d + 1) * To], 0.0)

    # the single-device banded contraction over the whole halo-padded chunk
    L = -(-max(halo + T_in, K) // 128) * 128
    T_pad = -(-gen // 128) * 128
    win0x = np.zeros(T_pad, np.int32)
    win0x[:gen] = G.win0[:gen] + halo
    win0x[gen:] = win0x[gen - 1]
    pad = lambda a: torch.from_numpy(np.pad(np.asarray(a)[:gen], (0, T_pad - gen)))
    xp = np.pad(x, [(0, 0), (0, 0), (halo, L - halo - T_in)])
    Wt, starts = banded_weights_device(
        torch.from_numpy(filt), torch.from_numpy(direct), torch.from_numpy(win0x),
        pad(G.idx1), pad(G.idx2), pad(G.weight), pad(G.mode.astype(np.int32)), gen,
        K=K, taps_p=taps_p, L=L)
    ref = polyphase_banded_cuda(torch.from_numpy(xp), Wt, starts, T=T_pad).numpy()
    np.testing.assert_allclose(got, ref[..., :gen], rtol=2e-6, atol=2e-6)

    # JAX's time-split resample on the same inputs and slab width
    yj, cj = jax_sp_resample(jnp.asarray(x), filt, direct, G, jax_time_mesh(jax.devices()[:D]),
                             taps_p=taps_p, K=K, halo=halo)
    np.testing.assert_array_equal(cj, counts)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=2e-6, atol=2e-6)


def test_exact_iir2_time_sharded_bit_exact(mesh):
    """The order-2 recurrence split over 8 devices, the state handed from
    segment to segment: bit-identical to one sequential solve, the carried
    final state included, over three chunks."""
    rng = np.random.default_rng(7)
    B, T = 3, 64 * D
    p1, p2 = torch.tensor(-1.6), torch.tensor(0.81)     # stable resonator poles
    y1 = y2 = ys1 = ys2 = torch.zeros(B)
    for chunk in range(3):
        f = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))
        ref, (r1, r2) = iir2_sequential(f, p1, p2, ys1, ys2)
        got, (g1, g2) = sequence_parallel_iir2(f, p1, p2, y1, y2, mesh)
        assert isinstance(got, Sharded) and got.axis == 1
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=f"chunk {chunk}")
        np.testing.assert_array_equal(_bits(g1), _bits(r1))
        np.testing.assert_array_equal(_bits(g2), _bits(r2))
        y1, y2, ys1, ys2 = g1, g2, r1, r2


def test_exact_iir2_cascade_composes(mesh):
    """Two split stages chained (the resampler's two-biquad cascade shape),
    the first stage's split output fed straight in, stay bit-exact."""
    rng = np.random.default_rng(11)
    B, T = 2, 32 * D
    p1, p2 = -1.2, 0.5
    f = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))
    z = torch.zeros(B)
    c1, c2 = torch.tensor(p1), torch.tensor(p2)
    r1s, _ = iir2_sequential(f, c1, c2, z, z)
    r2s, _ = iir2_sequential(r1s, c1, c2, z, z)
    g1s, _ = sequence_parallel_iir2(f, p1, p2, z, z, mesh)
    g2s, _ = sequence_parallel_iir2(g1s, p1, p2, z, z, mesh)
    np.testing.assert_array_equal(_bits(g2s), _bits(r2s))


def test_lpc_companion_scan_bitexact_fixed_orders():
    """The order-k companion-matrix scan restores shift-0 (fixed-predictor)
    subframes bit-identically to the sequential restoration and to JAX's
    scan."""
    rng = np.random.default_rng(5)
    B, T = 6, 256
    data = rng.integers(-3000, 3000, (B, T)).astype(np.int32)
    orders = np.array([0, 1, 2, 3, 4, 2], np.int32)
    coeffs = np.zeros((B, 32), np.int32)
    for b, o in enumerate(orders):
        coeffs[b, :o] = K_FIXED[int(o)]
    d_t, c_t, o_t = map(torch.from_numpy, (data, coeffs, orders))
    want = lpc_restore(d_t, c_t, o_t, torch.zeros(B, dtype=torch.int32), use64=True)
    got = lpc_companion_scan(d_t, c_t, o_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_lpc_scan(jnp.asarray(data), jnp.asarray(coeffs),
                                             jnp.asarray(orders))))


def test_lpc_companion_scan_time_sharded(mesh):
    """The scan with its time axis split over the mesh (each segment scanned
    on its own device, the carries composed in order) stays bit-identical,
    warm-up samples at the start of the first segment included."""
    rng = np.random.default_rng(7)
    B, T = 2, 512
    data = rng.integers(-2000, 2000, (B, T)).astype(np.int32)
    coeffs = np.zeros((B, 32), np.int32)
    coeffs[:, :2] = [-1, 2]
    orders = np.full(B, 2, np.int32)
    d_t, c_t, o_t = map(torch.from_numpy, (data, coeffs, orders))
    ref = lpc_companion_scan(d_t, c_t, o_t)
    got = lpc_companion_scan(shard_streams(d_t, mesh, axis=1), c_t, o_t)
    assert isinstance(got, Sharded) and got.axis == 1
    np.testing.assert_array_equal(got.gather().numpy(), ref.numpy())
    np.testing.assert_array_equal(
        ref.numpy(), np.asarray(jax_lpc_scan(jnp.asarray(data), jnp.asarray(coeffs),
                                             jnp.asarray(orders))))
    with pytest.raises(ValueError, match="time"):
        lpc_companion_scan(shard_streams(torch.zeros((D, 16), dtype=torch.int32), mesh),
                           c_t[:1].expand(D, 32), o_t[:1].expand(D))

"""Port parity of the DSP primitive layer: ``esp_audio_libs_tpu_torch.ops.dsp``
against ``esp_audio_libs_tpu.ops.dsp`` on the CPU, on the same numpy inputs,
at the shapes and parameters of tests/test_dsp.py with a batch axis added.

Tolerances: the exact forms of ``dotprod_f32`` and ``biquad_f32`` and the
int16 ops bit for bit; the fast forms at the JAX tests' own tolerances
(``dotprod_f32`` rtol 1e-5 / atol 1e-5, ``biquad_f32`` rtol 2e-4 / atol
2e-5: another summation order). ``dotprod_exact_plain`` (the plain version
of csrc/dotprod_exact.cu) is also held to a numpy left-to-right f32 loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.ops import dsp as jdsp
from esp_audio_libs_tpu_torch.ops import dsp
from esp_audio_libs_tpu_torch.ops.dsp_kernels import dotprod_exact_plain

SHIFTS = [0, 1, 4, 15, 31, 32, -1]


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [0, 1, 4, 17, 256, 1024, 4099])
def test_dotprod_exact_matches_jax_and_c_order(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((3, 2, n)).astype(np.float32)
    b = rng.standard_normal((3, 2, n)).astype(np.float32)
    got = dsp.dotprod_f32(_t(a), _t(b)).numpy()
    want = np.asarray(jdsp.dotprod_f32(jnp.asarray(a), jnp.asarray(b), exact=True))
    np.testing.assert_array_equal(bits(got), bits(want))
    acc = np.zeros((3, 2), np.float32)
    for i in range(n):
        acc = (acc + (a[..., i] * b[..., i]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(bits(dotprod_exact_plain(_t(a), _t(b)).numpy()), bits(acc))
    if n == 0:
        assert not np.signbit(got).any() and not got.any()


def test_dotprod_exact_subnormals():
    """Subnormal operands and products flush to zeros of their sign, as in
    JAX (dotprod([[1e-39, 1]], [[1, 1e-39]]) is +0), and so do sums."""
    a = np.array([[1e-39, 1.0], [1.5e-38, -1.4e-38], [-0.0, -0.0], [3e-20, 2e-20]], np.float32)
    b = np.array([[1.0, 1e-39], [1.0, 1.0], [1.0, 1.0], [3e-19, -2e-19]], np.float32)
    got = dsp.dotprod_f32(_t(a), _t(b)).numpy()
    want = np.asarray(jdsp.dotprod_f32(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(bits(got), bits(want))
    assert got[0] == 0 and not np.signbit(got[0])


def test_dotprod_fast_close():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 8, 512)).astype(np.float32)
    b = rng.standard_normal((3, 8, 512)).astype(np.float32)
    fast = dsp.dotprod_f32(_t(a), _t(b), exact=False).numpy()
    np.testing.assert_allclose(fast, dsp.dotprod_f32(_t(a), _t(b)).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fast, np.asarray(jdsp.dotprod_f32(jnp.asarray(a), jnp.asarray(b),
                                                                 exact=False)),
                               rtol=1e-5, atol=1e-5)


STABLE = np.array([0.2, 0.3, 0.2, -0.5, 0.25], np.float32)
LOWPASS = np.array([0.097631, 0.195262, 0.097631, -0.942809, 0.333333], np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_biquad_exact_matches_jax(per_row):
    """Shared ``coef [5]`` and per-row ``coef [..., 5]``, nonzero state."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 512)).astype(np.float32)
    coef = (STABLE * rng.uniform(0.5, 1.0, (3, 2, 5))).astype(np.float32) if per_row else STABLE
    w = rng.standard_normal((3, 2, 2)).astype(np.float32) * 0.1
    y, nw = dsp.biquad_f32(_t(x), _t(coef), _t(w))
    jy, jw = jdsp.biquad_f32(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(w), exact=True)
    np.testing.assert_array_equal(bits(y.numpy()), bits(jy))
    np.testing.assert_array_equal(bits(nw.numpy()), bits(jw))


def test_biquad_exact_subnormal_tail():
    """An impulse then silence through the lowpass: the state decays
    through the subnormal range, where both packages flush."""
    x = np.zeros((2, 4096), np.float32)
    x[:, 0] = [1.0, -3e-30]
    w = np.zeros((2, 2), np.float32)
    y, nw = dsp.biquad_f32(_t(x), _t(LOWPASS), _t(w))
    jy, jw = jdsp.biquad_f32(jnp.asarray(x), jnp.asarray(LOWPASS), jnp.asarray(w), exact=True)
    np.testing.assert_array_equal(bits(y.numpy()), bits(jy))
    np.testing.assert_array_equal(bits(nw.numpy()), bits(jw))
    tiny = np.abs(y.numpy())
    assert ((tiny > 0) & (tiny < 1e-30)).any() and (y.numpy()[:, -1] == 0).all()


def test_biquad_fast_close():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 1024)).astype(np.float32)
    w = np.zeros((2, 4, 2), np.float32)
    y, nw = dsp.biquad_f32(_t(x), _t(LOWPASS), _t(w), exact=False)
    for ex in (True, False):
        jy, jw = jdsp.biquad_f32(jnp.asarray(x), jnp.asarray(LOWPASS), jnp.asarray(w), exact=ex)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(nw.numpy(), np.asarray(jw), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shift", SHIFTS + ["tensor"])
def test_add_s16(shift):
    rng = np.random.default_rng(4)
    a = rng.integers(-32768, 32768, (3, 2048), dtype=np.int16)
    b = rng.integers(-32768, 32768, (3, 2048), dtype=np.int16)
    if shift == "tensor":
        sh = rng.choice(np.array(SHIFTS + [40], np.int32), (3, 2048))
        got, want = dsp.add_s16(_t(a), _t(b), _t(sh)), jdsp.add_s16(a, b, jnp.asarray(sh))
    else:
        got, want = dsp.add_s16(_t(a), _t(b), shift), jdsp.add_s16(a, b, shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [0, 1, -1, 16384, 32767, -32768])
def test_mulc_s16(c):
    rng = np.random.default_rng(5)
    x = rng.integers(-32768, 32768, (3, 2048), dtype=np.int16)
    got = dsp.mulc_s16(_t(x), np.int16(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdsp.mulc_s16(x, np.int16(c))))


@pytest.mark.parametrize("n_streams,shift", [(1, 0), (2, 0), (2, 1), (4, 2), (5, 0), (3, 32),
                                             (3, -1)])
def test_mix_s16(n_streams, shift):
    """Full-scale inputs at shift 0 wrap in the int16 adds; the shift also
    goes in as a tensor."""
    rng = np.random.default_rng(6 + n_streams)
    x = rng.integers(-32768, 32768, (n_streams, 2, 1024), dtype=np.int16)
    gains = rng.integers(-32768, 32768, n_streams, dtype=np.int16)
    want = np.asarray(jdsp.mix_s16(jnp.asarray(x), jnp.asarray(gains), shift=shift))
    np.testing.assert_array_equal(dsp.mix_s16(_t(x), _t(gains), shift).numpy(), want)
    np.testing.assert_array_equal(
        dsp.mix_s16(_t(x), _t(gains), torch.tensor(shift, dtype=torch.int32)).numpy(), want)

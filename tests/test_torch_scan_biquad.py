"""Port parity: ops/scan.py and the device half of ops/biquad.py, the
PyTorch port against the JAX package on the CPU, on the same numpy inputs.

Tolerances:
- the exact DF-I biquad (second order, first order, ``valid_len``, streamed
  chunks carrying state) and the flush rule: bit-exact (uint32 views), the
  sign of every zero included;
- ``iir2_sequential``: bit-exact against a numpy recomputation in the C
  reference's order. XLA on the CPU contracts the JAX version's two
  mul-subs into FMAs (the TPU does not), so against JAX the port is held to
  the numpy recomputation of that contraction's effect only through the
  recurrence's own scale (rtol 1e-5 of the signal's peak);
- ``iir2_scan`` and both fast ``biquad_apply`` forms: rtol 1e-4 / atol 1e-5,
  the JAX package's own fast tolerance (tests/test_biquad.py:65).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.ops import biquad as jbq
from esp_audio_libs_tpu.ops import scan as jscan
from esp_audio_libs_tpu_torch.ops import biquad as tbq
from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
from esp_audio_libs_tpu_torch.ops import scan as tscan

torch.set_num_threads(2)

F32 = np.float32
FAST_TOL = dict(rtol=1e-4, atol=1e-5)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.uint32)


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(bits(got), bits(want))


def jax_state(state):
    return tuple(jnp.asarray(s) for s in state)


def torch_state(state):
    return tuple(torch.from_numpy(np.array(s, F32)) for s in state)


def random_state(rng, shape):
    return tuple(rng.standard_normal(shape).astype(F32) * F32(0.3) for _ in range(4))


# ------------------------------------------------------------- flush rule


def test_flush_rule_matches_jax():
    """Pin the JAX package's subnormal rule: subnormal operands count as
    zeros of their own sign, subnormal results become zeros of their own
    sign (products from exact_mul, sums and differences from f32 adds);
    normal values pass untouched."""
    a = np.array([1e-39, -1e-39, 3e-45, -3e-45, 2e-20, -2e-20, 1.5e-19, 1.0, -0.0, 1e-38,
                  1.2e-38, 3.0], F32)
    b = np.array([2.0 ** 40, 2.0 ** 40, 1.0, 1.0, 2e-20, 2e-20, -1e-19, 1e-38, 5.0, 1.0,
                  -1.1e-38, 1e-30], F32)
    want = jax.jit(jscan.exact_mul)(jnp.asarray(a), jnp.asarray(b))
    got = tscan.exact_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert_bits_equal(got, want)
    assert bits(got)[1] == 0x80000000 and bits(got)[4] == 0          # -0.0 and +0.0

    want_add = jax.jit(lambda x, y: x + y)(jnp.asarray(a), jnp.asarray(b))
    want_sub = jax.jit(lambda x, y: x - y)(jnp.asarray(a), jnp.asarray(-b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_bits_equal(tscan.ftz(tscan.ftz(ta) + tscan.ftz(tb)), want_add)
    assert_bits_equal(tscan.ftz(tscan.ftz(ta) - tscan.ftz(-tb)), want_sub)
    # a plain copy keeps a subnormal's bits
    assert_bits_equal(tscan.ftz(ta)[:2], np.zeros(2, F32) * np.sign(a[:2]))


def test_decaying_tail_flushes_like_jax():
    """A burst then silence through the exact biquad (lowpass 0.18): the
    tail decays through the subnormal range. JAX and the port give the same
    bits, including exact zeros where the tail has underflowed; a
    recurrence that underflows gradually would leave subnormals there."""
    coeffs = jbq.biquad_init(jbq.biquad_lowpass(0.18), 1.0)
    rng = np.random.default_rng(3)
    x = np.zeros((3, 400), F32)
    x[:, :8] = rng.standard_normal((3, 8)).astype(F32)
    x[1, :8] *= F32(1e-30)                              # reaches subnormals sooner
    zeros = tuple(np.zeros(3, F32) for _ in range(4))
    yj, sj = jbq.biquad_apply(jnp.asarray(x), jnp.asarray(coeffs), jax_state(zeros), exact=True)
    yt, st = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), torch_state(zeros),
                              exact=True)
    assert_bits_equal(yt, yj)
    for a, b in zip(st, sj):
        assert_bits_equal(a, b)
    y = yt.numpy()
    assert (y[:, -50:] == 0).all()
    assert not ((y != 0) & (np.abs(y) < np.finfo(F32).tiny)).any()

    # the same recurrence in numpy f32, which underflows gradually
    a0, a1, a2, b1, b2 = (F32(c) for c in coeffs)
    i1 = i2 = o1 = o2 = F32(0.0)
    sub = 0
    with np.errstate(under="ignore"):
        for xv in x[1]:
            yv = F32(F32(F32(F32(F32(xv * a0) + F32(i1 * a1)) + F32(i2 * a2)) - F32(b1 * o1))
                     - F32(b2 * o2))
            sub += 0 < abs(yv) < np.finfo(F32).tiny
            i2, i1, o2, o1 = i1, xv, o1, yv
    assert sub > 0


# ----------------------------------------------------------- exact biquad


@pytest.mark.parametrize("first_order", [False, True])
@pytest.mark.parametrize("valid_len", [None, 0, 1, 300, 1024])
def test_biquad_exact_matches_jax(first_order, valid_len):
    rng = np.random.default_rng(11 + (valid_len or 0))
    if first_order:
        coeffs = np.array([0.3, 0.3, 0.0, -0.4, 0.0], F32)
    else:
        coeffs = jbq.biquad_init(jbq.biquad_lowpass(0.12), 1.0)
    x = rng.standard_normal((2, 3, 1024)).astype(F32)
    state = random_state(rng, (2, 3))
    yj, sj = jbq.biquad_apply(jnp.asarray(x), jnp.asarray(coeffs), jax_state(state), exact=True,
                              first_order=first_order,
                              valid_len=None if valid_len is None else jnp.int32(valid_len))
    yt, st = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), torch_state(state),
                              exact=True, first_order=first_order, valid_len=valid_len)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    assert_bits_equal(yt, yj)
    for a, b in zip(st, sj):
        assert_bits_equal(a, b)


def test_biquad_exact_streamed_chunks_carry_state():
    """Chunks of uneven length, each starting from the state the last one
    left, with per-lane coefficients: bit-exact against JAX and equal to
    one pass over the whole signal. (Chunks of one sample are held to the C
    order in the next test: XLA on the CPU unrolls a one-step scan and
    contracts it.)"""
    rng = np.random.default_rng(21)
    coeffs = np.stack([jbq.biquad_init(jbq.biquad_highpass(f), g)
                       for f, g in ((0.05, 1.0), (0.2, 0.5), (0.33, 2.0), (0.41, 1.0))])
    x = rng.standard_normal((4, 1500)).astype(F32)
    sj, st = jax_state(random_state(rng, (4,))), None
    st = torch_state([np.asarray(s) for s in sj])
    whole, _ = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), st, exact=True)
    outs = []
    for lo, hi in ((0, 2), (2, 700), (700, 703), (703, 1500)):
        yj, sj = jbq.biquad_apply(jnp.asarray(x[:, lo:hi]), jnp.asarray(coeffs), sj, exact=True)
        yt, st = tbq.biquad_apply(torch.from_numpy(x[:, lo:hi]), torch.from_numpy(coeffs), st,
                                  exact=True)
        assert_bits_equal(yt, yj)
        for a, b in zip(st, sj):
            assert_bits_equal(a, b)
        outs.append(yt)
    assert_bits_equal(torch.cat(outs, -1), whole)


def _df1_numpy(x, c, state):
    """The second-order DF-I step in numpy f32, each op rounded (no value
    here comes near the subnormal range)."""
    i1, i2, o1, o2 = state
    y = (((x * c[..., 0] + i1 * c[..., 1]) + i2 * c[..., 2]) - c[..., 3] * o1) - c[..., 4] * o2
    return y.astype(F32)


def test_biquad_exact_single_sample_c_order():
    """One-sample calls: the port keeps the C order (against a numpy
    recomputation, bit for bit); JAX on the CPU contracts that case, so it
    is held to the port to f32 rounding of the terms (atol 1e-6; the
    terms are of order 1)."""
    rng = np.random.default_rng(22)
    c = np.stack([jbq.biquad_init(jbq.biquad_highpass(f), 1.0) for f in (0.05, 0.2, 0.33, 0.41)])
    x = rng.standard_normal((4, 1)).astype(F32)
    state = random_state(rng, (4,))
    yt, st = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(c), torch_state(state),
                              exact=True)
    assert_bits_equal(yt[:, 0], _df1_numpy(x[:, 0], c, state))
    assert_bits_equal(st[0], x[:, 0])
    assert_bits_equal(st[2], yt[:, 0])
    yj, _ = jbq.biquad_apply(jnp.asarray(x), jnp.asarray(c), jax_state(state), exact=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)


def test_biquad_designs_match_jax():
    for f in (0.01, 0.18, 0.3, 0.49):
        assert_bits_equal(tbq.biquad_highpass(f), jbq.biquad_highpass(f))
        assert_bits_equal(tbq.biquad_lowpass(f), jbq.biquad_lowpass(f))
    zeros = tbq.BiquadState.zeros((3, 2), device="cpu")
    assert len(zeros) == 4 and all(z.shape == (3, 2) and not z.any() for z in zeros)


# ------------------------------------------------------------------- iir2


def _iir2_numpy(f, p1, p2, y1, y2, fused: bool):
    """numpy f32 recurrence: each op rounded (the C order), or each
    mul-sub done as one fused op (the f64 product of two f32 values is
    exact, the f64 difference of it and an f32 value rounds the same as an
    FMA on these magnitudes)."""
    y = np.zeros_like(f)
    c1, c2 = y1.copy(), y2.copy()
    for t in range(f.shape[-1]):
        if fused:
            r = (f[:, t].astype(np.float64) - p1.astype(np.float64) * c1).astype(F32)
            v = (r.astype(np.float64) - p2.astype(np.float64) * c2).astype(F32)
        else:
            v = (f[:, t] - p1 * c1) - p2 * c2
        y[:, t] = v
        c1, c2 = v, c1
    return y


def test_iir2_sequential_c_order():
    """The port solves iir2 in the C reference's order, bit-exact against a
    numpy recomputation; JAX on the CPU matches the FMA-contracted
    recomputation instead (XLA contracts both mul-subs), so against JAX the
    port agrees to f32 rounding of the recurrence."""
    rng = np.random.default_rng(0)
    B, T = 6, 700
    f = rng.standard_normal((B, T)).astype(F32)
    p1 = rng.uniform(-1.5, 1.5, B).astype(F32)
    p2 = rng.uniform(0.1, 0.7, B).astype(F32)
    y1, y2 = rng.standard_normal(B).astype(F32), rng.standard_normal(B).astype(F32)
    yt, (lt, pt) = tscan.iir2_sequential(*map(torch.from_numpy, (f, p1, p2, y1, y2)))
    want = _iir2_numpy(f, p1, p2, y1, y2, fused=False)
    assert_bits_equal(yt, want)
    assert_bits_equal(lt, want[:, -1])
    assert_bits_equal(pt, want[:, -2])

    yj, (lj, pj) = jscan.iir2_sequential(*map(jnp.asarray, (f, p1, p2, y1, y2)))
    assert_bits_equal(yj, _iir2_numpy(f, p1, p2, y1, y2, fused=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5 * scale)


def test_iir2_sequential_short_and_state_only():
    rng = np.random.default_rng(1)
    p1, p2, y1, y2 = (rng.standard_normal(3).astype(F32) * F32(0.5) for _ in range(4))
    for T in (0, 1, 2):
        f = rng.standard_normal((3, T)).astype(F32)
        yt, (lt, pt) = tscan.iir2_sequential(*map(torch.from_numpy, (f, p1, p2, y1, y2)))
        want = _iir2_numpy(f, p1, p2, y1, y2, fused=False)
        hist = np.concatenate([y2[:, None], y1[:, None], want], -1)
        assert_bits_equal(yt, want)
        assert_bits_equal(lt, hist[:, -1])
        assert_bits_equal(pt, hist[:, -2])


@pytest.mark.parametrize("valid_len", [None, 0, 5, 333])
def test_iir2_scan_matches_jax(valid_len):
    rng = np.random.default_rng(7)
    B, T = 5, 600
    f = rng.standard_normal((B, T)).astype(F32)
    p1 = rng.uniform(-1.2, 1.2, B).astype(F32)
    p2 = rng.uniform(0.1, 0.5, B).astype(F32)
    y1, y2 = rng.standard_normal(B).astype(F32), rng.standard_normal(B).astype(F32)
    vj = None if valid_len is None else jnp.int32(valid_len)
    yj, sj = jscan.iir2_scan(*map(jnp.asarray, (f, p1, p2, y1, y2)), valid_len=vj)
    yt, st = tscan.iir2_scan(*map(torch.from_numpy, (f, p1, p2, y1, y2)), valid_len=valid_len)
    n = T if valid_len is None else valid_len
    np.testing.assert_allclose(yt.numpy()[:, :n], np.asarray(yj)[:, :n], **FAST_TOL)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FAST_TOL)


# ------------------------------------------------------------ fast biquad


@pytest.mark.parametrize("form", ["scan", "conv"])
@pytest.mark.parametrize("valid_len", [None, 1500])
def test_biquad_fast_forms_match_jax(form, valid_len):
    """The associative-scan and truncated-IR forms against their JAX forms
    and against the exact form, at the JAX package's fast tolerance."""
    rng = np.random.default_rng(13)
    coeffs = jbq.biquad_init(jbq.biquad_lowpass(0.18), 1.0)
    fir_len = jbq.fir_len_for(coeffs) if form == "conv" else None
    x = rng.standard_normal((2, 2, 2048)).astype(F32)
    state = random_state(rng, (2, 2))
    vj = None if valid_len is None else jnp.int32(valid_len)
    yj, sj = jbq.biquad_apply(jnp.asarray(x), jnp.asarray(coeffs), jax_state(state), exact=False,
                              fir_len=fir_len, valid_len=vj)
    yt, st = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), torch_state(state),
                              exact=False, fir_len=fir_len, valid_len=valid_len)
    ye, se = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), torch_state(state),
                              exact=True, valid_len=valid_len)
    n = x.shape[-1] if valid_len is None else valid_len
    np.testing.assert_allclose(yt.numpy()[..., :n], np.asarray(yj)[..., :n], **FAST_TOL)
    np.testing.assert_allclose(yt.numpy()[..., :n], ye.numpy()[..., :n], **FAST_TOL)
    for a, b, c in zip(st, sj, se):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FAST_TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **FAST_TOL)


def test_biquad_fast_first_order_matches_jax():
    rng = np.random.default_rng(17)
    coeffs = np.array([0.3, 0.3, 0.0, -0.4, 0.0], F32)
    x = rng.standard_normal((3, 900)).astype(F32)
    state = random_state(rng, (3,))
    yj, _ = jbq.biquad_apply(jnp.asarray(x), jnp.asarray(coeffs), jax_state(state), exact=False,
                             first_order=True)
    yt, _ = tbq.biquad_apply(torch.from_numpy(x), torch.from_numpy(coeffs), torch_state(state),
                             exact=False, first_order=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FAST_TOL)


def test_exact_branch_reaches_the_kernel_wrapper(monkeypatch):
    """biquad_apply(exact=True) and iir2_sequential go through the kernel
    wrappers (which run the plain versions for CPU tensors)."""
    calls = []
    real_df1, real_iir2 = bk.biquad_df1_cuda, bk.iir2_sequential_cuda
    monkeypatch.setattr(bk, "biquad_df1_cuda", lambda *a, **k: calls.append(1) or real_df1(*a, **k))
    monkeypatch.setattr(bk, "iir2_sequential_cuda",
                        lambda *a, **k: calls.append(2) or real_iir2(*a, **k))
    x = torch.zeros((2, 8))
    z = torch.zeros(2)
    tbq.biquad_apply(x, torch.tensor([1.0, 0, 0, 0, 0]), (z, z, z, z), exact=True)
    tscan.iir2_sequential(x, z, z, z, z)
    assert calls == [1, 2]

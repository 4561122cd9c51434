"""Port parity, PCM quantization: the PyTorch ops must be byte-exact against
the JAX package's on the same numpy inputs, including the 8-bit bias, the
32-bit double sign-extension quirk and the x86 float->int cast emulation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esp_audio_libs_tpu.ops import quantization as jq
from esp_audio_libs_tpu_torch.ops import quantization as tq

torch.set_num_threads(2)

BITS = [8, 16, 24, 32]


def _packed(rng, lead, n, bits):
    return rng.integers(0, 256, size=(*lead, n * jq.bytes_per_sample(bits)), dtype=np.uint8)


@pytest.mark.parametrize("bits", BITS + [12, 20])
def test_unpack_pcm_exact(bits):
    rng = np.random.default_rng(bits)
    data = _packed(rng, (3,), 777, bits)
    # every sign-bit pattern of bytes 2 and 3 (the 32-bit quirk)
    if jq.bytes_per_sample(bits) == 4:
        data[0, :16] = [0, 0, 0x80, 0x80, 0, 0, 0x7F, 0x80, 0xFF, 0xFF, 0xFF, 0xFF, 0, 0, 0x80, 0]
    got = tq.unpack_pcm(torch.from_numpy(data), bits)
    ref = np.asarray(jq.unpack_pcm(jnp.asarray(data), bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", BITS + [12, 20])
def test_pack_pcm_exact(bits):
    rng = np.random.default_rng(100 + bits)
    x = rng.uniform(-1.2, 1.2, (2, 501)).astype(np.float32)
    s, _ = jq.float_to_int(jnp.asarray(x), bits)
    ref = np.asarray(jq.pack_pcm(s, bits))
    got = tq.pack_pcm(torch.from_numpy(np.array(s)), bits)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", BITS + [12])
@pytest.mark.parametrize("gain_db", [0.0, -6.0, 3.5])
def test_unpack_to_float_exact(bits, gain_db):
    rng = np.random.default_rng(7 + bits)
    data = _packed(rng, (2,), 600, bits)
    f = tq.gain_factor(bits, gain_db)
    got = tq.int_to_float(tq.unpack_pcm(torch.from_numpy(data), bits), f)
    ref = np.asarray(jq.int_to_float(jq.unpack_pcm(jnp.asarray(data), bits), f))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_planar2_and_interleave2_exact():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 4 * 513), dtype=np.uint8)
    t = torch.from_numpy(data)
    p_t = tq.unpack_pcm16_planar2(t)
    p_j = np.asarray(jq.unpack_pcm16_planar2(jnp.asarray(data)))
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    raw_t = tq.unpack_pcm16_planar2_raw(t)
    assert raw_t.dtype == torch.int16 and raw_t.shape == (3, 2, 513)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(jq.unpack_pcm16_planar2_raw(jnp.asarray(data))))
    mono = tq.unpack_pcm16_raw(t)
    np.testing.assert_array_equal(mono.numpy(), np.asarray(jq.unpack_pcm16_raw(jnp.asarray(data))))
    # interleave2 is the inverse, byte for byte, and equals the JAX packer
    back = tq.pack_pcm16_interleave2(p_t)
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.pack_pcm16_interleave2(jnp.asarray(p_j))))


def _hard_floats(rng):
    huge = np.array([3e9, -3e9, 1e30, -1e30, np.inf, -np.inf, np.nan, -np.nan,
                     2147483648.0, -2147483648.0, 2147483520.0, 65536.0, -65536.0], np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 0.99999994, -0.99999994, 1.0000001,
                      -1.0000001, 1e-40, -1e-40], np.float32)
    # exact .5 ties at every depth: k / 2^(bits) lands on x*scalar = k + 0.5
    ties = ((np.arange(-40, 40) + 0.5) / np.float32(2 ** 23)).astype(np.float32)
    ties16 = ((np.arange(-40, 40) + 0.5) / np.float32(32768)).astype(np.float32)
    ties8 = ((np.arange(-40, 40) + 0.5) / np.float32(128)).astype(np.float32)
    return np.concatenate([rng.uniform(-1.0, 1.0, 1500).astype(np.float32),
                           rng.uniform(-3.0, 3.0, 300).astype(np.float32),
                           huge, edges, ties, ties16, ties8])


@pytest.mark.parametrize("bits", BITS + [4, 12, 20])
def test_float_to_int_exact(bits):
    x = _hard_floats(np.random.default_rng(bits))
    s_t, c_t = tq.float_to_int(torch.from_numpy(x), bits)
    s_j, c_j = jq.float_to_int(jnp.asarray(x), bits)
    assert s_t.dtype == torch.int32 and c_t.dtype == torch.bool
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(tq.pack_pcm(s_t, bits).numpy(),
                                  np.asarray(jq.pack_pcm(s_j, bits)))


def test_float_to_int_x86_cast_semantics():
    """Hugely positive, infinite and NaN inputs clip to NEGATIVE full scale
    below 32 bits, as x86 cvttss2si makes them INT_MIN."""
    x = torch.tensor([3e9, np.inf, np.nan, -3e9], dtype=torch.float32)
    s, c = tq.float_to_int(x, 16)
    assert s.tolist() == [-32768] * 4 and c.all()


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_bytes_per_sample_and_range_check(bits):
    assert tq.bytes_per_sample(bits) == jq.bytes_per_sample(bits)
    with pytest.raises(ValueError):
        tq.bytes_per_sample(33)
    with pytest.raises(TypeError):
        tq.unpack_pcm(torch.zeros(4, dtype=torch.int16), 16)

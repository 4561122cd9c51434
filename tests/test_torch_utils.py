"""Port parity of utils/buffers.py and utils/debug.py.

- buffers: the pool cases of tests/test_buffers.py on the port's
  ``BufferPool`` and ``device_put_pooled``; a buffer released with a copy
  still in flight is not handed out until its event completes (a fake
  event here; a pinned, non-blocking copy on the card in the ``cuda``
  test); ``donate`` has no counterpart in the port.
- debug: the two cases of tests/test_debug_checks.py on the port's
  ``polyphase_banded`` + ``float_to_int`` + ``pack_pcm`` pipeline: the clean
  pipeline's checked output equals its unchecked output, which equals
  JAX's; a NaN input raises. Further: a NaN made inside the pipeline and
  quantized away raises at the op, as checkify does; so does an Inf; the
  uninitialised outputs of the factory ops are not inspected.
"""

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.ops import quantization as q
from esp_audio_libs_tpu_torch.utils.buffers import BufferPool, default_pool, device_put_pooled
from esp_audio_libs_tpu_torch.utils.debug import NumericCheckError, checked, checked_call

# ------------------------------------------------------------------ buffers


def test_pool_recycles_by_shape_dtype():
    pool = BufferPool(max_per_key=2)
    a = pool.acquire((64,), np.int32)
    pool.release(a)
    b = pool.acquire((64,), np.int32)
    assert b is a and pool.hits == 1 and pool.misses == 1
    c = pool.acquire((64,), np.float32)   # another dtype: a new buffer
    assert c is not a and pool.misses == 2
    pool.release(b)
    pool.release(c)
    pool.clear()
    assert pool.acquire((64,), np.int32) is not b


def test_pool_bounded():
    pool = BufferPool(max_per_key=1)
    a, b = pool.acquire((8,), np.int8), pool.acquire((8,), np.int8)
    pool.release(a)
    pool.release(b)   # dropped: the key already holds max_per_key
    assert pool.acquire((8,), np.int8) is a
    assert pool.acquire((8,), np.int8) is not b


def test_lease_context_manager():
    pool = BufferPool()
    with pool.lease((16,), np.int16) as buf:
        buf[:] = 7
    with pool.lease((16,), np.int16) as again:
        assert again is buf


def test_device_put_pooled_round_trip():
    pool = BufferPool()
    x = device_put_pooled(lambda b: b.__setitem__(slice(None), np.arange(10)),
                          (10,), np.int32, device="cpu", pool=pool)
    np.testing.assert_array_equal(x.numpy(), np.arange(10))
    # the staging buffer was recycled, and the result does not alias it
    again = pool.acquire((10,), np.int32)
    assert pool.hits == 1
    again[:] = -1
    np.testing.assert_array_equal(x.numpy(), np.arange(10))
    assert default_pool() is default_pool(False) is not default_pool(True)


class _FakeEvent:
    """A copy in flight until ``done`` is set."""

    def __init__(self):
        self.done = False
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_buffer_in_flight_is_not_reused():
    """A staging buffer released with the event of its asynchronous copy is
    not handed out before the event completes: reusing it would overwrite
    the bytes the copy is still reading."""
    pool = BufferPool(max_per_key=1)
    a = pool.acquire((32,), np.uint8)
    copy = _FakeEvent()
    pool.release(a, copy)
    b = pool.acquire((32,), np.uint8)
    assert b is not a and pool.misses == 2 and pool.hits == 0
    copy.done = True
    assert pool.acquire((32,), np.uint8) is a and pool.hits == 1
    # a buffer dropped past the bound, or by clear, waits for its copy first
    pool.release(a, None)
    late = _FakeEvent()
    pool.release(b, late)
    assert late.waited
    pending = _FakeEvent()
    pool.clear()
    pool.release(b, pending)
    pool.clear()
    assert pending.waited


def test_device_put_pooled_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_put_pooled(lambda b: None, (4,), np.int32, device="cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pinned_copies_do_not_corrupt_batches(cuda):
    """Many non-blocking copies from a pinned pool of 2 while a long kernel
    holds the stream: each batch on the card equals what was filled."""
    pool = BufferPool(max_per_key=2, pin_memory=True)
    big = torch.randn(4096, 4096, device=cuda)
    outs = []
    for k in range(16):
        big = big @ big.T / 4096   # keep the stream busy so copies queue
        outs.append(device_put_pooled(lambda b, k=k: b.fill(k), (1 << 20,), np.int32,
                                      device=cuda, pool=pool))
    torch.cuda.synchronize()
    for k, o in enumerate(outs):
        assert bool((o == k).all()), f"batch {k} corrupted"


# -------------------------------------------------------------------- debug


def _pipeline(x, Wt, starts):
    out = pk.polyphase_banded_cuda(x, Wt, starts, T=128)
    samples, clipped = q.float_to_int(out.reshape(out.shape[0], -1), 16)
    return q.pack_pcm(samples, 16), clipped.to(torch.int64).sum()


def _jax_pipeline(x, Wt, starts):
    # JAX is imported here, not at the top: the card's machine has no JAX
    # and runs this file's ``cuda`` test with ``--noconftest``
    import jax.numpy as jnp

    from esp_audio_libs_tpu.ops import quantization as jq
    from esp_audio_libs_tpu.ops.polyphase import polyphase_banded as jax_banded

    out = jax_banded(x, Wt, starts, T=128)
    samples, clipped = jq.float_to_int(out.reshape(out.shape[0], -1), 16)
    return jq.pack_pcm(samples, 16), jnp.sum(clipped.astype(jnp.uint32))


def _args(poison=False):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 512)).astype(np.float32) * 0.2
    if poison:
        x[1, 0, 37] = np.nan
    Wt = rng.standard_normal((1, 256, 128)).astype(np.float32) * 0.01
    starts = np.zeros(1, np.int32)
    return x, Wt, starts


def test_clean_pipeline_passes_and_matches():
    args = [torch.from_numpy(a) for a in _args()]
    ref = _pipeline(*args)
    got = checked(_pipeline)(*args)
    assert torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
    want = _jax_pipeline(*_args())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])


def test_nan_input_raises():
    with pytest.raises(NumericCheckError, match="NaN"):
        checked(_pipeline)(*(torch.from_numpy(a) for a in _args(poison=True)))


def test_nan_made_inside_raises_at_the_op():
    """The pipeline's quantizer maps NaN to a number, so the result looks
    clean: the check must fire at the op that made the NaN."""
    x, Wt, starts = (torch.from_numpy(a) for a in _args())

    def poisoned(x, Wt, starts):
        y = x * (x.abs() < 1e9).float()      # clean
        y[1, 0, 37] = 0.0
        y = y / y.abs().clamp_max(1.0)         # 0 / 0 at one sample
        return _pipeline(y, Wt, starts)

    packed, _ = poisoned(x, Wt, starts)       # unchecked: no NaN left in the result
    assert packed.dtype == torch.uint8
    with pytest.raises(NumericCheckError, match="NaN in the output of aten.div"):
        checked_call(poisoned, x, Wt, starts)


def test_inf_raises_and_factory_outputs_are_not_inspected():
    x = torch.ones(8)

    def overflow(x):
        return (x * 3e38 * 10.0).clamp(-1.0, 1.0)

    with pytest.raises(NumericCheckError, match="Inf"):
        checked_call(overflow, x)

    def fills_empty(x):
        buf = torch.empty(1 << 16)       # stale memory, possibly NaN bit patterns
        buf.fill_(2.0)
        return buf[:8] * x

    assert torch.equal(checked_call(fills_empty, x), torch.full((8,), 2.0))

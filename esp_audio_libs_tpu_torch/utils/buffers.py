"""Host staging pools: the port's counterpart of
esp_audio_libs_tpu/utils/buffers.py.

Host staging buffers are large reusable numpy arrays that parsed frames or
PCM are packed into before one transfer to the device. Allocating them per
call is the hot-loop malloc the reference avoids (src/memory_utils.cpp:11-32);
``BufferPool`` keeps them alive and recycles them by (shape, dtype), so the
feed path allocates nothing in steady state.

For the card the pool can hold page-locked (pinned) buffers, which let the
copy run asynchronously (``non_blocking=True``). Such a buffer must not be
handed out again while its copy is still reading it: ``release`` takes the
CUDA event recorded after the copy, and ``acquire`` reuses the buffer only
once that event has completed.

The JAX package's ``donate`` (a ``jax.jit`` with donated arguments) has no
eager PyTorch counterpart: eager ops allocate their outputs, and the port's
decoders update their carried state in place where it pays.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..runtime.kernels import entry_device
from ..runtime.trace import span

__all__ = ["BufferPool", "default_pool", "device_put_pooled"]


class BufferPool:
    """Reusable host staging arrays, keyed by (shape, dtype).

    ``acquire`` returns an array with stale contents (the caller overwrites
    it); ``release`` returns it for reuse, optionally with a ``ready`` object
    (a ``torch.cuda.Event``: anything with ``query()``) that must complete
    before the array is handed out again. Thread-safe; bounded per key, so a
    burst cannot pin unbounded host memory (a release beyond the bound, or
    ``clear``, waits for ``ready`` and drops the array).

    Args:
      max_per_key: arrays kept per (shape, dtype).
      pin_memory: allocate page-locked arrays (needs CUDA), for asynchronous
        copies to the card.
    """

    def __init__(self, max_per_key: int = 4, pin_memory: bool = False):
        self._free: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self._max = max_per_key
        self.pin_memory = pin_memory
        self.hits = 0
        self.misses = 0

    def acquire(self, shape, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            stack = self._free.get(key, [])
            for i, (arr, ready) in enumerate(stack):
                if ready is None or ready.query():
                    del stack[i]
                    self.hits += 1
                    return arr
            self.misses += 1
        if self.pin_memory:
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def release(self, arr: np.ndarray, ready=None) -> None:
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self._max:
                stack.append((arr, ready))
                return
        if ready is not None:   # dropped: its memory must outlive the copy
            with span("eal.wait"):
                ready.synchronize()

    def clear(self) -> None:
        with self._lock:
            dropped, self._free = self._free, {}
        for stack in dropped.values():
            for _arr, ready in stack:
                if ready is not None:
                    with span("eal.wait"):
                        ready.synchronize()

    class _Lease:
        def __init__(self, pool, arr):
            self.pool, self.array = pool, arr

        def __enter__(self):
            return self.array

        def __exit__(self, *exc):
            self.pool.release(self.array)
            return False

    def lease(self, shape, dtype):
        """``with pool.lease((n,), np.int32) as buf: ...`` scoped acquire."""
        return self._Lease(self, self.acquire(shape, dtype))


@functools.lru_cache(None)
def _process_pool(pin_memory: bool) -> BufferPool:
    return BufferPool(pin_memory=pin_memory)


def default_pool(pin_memory: bool = False) -> BufferPool:
    """The process-wide pool (one pageable, one pinned)."""
    return _process_pool(bool(pin_memory))


def device_put_pooled(host_fill, shape, dtype, device="cuda", pool: BufferPool | None = None):
    """Stage-through-pool transfer: acquire a host buffer, let ``host_fill``
    write into it, ship it to ``device`` in one copy and recycle the buffer.

    On the card the default pool is pinned and the copy is asynchronous; the
    buffer goes back to the pool with the event recorded after the copy, so
    a later ``acquire`` cannot overwrite it mid-copy. On the CPU the result
    is a copy (the staging buffer is reused). ``device="cuda"`` without a
    card raises. Returns the device tensor.
    """
    dev = entry_device(device, "device_put_pooled")
    on_card = dev.type == "cuda"
    pool = pool or default_pool(pin_memory=on_card)
    buf = pool.acquire(shape, dtype)
    host_fill(buf)
    src = torch.from_numpy(buf)
    if not on_card:
        pool.release(buf)
        return src.clone()
    out = src.to(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    pool.release(buf, done)
    return out

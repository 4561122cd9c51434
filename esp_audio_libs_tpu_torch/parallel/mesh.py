"""The stream mesh: a split of the stream (batch) axis over devices.

The counterpart of esp_audio_libs_tpu/parallel/mesh.py. The reference is one
decoder instance per stream and leaves parallelism to the caller; the JAX
package shards the stream axis of every ``[batch, ...]`` tensor over a 1-D
device mesh with ``jax.sharding``. Eager PyTorch has no sharded tensor, so
the port makes the split explicit:

- :class:`StreamMesh` is the ordered device list (``devices``, ``size``);
- :func:`shard_streams` cuts one axis of a tensor into ``size`` contiguous
  blocks, block ``i`` on ``devices[i]``, and returns a :class:`Sharded`
  holder of the per-shard tensors;
- every entry point that takes a ``mesh`` runs its work block by block, one
  kernel launch per shard, with the per-stream state kept per shard;
- :func:`is_split` is the one rule for when that happens (a mesh of more
  than one device; None and a one-device mesh take the single-device
  route, as the JAX package's ``mesh.size > 1`` tests do), :func:`place`
  splits a per-stream tensor under it, and :func:`to_numpy` brings a
  tensor or a holder back to the host whole.

The JAX layout objects ``batch_sharding`` and ``axis_sharding`` have no
look-alikes here: their counterpart is the ``axis`` that a :class:`Sharded`
holder carries (0 for batch-major tensors, 1 for the granule-major MP3 run
tensors ``[G, B, ...]``).

An explicit device list may name a device more than once:
``stream_mesh(["cuda:0"] * 4)`` runs a 4-way split on one card, as the JAX
package's tests run their mesh on 8 virtual CPU devices. A mesh is all
``cpu`` or all ``cuda``; a ``cuda`` mesh needs a card. Nothing pads: a split
that does not divide raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..runtime.kernels import entry_device
from ..runtime.trace import span

__all__ = ["StreamMesh", "Sharded", "stream_mesh", "shard_streams", "shard_streams_axis",
           "is_split", "place", "to_numpy"]


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """An ordered 1-D list of devices; a device may appear more than once."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def type(self) -> str:
        """``"cpu"`` or ``"cuda"``: every device of a mesh has the same type."""
        return self.devices[0].type

    def distinct(self) -> list:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices))


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        entry_device(dev, "stream_mesh")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"stream_mesh: {dev} does not exist "
                             f"({torch.cuda.device_count()} visible CUDA device(s))")
    elif dev.type != "cpu":
        raise ValueError(f"stream_mesh: unsupported device {dev}: expected cpu or cuda")
    return dev


def stream_mesh(devices=None) -> StreamMesh:
    """A 1-D mesh over ``devices`` (anything ``torch.device`` takes), or over
    every visible CUDA device when ``devices`` is None. Raises
    ``RuntimeError`` for a ``cuda`` device without a card and ``ValueError``
    for an empty list, a list that mixes ``cpu`` and ``cuda``, or a device
    that does not exist."""
    if devices is None:
        entry_device("cuda", "stream_mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("stream_mesh: no devices")
    types = {torch.device(d).type for d in devices}
    if len(types) > 1:
        raise ValueError(f"stream_mesh: a mesh is all cpu or all cuda, got {sorted(types)}")
    return StreamMesh(tuple(_mesh_device(d) for d in devices))


def _put(x, device: torch.device) -> torch.Tensor:
    """A block (tensor or numpy) on ``device``: host blocks bound for the card
    go through pinned memory with a non-blocking copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_numpy(t) -> np.ndarray:
    """A tensor as numpy on the host, downloaded into pinned memory from the
    card; a :class:`Sharded` holder comes back whole."""
    if isinstance(t, Sharded):
        return np.concatenate([to_numpy(p) for p in t.parts], axis=t.axis)
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    with span("eal.wait"):
        torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


class Sharded:
    """A tensor split along ``axis`` into contiguous blocks, block ``i`` on
    ``mesh.devices[i]``: the torch form of a stream-sharded ``jax.Array``.

    ``parts`` are the per-shard tensors; ``shape`` the global shape;
    :meth:`gather` puts the whole tensor on one device.
    """

    __slots__ = ("parts", "axis", "mesh")

    def __init__(self, parts, axis: int, mesh: StreamMesh):
        parts = list(parts)
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for a {mesh.size}-device mesh")
        self.parts, self.axis, self.mesh = parts, axis, mesh

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first device by default)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.parts], dim=self.axis)

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every block; the result is split along the same axis."""
        return Sharded([fn(p) for p in self.parts], self.axis, self.mesh)

    def block_rows(self) -> list:
        """Per shard, the ``(start, stop)`` of its block along ``axis``."""
        bounds, start = [], 0
        for p in self.parts:
            bounds.append((start, start + p.shape[self.axis]))
            start += p.shape[self.axis]
        return bounds


def shard_streams(x, mesh: StreamMesh, axis: int = 0) -> Sharded:
    """Split ``x`` (a tensor on any device, a numpy array, or a
    :class:`Sharded` holder) along ``axis`` into ``mesh.size`` contiguous
    blocks, block ``i`` on ``mesh.devices[i]``. A holder already split along
    ``axis`` over ``mesh`` is returned as it is. Pads nothing: raises
    ``ValueError`` when the axis does not divide by the mesh size (callers
    bucket batches to a multiple of it, as the JAX package's do)."""
    if isinstance(x, Sharded):
        if x.axis == axis and x.mesh == mesh:
            return x
        x = x.gather()
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} must divide over the "
                         f"{mesh.size}-device mesh")
    blk = n // mesh.size
    parts = []
    for i, dev in enumerate(mesh.devices):
        if isinstance(x, torch.Tensor):
            block = x.narrow(axis, i * blk, blk)
        else:
            block = np.take(x, np.arange(i * blk, (i + 1) * blk), axis=axis)
        parts.append(_put(block, dev).contiguous())
    return Sharded(parts, axis, mesh)


def shard_streams_axis(x, axis: int, mesh: StreamMesh) -> Sharded:
    """:func:`shard_streams` with the JAX package's argument order: the MP3
    run tensors are granule-major ``[G, B, ...]``, so their stream axis is 1."""
    return shard_streams(x, mesh, axis=axis)


def is_split(mesh) -> bool:
    """Whether work over ``mesh`` splits: a mesh of more than one device.
    None and a one-device mesh take the single-device route."""
    return mesh is not None and mesh.size > 1


def place(x, mesh, axis: int = 0):
    """``x`` split along ``axis`` over ``mesh`` (:func:`shard_streams`) when
    the mesh splits, else ``x`` itself."""
    return shard_streams(x, mesh, axis) if is_split(mesh) else x

"""Multi-device splits of the port: the stream mesh (``mesh``: the batch
axis cut into per-device blocks) and sequence parallelism (``sequence``: one
long stream's time axis cut into per-device segments)."""

from .mesh import (Sharded, StreamMesh, is_split, place, shard_streams, shard_streams_axis,  # noqa: F401
                   stream_mesh, to_numpy)

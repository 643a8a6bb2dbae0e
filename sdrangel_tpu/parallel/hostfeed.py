"""Host-sharded `.sdriq` feeding for the time-sharded pipeline.

The reference distributes raw I/Q between machines with the SDRdaemon
UDP+FEC data plane (plugins/samplesource/sdrdaemonsource/
sdrdaemonsourcebuffer.h:27-85). On a multi-host mesh the equivalent is each
host memory-mapping its slice of the recording and materialising ONLY the
addressable shards of a globally time-sharded `jax.Array`
(`jax.make_array_from_callback`): no sample crosses between hosts — the
array is assembled shard-by-shard on the hosts that own the devices, and
the halo exchange afterwards rides the device interconnect inside the mesh
(parallel/sharded.py).

Works identically on one host with N local devices (each shard is a
different slice of the same mmap) and on multi-host meshes under
`jax.distributed` (each host's callback only ever receives the index
ranges of its own shards, so it only touches its slice of the file).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io import sdriq


class ShardedSdriqFeeder:
    """Per-block globally-sharded int16 I/Q arrays from a `.sdriq` file.

    Each call to `block(b)` returns a `(block_size, 2)` int16 `jax.Array`
    sharded `P("time")` over the mesh, whose shard t holds global samples
    `[b·B + t·B/n_time, b·B + (t+1)·B/n_time)`, read straight from the mmap
    (looping at EOF like the reference file source,
    filesourcethread.cpp:188-195).
    """

    def __init__(self, path: str, mesh: Mesh, block_size: int, wrap: bool = True):
        self.info, self._mm = sdriq.open_mmap(path)
        if self.info.sample_size != 16:
            raise ValueError("sharded feeder currently expects 16-bit captures")
        self.mesh = mesh
        self.block_size = int(block_size)
        self.wrap = wrap
        n_time = mesh.shape["time"]
        if self.block_size % n_time:
            raise ValueError(f"block_size {block_size} not divisible by time axis {n_time}")
        self.sharding = NamedSharding(mesh, P("time", None))

    @property
    def n_samples(self) -> int:
        return self._mm.shape[0]

    def n_blocks(self) -> int:
        return self._mm.shape[0] // self.block_size

    def block(self, b: int) -> jax.Array:
        base = b * self.block_size
        if not self.wrap and base + self.block_size > self.n_samples:
            raise EOFError

        def cb(index):
            # index: the global ndindex of one shard — only called for
            # shards addressable from this host/process.
            sl = index[0]
            start = base + (sl.start or 0)
            count = (sl.stop if sl.stop is not None else self.block_size) - (sl.start or 0)
            return np.ascontiguousarray(
                sdriq.read_block(self._mm, start, count, wrap=self.wrap)
            )

        return jax.make_array_from_callback(
            (self.block_size, 2), self.sharding, cb
        )

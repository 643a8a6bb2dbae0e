"""One process of a multi-host sharded-pipeline run (CPU-mesh analog).

The reference validates its distributed path with two processes on one
machine (SDRdaemon over localhost UDP — SURVEY.md §4 "multi-node without a
cluster"); the analog here is two jax.distributed processes forming one
global device mesh, each feeding its own mmap slice of the capture
(parallel/hostfeed.py) — the same code path a real 2-host mesh runs.

Usage (launched n_processes times, e.g. by tests/test_multihost.py):
  python tools/multihost_worker.py --process-id I --num-processes N \
      --coordinator 127.0.0.1:PORT --capture cap.sdriq --out outdir \
      [--local-devices 4] [--blocks 2]

Each process writes outdir/audio_pI.npy with the audio of its addressable
channel shards plus their channel indices.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--capture", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--n-time", type=int, default=4)
    ap.add_argument("--n-channel", type=int, default=2)
    ap.add_argument("--log2-decim", type=int, default=3)
    ap.add_argument("--block", type=int, default=1 << 15)
    ap.add_argument("--n-channels", type=int, default=8)
    ap.add_argument("--offset-hz", type=float, default=20000.0)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sdrangel_tpu.parallel import sharded
    from sdrangel_tpu.parallel.hostfeed import ShardedSdriqFeeder

    cfg = sharded.ShardedPipelineConfig(
        n_time=args.n_time, n_channel=args.n_channel,
        log2_decim=args.log2_decim, block=args.block,
        n_channels=args.n_channels,
    )
    mesh = sharded.make_mesh(args.n_time, args.n_channel)  # global devices
    step, init_fn = sharded.build_sharded_step(cfg, mesh)
    state, carry = init_fn()
    feeder = ShardedSdriqFeeder(args.capture, mesh, cfg.block)
    offsets = jax.device_put(
        np.full(cfg.n_channels, args.offset_hz, np.float32),
        NamedSharding(mesh, P("channel")),
    )

    blocks = []
    for b in range(args.blocks):
        state, audio, carry = step(state, feeder.block(b), carry, offsets)
        # collect the audio rows this process hosts
        rows = {}
        for shard in audio.addressable_shards:
            r0 = shard.index[0].start or 0
            data = np.asarray(shard.data)
            for i in range(data.shape[0]):
                rows[r0 + i] = data[i]
        blocks.append(rows)

    idxs = sorted(blocks[0])
    out = np.stack([
        np.concatenate([blk[i] for blk in blocks], axis=-1) for i in idxs
    ])
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, f"audio_p{args.process_id}.npy"), out)
    np.save(os.path.join(args.out, f"rows_p{args.process_id}.npy"),
            np.asarray(idxs, np.int32))
    print(f"process {args.process_id}: rows {idxs} ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

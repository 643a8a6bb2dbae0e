"""Multi-device scaling benchmark for the sharded pipeline.

Measures the (time × channel)-sharded NFM bank step (parallel/sharded.py) at
1 device and at the full mesh, reporting samples/s and scaling efficiency —
the BASELINE.md "≥85% 2-host scaling efficiency" procedure. On GPUs it
reports device numbers; on the CPU virtual mesh it validates execution
and prints (meaningless) host timings clearly marked as such.

Usage:
  python tools/scaling_bench.py [--devices N] [--channels C] [--block LOG2]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__))))


def run(n_time: int, n_channel: int, n_channels: int, block: int, iters: int = 10):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sdrangel_tpu.parallel import sharded

    cfg = sharded.ShardedPipelineConfig(
        n_time=n_time, n_channel=n_channel, log2_decim=6,
        block=block, n_channels=n_channels,
    )
    mesh = sharded.make_mesh(n_time, n_channel)
    step, init_fn = sharded.build_sharded_step(cfg, mesh)
    state, carry = init_fn()
    rng = np.random.default_rng(1)
    raw = jnp.asarray(rng.integers(-2048, 2048, size=(cfg.block, 2), dtype=np.int16))
    offsets = jnp.zeros(cfg.n_channels, jnp.float32)

    state, audio, carry = step(state, raw, carry, offsets)
    audio.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, audio, carry = step(state, raw, carry, offsets)
    audio.block_until_ready()
    el = time.perf_counter() - t0
    return cfg.block * iters / el


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--block-log2", type=int, default=20)
    args = p.parse_args()

    import jax

    n_dev = args.devices or len(jax.devices())
    platform = jax.devices()[0].platform
    block = 1 << args.block_log2

    single = run(1, 1, args.channels, block)
    if n_dev >= 2:
        n_time = n_dev // 2 if n_dev >= 4 else n_dev
        n_chan = 2 if n_dev >= 4 else 1
        full = run(n_time, n_chan, args.channels, block)
        eff = full / (single * n_time * n_chan)
    else:
        full, eff = single, 1.0

    print(json.dumps({
        "platform": platform,
        "note": "host-timed; meaningful only on real accelerator meshes"
        if platform == "cpu" else "device-timed",
        "devices": n_dev,
        "single_msps": round(single / 1e6, 1),
        "mesh_msps": round(full / 1e6, 1),
        "scaling_efficiency": round(eff, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

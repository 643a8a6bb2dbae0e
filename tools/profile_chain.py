"""Stage-decomposition timing of the bench chain on real hardware.

Times cumulative prefixes of the decimate->channelize->NFM16 chain so the
per-stage cost (and the dispatch-bound tail) is visible. Usage:
    python tools/profile_chain.py [log2block]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from sdrangel_tpu.channels import demod_nfm
from sdrangel_tpu.dsp import channelizer as chanmod
from sdrangel_tpu.dsp import decimators as dec
from sdrangel_tpu.dsp import firdesign, goertzel, movingavg, nco, phasediscri, resampler, squelch

log2 = 6
block = 1 << int(sys.argv[1] if len(sys.argv) > 1 else 23)
n_channels = 16
device_rate = 12_288_000.0
baseband_rate = device_rate / (1 << log2)
req_band = baseband_rate / 6.0
leaf = baseband_rate / 8.0
offsets = np.array([
    c + j
    for c in (-3 * leaf, -leaf, leaf, 3 * leaf)
    for j in (-0.18 * leaf, -0.06 * leaf, 0.06 * leaf, 0.18 * leaf)
])
plans = [chanmod.plan_channel(baseband_rate, req_band, o) for o in offsets]
n_stages = len(plans[0].signs)
signs = np.array([p.signs for p in plans])
residual = np.asarray([p.residual_offset for p in plans], np.float32)
chan_rate = plans[0].channel_rate

cfg = demod_nfm.NFMConfig(
    channel_rate=chan_rate,
    block_in=(block >> log2) >> n_stages,
    squelch_db=-100.0,
    squelch_gate_ms=1.0,
)
plan = cfg.resampler_plan

rng = np.random.default_rng(7)
raw = jnp.asarray(rng.integers(-2048, 2048, size=(block, 2), dtype=np.int16))

casc0 = jax.jit(lambda: dec.init_flat_state(log2))()
cstate0 = jax.jit(
    lambda: chanmod.init_state(n_stages, batch_shape=(chanmod.unique_paths(signs),))
)()
dstate0 = jax.jit(lambda: demod_nfm.make_state(cfg, batch_shape=(n_channels,)))()


def stage_decim(casc, raw):
    x = raw.astype(jnp.float32) * (1.0 / 32768.0)
    x = (x[..., 0] + 1j * x[..., 1]).astype(jnp.complex64)
    casc, bb = dec.decimate_flat_any(casc, x, log2, "cen")
    return casc, bb


def upto(n):
    """Build a jitted fn running the chain through sub-stage n of the NFM tail.
    n=0: decim only; 1: +channelize; 2: +nco; 3: +resample; 4: +discri;
    5: +mavg; 6: +squelchgate; 7: +bandpass (full)."""

    def f(casc, cstate, dstate, raw):
        casc, bb = stage_decim(casc, raw)
        if n == 0:
            return casc, bb
        cstate, y = chanmod.channelize_bank_unique(cstate, bb, signs)
        if n == 1:
            return casc, cstate, y
        inc = nco.freq_to_increment_traced(-residual, cfg.channel_rate)
        nst, xm = nco.mix_block(dstate.nco, y, inc)
        if n == 2:
            return casc, cstate, nst, xm
        rst, ci = resampler.resample_block(dstate.resamp, xm, plan)
        if n == 3:
            return casc, cstate, rst, ci
        dst, demod, magsq = phasediscri.discriminator_delta(dstate.discri, ci, cfg.fm_scaling)
        if n == 4:
            return casc, cstate, dst, demod, magsq
        mst, avg = movingavg.moving_average(dstate.mavg, magsq)
        if n == 5:
            return casc, cstate, mst, demod, avg
        open_cond = avg >= 10.0 ** (cfg.squelch_db / 10.0)
        sst, gated, is_open = squelch.gate_block(
            dstate.squelch, demod, open_cond, cfg.squelch_gate_samples
        )
        if n == 6:
            return casc, cstate, sst, gated
        bst, audio = firdesign.fir_apply(
            dstate.bandpass, gated, jnp.asarray(cfg.bandpass_taps)
        )
        return casc, cstate, bst, audio

    return jax.jit(f)


def timeit(f, iters=30):
    out = f(casc0, cstate0, dstate0, raw)
    jax.tree_util.tree_leaves(out)[-1].block_until_ready()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(casc0, cstate0, dstate0, raw)
        jax.tree_util.tree_leaves(out)[-1].block_until_ready()
        rates.append((time.perf_counter() - t0) / iters)
    return float(np.median(rates))


names = ["decim", "+chan", "+nco", "+resamp", "+discri", "+mavg", "+sqgate", "+bandpass"]
prev = 0.0
for n, name in enumerate(names):
    dt = timeit(upto(n))
    print(f"{name:10s} cum {dt*1e3:8.3f} ms  delta {(dt-prev)*1e3:8.3f} ms  "
          f"rate {block/dt/1e9:7.2f} GS/s")
    prev = dt

"""AGC — magnitude AGC with power squelch and smootherstep ramps.

Reference: sdrbase/dsp/agc.{h,cpp} — MagAGC::feedAndGetValue (agc.cpp:98-175):
gain u0 = R / avg(magsq) (power mode) or R / sqrt(avg) (magnitude mode),
optional clamping, power-threshold squelch with gate counter and step-down
delay, attack/release as smootherstep ramps over stepLength samples.

Block-parallel decomposition (all audio-rate):
  1. magsq moving average — windowed cumsum (movingavg.py);
  2. gate/stepDownDelay counters — saturating associative scans (scanops.py);
  3. the stepUp/stepDown ramp pair — a single saturating counter whose value
     IS the ramp position (the reference mirrors the two counters into each
     other at every flip: agc.cpp:149-175, so one position suffices);
  4. smootherstep(x)=6x⁵-15x⁴+10x³ applied elementwise (stepfunctions.h:24-35).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .movingavg import MovingAvgState, make_state as make_mavg, moving_average
from .scanops import saturating_counter


def smootherstep(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.clip(x, 0.0, 1.0)
    return x * x * x * (x * (6.0 * x - 15.0) + 10.0)


class MagAGCState(NamedTuple):
    mavg: MovingAvgState
    gate_counter: jnp.ndarray  # (...,) samples above threshold (up to gate)
    count: jnp.ndarray  # (...,) samples since signal (up to stepDownDelay)
    ramp: jnp.ndarray  # (...,) ramp position in [0, stepLength]


class MagAGCConfig(NamedTuple):
    order_r: float = 1.0  # target magnitude R
    history_size: int = 4800  # averaging length (attack)
    threshold: float = 0.0  # squelch threshold on magsq average
    threshold_enable: bool = True
    gate: int = 4  # samples over threshold before open
    step_length: int = 2400  # ramp length (max 50 ms at 48 kHz, agc.cpp:51)
    step_down_delay: int = 4800  # release delay
    squared: bool = False  # power (True) vs magnitude (False) mode
    clamping: bool = False
    clamp_max: float = 1.0


def make_state(cfg: MagAGCConfig, batch_shape=()) -> MagAGCState:
    return MagAGCState(
        mavg=make_mavg(cfg.history_size, batch_shape),
        gate_counter=jnp.zeros(batch_shape, dtype=jnp.float32),
        count=jnp.full(batch_shape, float(cfg.step_down_delay), dtype=jnp.float32),
        ramp=jnp.zeros(batch_shape, dtype=jnp.float32),
    )


def mag_agc(
    state: MagAGCState, x: jnp.ndarray, cfg: MagAGCConfig
) -> tuple[MagAGCState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Apply MagAGC to a complex block.

    x: (..., T) complex64. Returns (state', y, magsq, ramp) with y
    gain-controlled (and squelch-gated when threshold_enable) and ramp the
    per-sample smootherstep step value (getStepValue) so callers can apply
    the reference's read-side gating (ssbdemod.cpp:225 multiplies the
    DELAYED sample by the CURRENT step value a second time).
    """
    magsq = (jnp.real(x) ** 2 + jnp.imag(x) ** 2).astype(jnp.float32)
    mavg_state, avg = moving_average(state.mavg, magsq)
    avg = jnp.maximum(avg, 1e-30)
    if cfg.squared:
        u0 = cfg.order_r / avg
    else:
        u0 = cfg.order_r / jnp.sqrt(avg)
    if cfg.clamping:
        inst = magsq if cfg.squared else jnp.sqrt(magsq)
        clamp_gain = cfg.clamp_max / jnp.maximum(inst, 1e-30)
        u0 = jnp.where(inst > cfg.clamp_max, clamp_gain, u0)

    if not cfg.threshold_enable:
        y = x * u0.astype(jnp.complex64)
        return (MagAGCState(mavg_state, state.gate_counter, state.count,
                            state.ramp), y, magsq, jnp.ones_like(u0))

    # Squelch machinery (agc.cpp:128-175).
    over = magsq > cfg.threshold
    # gateCounter: +1 while over (clamped at gate), reset to 0 when under.
    # count: reset to 0 once gate passed; +1 while under (clamped at delay).
    # The pair of coupled counters is approximated by two saturating scans:
    # gate achievement uses a window: gate passed iff the last `gate` samples
    # were all over-threshold.
    gate_del = jnp.where(over, 1.0, -float(cfg.gate))
    gate_counts = saturating_counter(gate_del, 0.0, float(cfg.gate), state.gate_counter)
    gate_passed = gate_counts >= cfg.gate
    count_del = jnp.where(gate_passed, -float(cfg.step_down_delay), 1.0)
    counts = saturating_counter(
        count_del, 0.0, float(cfg.step_down_delay), state.count
    )
    signal_present = counts < cfg.step_down_delay
    ramp_del = jnp.where(signal_present, 1.0, -1.0)
    ramps = saturating_counter(ramp_del, 0.0, float(cfg.step_length), state.ramp)
    gain_ramp = smootherstep(ramps / float(cfg.step_length))
    y = x * (u0 * gain_ramp).astype(jnp.complex64)
    new_state = MagAGCState(mavg_state, gate_counts[..., -1], counts[..., -1], ramps[..., -1])
    return new_state, y, magsq, gain_ramp


class SimpleAGCState(NamedTuple):
    mavg: MovingAvgState


def make_simple_agc(avg_size: int, initial: float, batch_shape=()) -> SimpleAGCState:
    return SimpleAGCState(make_mavg(avg_size, batch_shape, fill=initial))


def simple_agc(
    state: SimpleAGCState,
    value: jnp.ndarray,
    cutoff: float = 0.0,
    clip: float = 0.0,
) -> tuple[SimpleAGCState, jnp.ndarray]:
    """SimpleAGC (agc.h:75-126): moving average of values above cutoff,
    floored at clip. Samples below cutoff keep the previous average; the block
    form feeds `max(value, running_avg_proxy)` — we approximate the
    conditional feed by substituting the cutoff for skipped samples."""
    fed = jnp.where(value > cutoff, value, jnp.float32(cutoff))
    mavg_state, avg = moving_average(state.mavg, fed)
    return SimpleAGCState(mavg_state), jnp.maximum(avg, clip)

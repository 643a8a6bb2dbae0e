"""Numerically-controlled oscillator — block-vectorized.

Reference: sdrbase/dsp/nco.{h,cpp} — 4096-entry cosine LUT, integer phase
accumulator, nextIQ() returning (cos φ, sin φ) = e^{+iφ} (nco.cpp:60-64:
imag = -cos(φ + T/4) = sin φ); NCOF float-phase variant (ncof.cpp).

Design: the per-sample accumulator becomes a closed-form phase ramp per
block with an integer carry. Default ("float") mode uses a 32-bit phase wheel
(increment = round(f/fs * 2^32), wrap = native uint32 overflow) and computes
exp via sin/cos. "lut" parity mode reproduces the reference's
truncated 12-bit table lookup and integer increment (nco.cpp:48-52) exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

TABLE_BITS = 12
TABLE_SIZE = 1 << TABLE_BITS  # reference nco.h:27
_WHEEL_BITS = 32


class NCOState(NamedTuple):
    phase: jnp.ndarray  # (...,) uint32 phase-wheel position


def make_nco(batch_shape=(), phase0: int = 0) -> NCOState:
    return NCOState(jnp.full(batch_shape, phase0, dtype=jnp.uint32))


def freq_to_increment(freq, sample_rate) -> np.ndarray:
    """Per-sample uint32 phase increment for f/fs (host side, float64)."""
    turns = np.asarray(freq, dtype=np.float64) / np.asarray(sample_rate, dtype=np.float64)
    inc = np.round((turns % 1.0) * (1 << _WHEEL_BITS)).astype(np.int64)
    return (inc & 0xFFFFFFFF).astype(np.uint32)


def freq_to_increment_ref_quant(freq, sample_rate) -> np.ndarray:
    """The reference NCO's frequency quantization (nco.cpp:48-52):
    `m_phaseIncrement = (freq * 4096) / sampleRate` assigned to an int —
    TRUNCATED toward zero, so the achievable tuning grid is fs/4096
    (~23.4 Hz at 96 kHz) and a requested offset can sit up to ±fs/8192 off
    (e.g. 5000 Hz at 96 kHz actually mixes −4992.1875 Hz, leaving the
    carrier +7.8125 Hz off DC — measured in the amsync96 golden, r5).
    Increments quantized to whole LUT steps make our uint32 wheel hit the
    exact same 4096-LUT indices as the reference. Test-only parity mode;
    the shipping default keeps the full 2^32-wheel resolution."""
    steps = np.trunc(
        np.asarray(freq, np.float64) * 4096.0
        / np.asarray(sample_rate, np.float64)).astype(np.int64)
    inc = steps * (1 << (_WHEEL_BITS - 12))
    return (inc & 0xFFFFFFFF).astype(np.uint32)


def freq_to_increment_traced(freq, sample_rate) -> jnp.ndarray:
    """Traced variant for per-channel offset arrays inside jit. f32 turns
    resolution (~2^-24 of fs) instead of the host float64 path."""
    turns = jnp.mod(jnp.asarray(freq, jnp.float32) / jnp.float32(sample_rate), 1.0)
    return (turns * jnp.float32(1 << _WHEEL_BITS)).astype(jnp.uint32)


_CHUNK = 128  # outer-product factor width (A/B on the H100: ROADMAP Design 3)


def _phasor(phase_u32: jnp.ndarray) -> jnp.ndarray:
    ang = phase_u32.astype(jnp.float32) * jnp.float32(
        2.0 * np.pi / (1 << _WHEEL_BITS)
    )
    return (jnp.cos(ang) + 1j * jnp.sin(ang)).astype(jnp.complex64)


def nco_block(
    state: NCOState, increment: jnp.ndarray, length: int
) -> tuple[NCOState, jnp.ndarray]:
    """Generate e^{+i φ[n]} for one block.

    increment: (...,) uint32 (broadcast against state.phase).
    Returns (state', iq) with iq: (..., length) complex64.

    Outer-product form: with n = 128·q + r, e^{iφ[n]} =
    e^{i(φ0 + 128·inc·q)} · e^{i·inc·r} — uint32 wheel arithmetic (exact
    wrap) only on the two factor vectors, one complex multiply per sample.
    The per-element transcendentals/uint32-multiplies of the naive ramp were
    67% of the NFM demod's device time (round-2 profile); factor rounding
    adds ~1e-7 phase error, far inside the 32-bit wheel's own f32 cast.
    """
    inc = jnp.asarray(increment, dtype=jnp.uint32)
    batch = jnp.broadcast_shapes(state.phase.shape, inc.shape)
    # φ[n] = φ0 + inc·(n+1): the reference NCO INCREMENTS BEFORE READING
    # (nco.cpp nextIQ -> nextPhase), so the first output already carries one
    # step. The convention is load-bearing for phase-sensitive consumers —
    # the SSB mono sum (re+im) read it as a constant e^{j·inc} rotation and
    # capped golden parity at ~20 dB until aligned (r4).
    if length % _CHUNK == 0 and length >= 2 * _CHUNK:
        q = jnp.arange(length // _CHUNK, dtype=jnp.uint32)
        r = jnp.arange(1, _CHUNK + 1, dtype=jnp.uint32)
        pq = state.phase[..., None] + (inc[..., None] * jnp.uint32(_CHUNK)) * q
        pr = inc[..., None] * r
        iq = _phasor(pq)[..., :, None] * _phasor(pr)[..., None, :]
        iq = iq.reshape(*batch, length)
    else:
        n = jnp.arange(1, length + 1, dtype=jnp.uint32)
        # uint32 arithmetic wraps — the wheel is exact over any stream length
        iq = _phasor(state.phase[..., None] + inc[..., None] * n)
        iq = jnp.broadcast_to(iq, (*batch, length))
    new_phase = state.phase + inc * jnp.uint32(length)
    return NCOState(new_phase), iq.astype(jnp.complex64)


def mix_block(
    state: NCOState, x: jnp.ndarray, increment: jnp.ndarray
) -> tuple[NCOState, jnp.ndarray]:
    """x * e^{+iφ[n]} — the `c *= m_nco.nextIQ()` idiom (nfmdemod.cpp:153)."""
    state, iq = nco_block(state, increment, x.shape[-1])
    return state, (x * iq).astype(jnp.complex64)


# ---------------------------------------------------------------------------
# LUT parity mode — bit-matches the reference's quantized oscillator.
# ---------------------------------------------------------------------------

_LUT = np.cos(2.0 * np.pi * np.arange(TABLE_SIZE) / TABLE_SIZE).astype(np.float32)


class NCOLutState(NamedTuple):
    phase: jnp.ndarray  # int32 in [0, TABLE_SIZE)


def make_nco_lut(batch_shape=(), phase0: int = 0) -> NCOLutState:
    return NCOLutState(jnp.full(batch_shape, phase0, dtype=jnp.int32))


def lut_increment(freq: float, sample_rate: float) -> int:
    """Integer truncation as in NCO::setFreq (nco.cpp:48-52)."""
    return int((freq * TABLE_SIZE) / sample_rate)


def nco_lut_block(
    state: NCOLutState, increment: int, length: int
) -> tuple[NCOLutState, jnp.ndarray]:
    """Reference-parity oscillator: increments *then* reads (nextPhase before
    table lookup, nco.h:45-55), cos from the 4096-entry table."""
    n = 1 + jnp.arange(length, dtype=jnp.int32)
    phases = jnp.mod(state.phase[..., None] + increment * n, TABLE_SIZE)
    lut = jnp.asarray(_LUT)
    re = lut[phases]
    im = -lut[jnp.mod(phases + TABLE_SIZE // 4, TABLE_SIZE)]
    new_phase = jnp.mod(state.phase + increment * length, TABLE_SIZE)
    return NCOLutState(new_phase), (re + 1j * im).astype(jnp.complex64)

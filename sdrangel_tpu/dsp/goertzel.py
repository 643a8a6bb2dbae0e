"""Goertzel tone detectors as matmuls: CTCSS and AF squelch tone banks.

Reference: sdrbase/dsp/ctcssdetector.cpp — per-sample feedback
u0 = in + coef*u0 - u1 over N-sample frames, then per-tone power
u0² + u1² − coef·u0·u1, which equals |Σ_n x[n] e^{-jωn}|². We compute that
power directly as two matmuls against cos/sin bases over framed input — the
32-tone bank becomes an (N × 2J) contraction per frame.
sdrbase/dsp/afsquelch.cpp is the same recurrence over 2 test tones with
per-frame moving average and attack/decay counting.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .precision import PRECISION

# The 32 EIA standard CTCSS tones (ctcssdetector.cpp:29-61).
CTCSS_TONES = np.array(
    [
        67.0, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5,
        91.5, 94.8, 97.4, 100.0, 103.5, 107.2, 110.9, 114.8,
        118.8, 123.0, 127.3, 131.8, 136.5, 141.3, 146.2, 151.4,
        156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8, 203.5,
    ],
    dtype=np.float64,
)


@functools.lru_cache(maxsize=16)
def _basis(tones_key: tuple, fs: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    tones = np.asarray(tones_key, dtype=np.float64)
    w = 2.0 * np.pi * tones / fs  # (J,)
    t = np.arange(n, dtype=np.float64)[:, None]  # (N,1)
    return (
        np.cos(t * w[None, :]).astype(np.float32),
        np.sin(t * w[None, :]).astype(np.float32),
    )


def goertzel_power(x_frames: jnp.ndarray, tones, fs: float) -> jnp.ndarray:
    """Per-frame per-tone Goertzel power.

    x_frames: (..., F, N) float32 framed audio. Returns (..., F, J) —
    identical to the reference's u0²+u1²−coef·u0·u1 power at frame ends.
    """
    n = x_frames.shape[-1]
    cos_b, sin_b = _basis(tuple(np.asarray(tones, dtype=np.float64).tolist()), fs, n)
    c = jnp.einsum("...fn,nj->...fj", x_frames, jnp.asarray(cos_b),
                   precision=PRECISION)
    s = jnp.einsum("...fn,nj->...fj", x_frames, jnp.asarray(sin_b),
                   precision=PRECISION)
    return (c * c + s * s).astype(jnp.float32)


class CtcssResult(NamedTuple):
    detected: jnp.ndarray  # (..., F) bool
    tone_index: jnp.ndarray  # (..., F) int32 argmax tone


def ctcss_detect(x_frames: jnp.ndarray, fs: float) -> CtcssResult:
    """CTCSSDetector::evaluatePower semantics (ctcssdetector.cpp:190-210):
    detected when maxPower > meanPower + 2.0 (arbitrary reference margin)."""
    p = goertzel_power(x_frames, tuple(CTCSS_TONES.tolist()), fs)
    max_p = jnp.max(p, axis=-1)
    idx = jnp.argmax(p, axis=-1).astype(jnp.int32)
    mean_p = jnp.mean(p, axis=-1)
    return CtcssResult(max_p > mean_p + 2.0, idx)


class AFSquelchState(NamedTuple):
    """Carried across blocks: per-tone power moving-average window and the
    attack/decay counter + open flag (afsquelch.cpp:200-240)."""

    avg_window: jnp.ndarray  # (..., nb_avg, J) recent frame powers
    squelch_count: jnp.ndarray  # (...,) float32
    is_open: jnp.ndarray  # (...,) bool


def make_af_squelch(nb_avg: int = 128, n_tones: int = 2, batch_shape=()) -> AFSquelchState:
    return AFSquelchState(
        jnp.zeros((*batch_shape, nb_avg, n_tones), dtype=jnp.float32),
        jnp.zeros(batch_shape, dtype=jnp.float32),
        jnp.zeros(batch_shape, dtype=bool),
    )


def af_squelch_run(
    state: AFSquelchState,
    x_frames: jnp.ndarray,
    fs: float,
    threshold: float,
    samples_attack: int,
    samples_decay: int,
    tones=(1000.0, 6000.0),
) -> tuple[AFSquelchState, jnp.ndarray]:
    """AF squelch over framed audio (frame length = reference N≈24 scaled to
    the block framing). Open condition per frame: the higher tone's averaged
    power is the weaker one and min/max < threshold (afsquelch.cpp:218-236);
    attack/decay via the saturating counter. Returns (state', open[..., F])."""
    from .scanops import saturating_counter

    p = goertzel_power(x_frames, tuple(tones), fs)  # (..., F, J)
    nb_avg = state.avg_window.shape[-2]
    ext = jnp.concatenate([state.avg_window, p], axis=-2)
    c = jnp.cumsum(ext, axis=-2)
    zeros = jnp.zeros_like(c[..., :1, :])
    c = jnp.concatenate([zeros, c], axis=-2)
    f = p.shape[-2]
    sums = c[..., nb_avg + 1 :, :] - c[..., 1 : f + 1, :]  # (..., F, J) windowed sums
    max_p = jnp.max(sums, axis=-1)
    min_p = jnp.min(sums, axis=-1)
    min_idx = jnp.argmin(sums, axis=-1)
    max_idx = jnp.argmax(sums, axis=-1)
    open_cond = (min_p / jnp.maximum(max_p, 1e-30) < threshold) & (min_idx > max_idx)
    deltas = jnp.where(open_cond, 1.0, -1.0)
    counts = saturating_counter(
        deltas, 0.0, float(samples_attack + samples_decay), state.squelch_count
    )
    is_open = counts >= samples_attack
    new_state = AFSquelchState(
        ext[..., f:, :], counts[..., -1], is_open[..., -1]
    )
    return new_state, is_open

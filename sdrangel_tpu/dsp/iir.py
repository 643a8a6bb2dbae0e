"""IIR filters as associative scans (first-order RC, biquad, deemphasis).

Reference: sdrbase/dsp/filterrc.{h,cpp} (single-pole RC lowpass/highpass used
for FM deemphasis), sdrbase/dsp/recursivefilters.{h,cpp} (2nd-order biquad
band-pass/reject). Per-sample recurrences become log-depth scans: a 1st-order
IIR is the EMA monoid; a biquad is a product of 2x2 companion matrices.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .precision import PRECISION


class Iir1State(NamedTuple):
    y1: jnp.ndarray  # (...,) previous output


def make_iir1(batch_shape=()) -> Iir1State:
    return Iir1State(jnp.zeros(batch_shape, dtype=jnp.float32))


def rc_lowpass(
    state: Iir1State, x: jnp.ndarray, timeconst_samples: float
) -> tuple[Iir1State, jnp.ndarray]:
    """y[t] = a*y[t-1] + (1-a)*x[t], a = exp(-1/timeconst) — LowPassFilterRC
    semantics (filterrc.cpp). Used for FM deemphasis (wfmdemod/bfmdemod)."""
    from .scanops import ema

    a = float(np.exp(-1.0 / timeconst_samples))
    y = ema(x, 1.0 - a, state.y1)
    return Iir1State(y[..., -1]), y


class BiquadState(NamedTuple):
    s: jnp.ndarray  # (..., 2) [y[t-1], y[t-2]]


def make_biquad(batch_shape=()) -> BiquadState:
    return BiquadState(jnp.zeros((*batch_shape, 2), dtype=jnp.float32))


def biquad(
    state: BiquadState,
    x: jnp.ndarray,
    b: tuple[float, float, float],
    a: tuple[float, float],
) -> tuple[BiquadState, jnp.ndarray]:
    """y[t] = b0 x[t] + b1 x[t-1] + b2 x[t-2] - a1 y[t-1] - a2 y[t-2].

    The feed-forward part is a 3-tap FIR; the feedback recurrence
    y[t] = u[t] - a1 y[t-1] - a2 y[t-2] is scanned as 2x2 matrix products.
    """
    b0, b1, b2 = b
    a1, a2 = a
    xm1 = jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
    xm2 = jnp.concatenate([jnp.zeros_like(x[..., :2]), x[..., :-2]], axis=-1)
    u = b0 * x + b1 * xm1 + b2 * xm2

    m = jnp.array([[-a1, -a2], [1.0, 0.0]], dtype=jnp.float32)
    mats = jnp.broadcast_to(m, (*u.shape, 2, 2))
    vecs = jnp.stack([u, jnp.zeros_like(u)], axis=-1)[..., None]  # (...,T,2,1)

    def compose(f, g):
        mf, vf = f
        mg, vg = g
        return (jnp.matmul(mg, mf, precision=PRECISION),
                jnp.matmul(mg, vf, precision=PRECISION) + vg)

    mm, vv = jax.lax.associative_scan(compose, (mats, vecs), axis=-3)
    s0 = state.s[..., None, :, None]  # (...,1,2,1)
    ys = (jnp.matmul(mm, s0, precision=PRECISION) + vv)[..., 0, 0]  # y[t]
    new_s = jnp.stack([ys[..., -1], ys[..., -2]], axis=-1)
    return BiquadState(new_s), ys.astype(jnp.float32)


def bandpass_biquad_coeffs(f0: float, fs: float, r: float = 0.97):
    """SecondOrderRecursiveFilter (recursivefilters.cpp) band-pass at f0."""
    w0 = 2.0 * np.pi * f0 / fs
    b = ((1.0 - r) , 0.0, -(1.0 - r))
    a = (-2.0 * r * np.cos(w0), r * r)
    return b, a

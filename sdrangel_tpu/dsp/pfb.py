"""Polyphase DFT filter-bank channelizer — the one-kernel alternative to
per-channel DownChannelizer trees for uniform channel grids.

The reference selects each channel with its own binary tree of half-band
stages (sdrbase/dsp/downchannelizer.cpp:250-287), costing O(stages) filter
passes PER CHANNEL. For a bank of channels on the uniform grid c·fs/M this
analysis bank computes ALL M channels in one pass: a P-taps-per-branch
polyphase contraction (one (F, P·M)×(P·M → M) tap reduction) followed by
a length-M FFT across branches (XLA batched FFT). SURVEY §7.1 names exactly
this design ("one polyphase/FFT channelizer kernel") for the 64-channel
configuration.

At M=64 the equivalent 64-path HB-tree bank produces an HLO too large to
compile (64 paths × depth-6 stages unroll to hundreds of convs), so the
PFB is the uniform-grid gear at every M; the tree remains for irregular
(non-uniform-grid) banks. For M≤4 the DFT across branches is explicit
butterflies (_dft_branches).

Math (critically sampled analysis, output rate fs/M per channel; frame-end
alignment):
    y_c[n] = (x ⊛ g_c)[nM + M−1],   g_c[m] = h[m]·e^{+j2πcm/M}
so channel c equals "bandpass at +c·fs/M then decimate by M" exactly —
np.convolve with g_c is the oracle the tests check against (the +j sign in
g_c makes channel c select the band CENTRED at +c·fs/M and mix it to
baseband). Splitting m = qM+r and substituting into the window/frame
layout gives v[n,k] = Σ_q h̃[q,k]·x_ext[(n+q)M+k] with h̃ the (P,M)-reshaped
prototype reversed along BOTH axes, then y[n] = FFT_k(v[n])·tw with the
constant per-channel twiddle tw_c = e^{−j2πc/M}. Streaming state is the
last (P−1)·M input samples (the polyphase tap history).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .precision import PRECISION


@functools.lru_cache(maxsize=32)
def prototype(m: int, taps_per_branch: int = 12, beta: float = 9.0,
              cutoff_scale: float = 1.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass of length M·P, cut at (fs/2M)·scale,
    normalized to unit DC gain per branch (so a DC input yields 1.0 on
    channel 0).

    Prototype spec (pinned in tests/test_pfb.py, r3): the PFB replaces the
    order-48 HB tree whose composite response has ≤0.04 dB passband ripple
    and −55.4 dB worst adjacent-band leakage (measured over every depth).
    At the default 12 taps/branch this design gives ≤0.25 dB droop at
    ±0.35·fs/M and ≤−85 dB adjacent-band max — strictly better than the
    tree. (8 taps/branch, the r2 default, was −37 dB adjacent / −0.96 dB
    droop — flipping the PFB gear on silently DEGRADED channel filtering.)"""
    n = m * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    fc = 0.5 / m * cutoff_scale
    h = 2.0 * fc * np.sinc(2.0 * fc * t) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float32)


class PfbState(NamedTuple):
    tail: jnp.ndarray  # (..., (P-1)·M) complex64 input history


def make_state(m: int, taps_per_branch: int = 12, batch_shape=()) -> PfbState:
    return PfbState(
        jnp.zeros((*batch_shape, (taps_per_branch - 1) * m), jnp.complex64)
    )


def analyze(state: PfbState, x: jnp.ndarray, m: int,
            h: np.ndarray | None = None) -> tuple[PfbState, jnp.ndarray]:
    """x: (..., T) complex64 with T a multiple of M. Returns
    (state', (..., T/M, M)): frame n, channel c = signal at centre c·fs/M
    (c interpreted mod M, i.e. c = M−1 is −fs/M), decimated by M.
    """
    if h is None:
        h = prototype(m)
    p = len(h) // m
    assert len(h) == p * m, "prototype length must be a multiple of M"
    t = x.shape[-1]
    assert t % m == 0, f"block length {t} must be a multiple of M={m}"

    ext = jnp.concatenate([state.tail, x], axis=-1)  # (..., (P-1+F)·M)
    f = t // m
    # frames of the extended signal: (..., P-1+F, M)
    frames = ext.reshape(*ext.shape[:-1], p - 1 + f, m)
    # tap tensor: both axes reversed (see module docstring derivation)
    h2 = np.ascontiguousarray(np.reshape(h, (p, m))[::-1, ::-1])
    # polyphase contraction v[n, k] = Σ_q h2[q, k] · frames[n+q, k] — the
    # contraction is DIAGONAL in the branch k, so it is P slice-multiply-
    # adds, not a matmul: slices, no gather, so XLA fuses it into one
    # memory-bound kernel.
    v = None
    for q in range(p):
        term = frames[..., q:q + f, :] * jnp.asarray(h2[q], jnp.float32)
        v = term if v is None else v + term
    tw = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
    y = _dft_branches(v, m) * jnp.asarray(tw)
    new_tail = ext[..., t:]
    return PfbState(new_tail), y.astype(jnp.complex64)


def _dft_branches(v: jnp.ndarray, m: int) -> jnp.ndarray:
    """DFT across the branch (last) axis. m=2/4 use explicit butterflies in
    place of an FFT call on a tiny minor axis with a huge batch (tuned on an
    earlier accelerator; the A/B on the H100 is ROADMAP Design 3)."""
    if m == 2:
        return jnp.stack([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], axis=-1)
    if m == 4:
        s02 = v[..., 0] + v[..., 2]
        d02 = v[..., 0] - v[..., 2]
        s13 = v[..., 1] + v[..., 3]
        d13 = v[..., 1] - v[..., 3]
        return jnp.stack(
            [s02 + s13, d02 - 1j * d13, s02 - s13, d02 + 1j * d13], axis=-1)
    return jnp.fft.fft(v, axis=-1)


def channel_freqs(m: int, fs: float) -> np.ndarray:
    """Centre frequency of each analysis channel (c mod M convention)."""
    c = np.arange(m)
    c = np.where(c <= m // 2, c, c - m)
    return c * fs / m


def oracle_channel(x: np.ndarray, m: int, c: int,
                   h: np.ndarray | None = None) -> np.ndarray:
    """NumPy oracle: channel c = np.convolve(x, h·e^{+j2πc·/M}) sampled at
    nM+M−1 (frame-end alignment, zero history — matches analyze() from
    make_state)."""
    if h is None:
        h = prototype(m)
    g = h * np.exp(2j * np.pi * c * np.arange(len(h)) / m)
    full = np.convolve(x.astype(np.complex128), g.astype(np.complex128))
    return full[m - 1::m][: len(x) // m].astype(np.complex64)


def analyze_select(state: PfbState, x: jnp.ndarray, m: int, sel,
                   h: np.ndarray | None = None) -> tuple[PfbState, jnp.ndarray]:
    """analyze() restricted to grid channels `sel` (static index array).

    When only C << M channels are wanted, the length-M FFT across branches
    (which materializes all M channels — (F, M) complex in HBM) is replaced
    by one (F, M) x (M, C) partial-DFT matmul, writing only the
    wanted (F, C). For the chain64 flagship (C=64 of M=256) this removes
    three quarters of the channelizer's output traffic.
    """
    if h is None:
        h = prototype(m)
    p = len(h) // m
    t = x.shape[-1]
    assert t % m == 0, f"block length {t} must be a multiple of M={m}"
    f = t // m
    ext = jnp.concatenate([state.tail, x], axis=-1)
    frames = ext.reshape(*ext.shape[:-1], p - 1 + f, m)
    h2 = np.ascontiguousarray(np.reshape(h, (p, m))[::-1, ::-1])
    v = None
    for q in range(p):
        term = frames[..., q:q + f, :] * jnp.asarray(h2[q], jnp.float32)
        v = term if v is None else v + term
    sel = np.asarray(sel)
    k = np.arange(m)
    # DFT row for channel c, including the per-channel twiddle tw_c
    w = np.exp(-2j * np.pi * np.outer(k, sel) / m) * np.exp(
        -2j * np.pi * sel / m)[None, :]
    # complex matmul composed as ONE real f32 matmul:
    # [vr vi] (F, 2M) @ [[Wr Wi], [-Wi Wr]] (2M, 2C) -> [yr yi]
    wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
    w2 = np.block([[wr, wi], [-wi, wr]])
    xr = jnp.concatenate([jnp.real(v), jnp.imag(v)], axis=-1)  # (..., F, 2M)
    y2 = jnp.einsum("...fk,kc->...fc", xr, jnp.asarray(w2),
                    precision=PRECISION)  # (..., F, 2C)
    c = len(sel)
    y = (y2[..., :c] + 1j * y2[..., c:]).astype(jnp.complex64)
    return PfbState(ext[..., t:]), y

"""Half-band decimator cascades — the north-star kernel.

Reference: sdrbase/dsp/decimators.h (Decimators<...>::decimateN_{cen,inf,sup},
23-4287) chained IntHalfbandFilterEO stages (inthalfbandfiltereo.h:37-870).
The reference runs a stateful per-sample C++ loop; here each ÷2 stage is a
block-processing pure function `(tail, x) -> (tail', y)` where the FIR is a
stride-2 "valid" convolution over the carried tail + current block, lowered
by XLA. The hot path runs the flat composed-filter form (decimate_flat_any)
below, one polyphase conv for the whole cascade.

Spectral placements (decimators.h decimateN_{cen,inf,sup} and
devicesamplesource.cpp:84-110 calculateFrequencyShift):
  cen — band at DC, plain lowpass+decimate;
  inf — band below centre: first stage rotates +fs/4 (storeSample sign/swap
        pattern [j,-1,-j,1], inthalfbandfiltereo.h:643-660), follow-up stages
        rotate -fs/4 until the residual shift is zero;
  sup — mirror image of inf.

The reference bakes the rotation into integer sign/swaps; we multiply by the
period-4 rotation sequence, which XLA fuses into the conv input. Unlike the
reference's fixed-point pipeline (gain 2 per stage, final /2^stages in
DownChannelizer::feed, downchannelizer.cpp:80-81) every stage here has unity
passband gain in float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .hbfilter import DECIMATORS_ORDER, hb_taps
from .precision import PRECISION


def _feature_block(n_out: int, max_b: int = 128) -> int:
    """Output positions per conv window: conv output FEATURES. A strided FIR
    has one output feature; grouping B positions into features through a
    banded tap matrix makes the conv B features wide, for ~(1 + s·B/L)×
    redundant window reads. The width 128 was tuned on an earlier
    accelerator; its A/B against the one-feature form on the H100 is queued
    (ROADMAP Design 3)."""
    b = max_b
    while b > 1 and n_out % b:
        b >>= 1
    return b


def _banded_taps(taps: jnp.ndarray, b: int, stride: int) -> jnp.ndarray:
    """(stride·B + L − stride, 1, B) HIO kernel K[stride·j + l, 0, j] = h[l]
    — channels-last, so the full-rate stream needs no transpose. Built with
    jnp ops so traced taps work; constant-folds for host taps."""
    rows = [
        jnp.pad(taps.astype(jnp.float32), (stride * j, stride * (b - 1 - j)))
        for j in range(b)
    ]
    return jnp.stack(rows, axis=-1)[:, None, :]


class CascadeState(NamedTuple):
    """Carried filter tails, one per ÷2 stage.

    tails[k] has shape (..., L-1) complex64 where L = order-1 taps; it is the
    last L-1 *input* samples of stage k (at rate fs / 2^k).
    """

    tails: tuple[jnp.ndarray, ...]


def placement_schedule(log2_decim: int, fc_pos: str) -> tuple[int, ...]:
    """Quarter-rate rotation sign per stage (+1 = +fs/4, -1 = -fs/4, 0 = none).

    Derived from the wanted-band offset of devicesamplesource.cpp:84-110:
    cen -> 0; inf -> -fs/2^(n+1) for n<3 else -fs/2^n; sup mirrored. Greedy
    residual tracking reproduces the reference cascades exactly, e.g.
    ÷16 inf = [Inf, Sup, Sup, Cen] (decimators.h:829-960).
    """
    if fc_pos == "cen" or log2_decim == 0:
        return (0,) * log2_decim
    sign = {"inf": -1, "sup": +1}[fc_pos]
    if log2_decim < 3:
        target = sign / float(1 << (log2_decim + 1))
    else:
        target = sign / float(1 << log2_decim)
    signs = []
    residual = target  # wanted-band centre in units of current rate
    for _ in range(log2_decim):
        if residual < 0:
            s = +1
        elif residual > 0:
            s = -1
        else:
            s = 0
        signs.append(s)
        residual = (residual + s / 4.0) * 2.0
    assert residual == 0.0, f"placement schedule failed: {log2_decim=} {fc_pos=}"
    return tuple(signs)


@functools.lru_cache(maxsize=None)
def _rotation_pattern(sign: int, length: int) -> np.ndarray | None:
    """Period-4 rotation sequence e^{i*sign*pi/2*n} tiled to `length`."""
    if sign == 0:
        return None
    assert length % 4 == 0, "block length must be a multiple of 4 for inf/sup"
    base = np.array([1, 1j * sign, -1, -1j * sign], dtype=np.complex64)
    return np.tile(base, length // 4)


def _conv_stride2_valid(ext: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 valid correlation along the last axis of a complex array.

    ext: (..., T_ext) complex64; taps: (L,) float32 (symmetric, so correlation
    equals convolution). Returns (..., (T_ext - L)//2 + 1) complex64.

    B consecutive output positions become conv output features via the
    banded tap matrix (see _feature_block); identical arithmetic.
    """
    batch_shape = ext.shape[:-1]
    t_ext = ext.shape[-1]
    l_taps = taps.shape[-1]
    n_out = (t_ext - l_taps) // 2 + 1
    b = _feature_block(n_out)
    # complex -> real and imaginary parts folded into the batch dimension
    lhs = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    lhs = lhs.reshape(-1, t_ext, 1)  # (2*prod(batch), T_ext, 1) NHC
    rhs = _banded_taps(taps, b, 2)  # (S, 1, B) HIO
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(2 * b,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        precision=PRECISION,
    )  # (N, n_out/B, B): feature j = output position q·B + j
    out = out.reshape(out.shape[0], n_out)
    out = out.reshape(2, *batch_shape, n_out) if batch_shape else out.reshape(2, n_out)
    return (out[0] + 1j * out[1]).astype(jnp.complex64)


def hb_decimate2(
    tail: jnp.ndarray, x: jnp.ndarray, taps: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One ÷2 half-band stage: (tail, x) -> (tail', y) with y at half rate.

    tail: (..., L-1) carried input samples; x: (..., T), T even.
    y[m] = sum_k h[k] * ext[2m + k], ext = [tail, x]  ->  (..., T//2).
    """
    ext = jnp.concatenate([tail, x], axis=-1)
    y = _conv_stride2_valid(ext, taps)
    new_tail = ext[..., x.shape[-1] :]  # last L-1 samples
    return new_tail, y


def init_state(
    log2_decim: int,
    batch_shape: Sequence[int] = (),
    order: int = DECIMATORS_ORDER,
) -> CascadeState:
    l_taps = order - 1
    tails = tuple(
        jnp.zeros((*batch_shape, l_taps - 1), dtype=jnp.complex64)
        for _ in range(log2_decim)
    )
    return CascadeState(tails)


def decimate_cascade(
    state: CascadeState,
    x: jnp.ndarray,
    log2_decim: int,
    fc_pos: str = "cen",
    order: int = DECIMATORS_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Full ÷2^k cascade with placement rotation; pure, jit/vmap/shard-friendly.

    x: (..., T) complex64, T a multiple of 4*2^k. Returns (state', y) with
    y: (..., T / 2^k) centred on the wanted band.
    """
    taps = jnp.asarray(hb_taps(order))
    signs = placement_schedule(log2_decim, fc_pos)
    tails = list(state.tails)
    y = x
    for k in range(log2_decim):
        rot = _rotation_pattern(signs[k], y.shape[-1])
        if rot is not None:
            y = y * jnp.asarray(rot)
        tails[k], y = hb_decimate2(tails[k], y, taps)
    return CascadeState(tuple(tails)), y


def decimate_reference_oracle(
    x: np.ndarray, log2_decim: int, fc_pos: str = "cen", order: int = DECIMATORS_ORDER
) -> np.ndarray:
    """NumPy oracle: same math, sequential, float64 — for unit tests."""
    h = hb_taps(order).astype(np.float64)
    signs = placement_schedule(log2_decim, fc_pos)
    y = x.astype(np.complex128)
    for k in range(log2_decim):
        if signs[k] != 0:
            n = np.arange(y.shape[-1])
            y = y * np.exp(1j * signs[k] * np.pi / 2.0 * n)
        ext = np.concatenate([np.zeros(len(h) - 1, dtype=np.complex128), y])
        full = np.convolve(ext, h[::-1], mode="valid")  # correlation
        y = full[::2]
    return y.astype(np.complex64)


# ---------------------------------------------------------------------------
# Flat (single-stage) form of the whole cen cascade
# ---------------------------------------------------------------------------
#
# The k chained ÷2 stages re-read every intermediate rate from HBM (~2×
# the input bytes in total intermediates). The LTI composition
# h_eq = h ∗ (h↑2) ∗ (h↑4) ∗ … collapses the cascade into ONE filter at the
# output grid: y[M] = Σ_l h_eq[l]·x[2^k·M − D + l], D = (order−2)·(2^k − 1). Decomposed into 2^k polyphase legs this is a single
# multi-input-channel conv: planes[j, i] = ext[2^k·i + j] and
# y[M] = Σ_j (legs_j ⋆ planes_j)[M] — one HBM pass over the input and ~3.7×
# the cascade's MACs (61-tap legs × 64 vs Σ 33/2^s), a good trade when the
# chain is memory-bound. cen placement only (inf/sup rotations make the
# cascade periodically time-varying; use decimate_cascade for those).


class FlatState(NamedTuple):
    tail: jnp.ndarray  # (..., 2^k·(t_leg−1)) carried input samples


@functools.lru_cache(maxsize=8)
def flat_equivalent_filter(log2_decim: int, order: int = DECIMATORS_ORDER) -> np.ndarray:
    h = hb_taps(order).astype(np.float64)
    h_eq = np.array([1.0])
    for s in range(log2_decim):
        up = np.zeros(((len(h) - 1) << s) + 1)
        up[:: 1 << s] = h
        h_eq = np.convolve(h_eq, up)
    return h_eq


@functools.lru_cache(maxsize=8)
def flat_legs(log2_decim: int, order: int = DECIMATORS_ORDER) -> np.ndarray:
    """(2^k, t_leg) float32 polyphase legs of h_eq, front-padded so leg
    convolution lands on the streaming cascade's output grid."""
    r = 1 << log2_decim
    h_eq = flat_equivalent_filter(log2_decim, order)
    d = (order - 2) * (r - 1)  # cascade group history (62·(2^k−1) for order 64)
    front = (-d) % r
    padded = np.concatenate([np.zeros(front), h_eq])
    t_leg = -(-len(padded) // r)
    full = np.zeros(t_leg * r)
    full[: len(padded)] = padded
    return full.reshape(t_leg, r).T.astype(np.float32)


def init_flat_state(
    log2_decim: int, batch_shape: Sequence[int] = (), order: int = DECIMATORS_ORDER
) -> FlatState:
    r = 1 << log2_decim
    t_leg = flat_legs(log2_decim, order).shape[1]
    return FlatState(
        jnp.zeros((*batch_shape, r * (t_leg - 1)), dtype=jnp.complex64)
    )


# -- banded form of the flat conv -------------------------------------------
#
# The naive polyphase conv has r input channels and ONE output feature.
# Grouping B consecutive output positions into conv FEATURES gives the
# kernel K[b, j, t'] = legs[j, t'-b] (a banded tap matrix) over stride-B
# windows: same arithmetic, same outputs, a B-wide contraction for
# ~(1 + B/t_leg)× redundant reads of the window overlap (see _feature_block).

@functools.lru_cache(maxsize=64)
def _banded_kernel(
    log2_decim: int, fc_pos: str, part: str, b: int, order: int
) -> np.ndarray:
    """(B + t_leg - 1, r, B) HIO tap matrix K[t', j, b] = legs[j, t'-b]
    (channels-last: the polyphase rows (w, r) are a PURE reshape of the
    sample stream, so the conv needs no input transpose)."""
    if fc_pos == "cen":
        legs = flat_legs(log2_decim, order)
    else:
        legs_c, _ = flat_rotated(log2_decim, fc_pos, order)
        legs = np.real(legs_c) if part == "re" else np.imag(legs_c)
    r, t_leg = legs.shape
    k = np.zeros((b + t_leg - 1, r, b), np.float32)
    for j in range(b):
        k[j : j + t_leg, :, j] = legs.T
    return k


def _leg_conv(
    planes: jnp.ndarray, log2_decim: int, fc_pos: str, part: str, order: int,
    precision: jax.lax.Precision,
) -> jnp.ndarray:
    """planes: (N, w, r) f32 polyphase rows. Returns (N, w - t_leg + 1)."""
    t_leg = flat_legs(log2_decim, order).shape[1]
    n_out = planes.shape[-2] - t_leg + 1
    b = _feature_block(n_out)
    kern = _banded_kernel(log2_decim, fc_pos, part, b, order)
    out = jax.lax.conv_general_dilated(
        planes,
        jnp.asarray(kern),
        window_strides=(b,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        precision=precision,
    )  # (N, n_out/B, B): feature b = output position q·B + b
    return out.reshape(planes.shape[0], n_out)


def decimate_flat(
    state: FlatState, x: jnp.ndarray, log2_decim: int, order: int = DECIMATORS_ORDER,
    precision: jax.lax.Precision = PRECISION,
) -> tuple[FlatState, jnp.ndarray]:
    """Whole ÷2^k cen cascade as one polyphase conv; streaming-equivalent to
    decimate_cascade (within f32 rounding of the composed filter).

    x: (..., T) complex64, T a multiple of 2^k. Returns (state', y (..., T/2^k)).
    `precision` defaults to the device-path policy (dsp/precision.py).
    """
    if log2_decim == 0:
        return state, x
    r = 1 << log2_decim
    ext = jnp.concatenate([state.tail, x], axis=-1)
    batch_shape = ext.shape[:-1]
    lanes = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    w = ext.shape[-1] // r
    planes = lanes.reshape(-1, w, r)  # (2·prod(batch), w, 2^k) — pure reshape
    out = _leg_conv(planes, log2_decim, "cen", "re", order, precision)
    out = out.reshape(2, *batch_shape, out.shape[-1])
    y = (out[0] + 1j * out[1]).astype(jnp.complex64)
    return FlatState(ext[..., x.shape[-1] :]), y


@functools.lru_cache(maxsize=32)
def flat_rotated(
    log2_decim: int, fc_pos: str, order: int = DECIMATORS_ORDER
) -> tuple[np.ndarray, np.ndarray]:
    """(legs (2^k, t_leg) complex64, pattern (4·2^k,) complex64) for inf/sup.

    Pulling each stage's ±fs/4 rotation to the input (M_ω D₂ᵐ = D₂ᵐ M_{ω/2ᵐ},
    M_ω H_g = H_{g·e^{jωl}} M_ω) turns the rotated cascade into
    input-modulation · one LTI filter · ÷2^k:  y[M] = Σ_l G[l]·(x·e^{jΩn})[2^k·M − D + l],
    Ω = Σ_m s_m(π/2)/2^m. G (complex) is extracted numerically from the
    float64 oracle's impulse responses so orientation/alignment are exact by
    construction; the modulation pattern has period 4·2^k, which every block
    length already satisfies (rotation-pattern constraint), so blocks tile it.
    """
    r = 1 << log2_decim
    signs = placement_schedule(log2_decim, fc_pos)
    omega = sum(s * (np.pi / 2.0) / (1 << m) for m, s in enumerate(signs))
    d = (order - 2) * (r - 1)
    l_full_eq = d + 1  # support of the composed filter
    g = np.zeros(l_full_eq, dtype=np.complex128)
    n_in = l_full_eq + 8 * r
    for n0 in range(r):
        x = np.zeros(n_in, dtype=np.complex128)
        x[n0] = 1.0
        y = decimate_reference_oracle(x, log2_decim, fc_pos, order).astype(
            np.complex128
        )
        for m in range(len(y)):
            i = n0 + d - r * m
            if 0 <= i < l_full_eq:
                g[i] = y[m] * np.exp(-1j * omega * n0)
    # polyphase legs with the cen-identical grid alignment
    front = (-d) % r
    padded = np.concatenate([np.zeros(front, np.complex128), g])
    t_leg = -(-len(padded) // r)
    full = np.zeros(t_leg * r, np.complex128)
    full[: len(padded)] = padded
    legs = full.reshape(t_leg, r).T.astype(np.complex64)
    pattern = np.exp(1j * omega * np.arange(4 * r)).astype(np.complex64)
    return legs, pattern


def decimate_flat_any(
    state: FlatState, x: jnp.ndarray, log2_decim: int, fc_pos: str = "cen",
    order: int = DECIMATORS_ORDER, precision: jax.lax.Precision = PRECISION,
) -> tuple[FlatState, jnp.ndarray]:
    """Flat composed-filter decimation for ANY placement. cen dispatches to
    the real-leg path; inf/sup modulate the input by the period-4·2^k
    pattern and correlate with complex legs (2×2 real block matmul)."""
    if log2_decim == 0 or fc_pos == "cen":
        return decimate_flat(state, x, log2_decim, order, precision)
    r = 1 << log2_decim
    legs_c, pattern = flat_rotated(log2_decim, fc_pos, order)
    t_leg = legs_c.shape[1]
    assert x.shape[-1] % (4 * r) == 0, "block must be a multiple of 4·2^k"
    # global-phase tiling: the carried tail length is r·(t_leg−1), also a
    # multiple of 4·2^k? Not necessarily — modulate x before concatenating
    # so each block sees the same tiled pattern (tail is stored modulated).
    rot = jnp.asarray(np.tile(pattern, x.shape[-1] // (4 * r)))
    xm = x * rot
    ext = jnp.concatenate([state.tail, xm], axis=-1)
    batch_shape = ext.shape[:-1]
    lanes = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    w = ext.shape[-1] // r
    planes = lanes.reshape(2, -1, w, r) if batch_shape else lanes.reshape(2, 1, w, r)

    def conv1(pl, part):
        return _leg_conv(pl, log2_decim, fc_pos, part, order, precision)

    yr = conv1(planes[0], "re") - conv1(planes[1], "im")
    yi = conv1(planes[0], "im") + conv1(planes[1], "re")
    t_out = yr.shape[-1]
    yr = yr.reshape(*batch_shape, t_out)
    yi = yi.reshape(*batch_shape, t_out)
    y = (yr + 1j * yi).astype(jnp.complex64)
    return FlatState(ext[..., xm.shape[-1] :]), y


class FlatIqState(NamedTuple):
    tail: jnp.ndarray  # (..., 2^k·(t_leg−1), 2) f32 carried raw I/Q


def init_flat_iq_state(
    log2_decim: int, batch_shape: Sequence[int] = (), order: int = DECIMATORS_ORDER
) -> FlatIqState:
    r = 1 << log2_decim
    t_leg = flat_legs(log2_decim, order).shape[1]
    return FlatIqState(
        jnp.zeros((*batch_shape, r * (t_leg - 1), 2), dtype=jnp.float32)
    )


def decimate_flat_iq(
    state: FlatIqState, x_iq: jnp.ndarray, log2_decim: int,
    order: int = DECIMATORS_ORDER,
) -> tuple[FlatIqState, jnp.ndarray]:
    """Layout-native flat cen cascade: NO transposes anywhere.

    x_iq: (..., T, 2) float32 — the natural memory order of interleaved
    ADC samples. The polyphase planes ext[2^k·i + j] are exactly a reshape
    of this layout to (W, 2^k·2) with channel index c = 2j + iq, so the
    whole cascade is ONE NWC conv whose kernel routes even channels (I
    legs) to output channel 0 and odd channels (Q legs) to channel 1.
    The complex variant (decimate_flat) stacks real/imag into planar
    arrays — two ~8 B/sample transposes of the full-rate stream; this form
    reads the input in storage order.

    Returns (state', y_iq (..., T/2^k, 2) float32).
    """
    if log2_decim == 0:
        return state, x_iq
    r = 1 << log2_decim
    legs = flat_legs(log2_decim, order)  # (r, t_leg) np
    t_leg = legs.shape[1]
    rhs = np.zeros((t_leg, 2 * r, 2), np.float32)
    rhs[:, 0::2, 0] = legs.T
    rhs[:, 1::2, 1] = legs.T
    ext = jnp.concatenate([state.tail, x_iq], axis=-2)
    batch_shape = ext.shape[:-2]
    w = ext.shape[-2] // r
    lhs = ext.reshape(-1, w, 2 * r)  # (N, W, C) — a pure reshape
    out = jax.lax.conv_general_dilated(
        lhs,
        jnp.asarray(rhs),
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        precision=PRECISION,
    )  # (N, T/2^k, 2)
    y = out.reshape(*batch_shape, out.shape[-2], 2)
    return FlatIqState(ext[..., x_iq.shape[-2] :, :]), y

"""Half-band interpolation cascades and the UpChannelizer — the Tx mirror.

Reference: sdrbase/dsp/interpolators.h:104-130 (×2..×64 device interpolation
cascades, half-band orders 64/32/16), sdrbase/dsp/upchannelizer.{h,cpp}
(pull-model interpolation tree with Center/Lower/Upper placement; order 96),
IntHalfbandFilterEO::myInterpolate (inthalfbandfiltereo.h:712-745).

Block form: one ×2 stage is a dilated conv (zero-stuff by 2 → half-band FIR
× gain 2); the UpChannelizer runs the Rx plan's stages in reverse with
opposite rotations applied *after* interpolation, moving the channel from DC
into its half-band slot at each doubling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .channelizer import ChannelPlan
from .decimators import CascadeState, _rotation_pattern
from .hbfilter import UPCHANNELIZER_ORDER, hb_taps
from .precision import PRECISION


def hb_interpolate2(
    tail: jnp.ndarray, x: jnp.ndarray, taps: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One ×2 half-band interpolation stage: (tail, x[..., T]) -> (tail',
    y[..., 2T]). Zero-stuffing loses 6 dB, compensated by the ×2 gain
    (myInterpolateZeroStuffing semantics)."""
    ext = jnp.concatenate([tail, x], axis=-1)
    batch_shape = ext.shape[:-1]
    lanes = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    lhs = lanes.reshape(-1, 1, ext.shape[-1])
    rhs = (2.0 * taps.astype(jnp.float32)).reshape(1, 1, -1)
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=((0, 0),),  # explicit VALID (string padding rejected with lhs_dilation)
        lhs_dilation=(2,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=PRECISION,
    )
    out = out[..., -2 * x.shape[-1] :]
    out = out.reshape(2, *batch_shape, 2 * x.shape[-1])
    y = (out[0] + 1j * out[1]).astype(jnp.complex64)
    new_tail = ext[..., x.shape[-1] :]
    return new_tail, y


def init_state(
    n_stages: int, batch_shape=(), order: int = UPCHANNELIZER_ORDER
) -> CascadeState:
    l_taps = order - 1
    # tail holds ceil(L/2) input samples so the dilated window is covered
    tail_len = (l_taps + 1) // 2 + 1
    return CascadeState(
        tuple(
            jnp.zeros((*batch_shape, tail_len), dtype=jnp.complex64)
            for _ in range(n_stages)
        )
    )


def upchannelize(
    state: CascadeState,
    x: jnp.ndarray,
    plan: ChannelPlan,
    order: int = UPCHANNELIZER_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Tx mirror of `channelize`: run the plan's stages deepest-first, each
    interpolating ×2 then rotating by the *same* quarter-shift sign as the Rx
    stage would have un-rotated — placing the channel into the half the Rx
    plan selected. x at plan.channel_rate -> y at the baseband rate."""
    taps = jnp.asarray(hb_taps(order))
    tails = list(state.tails)
    y = x
    for k in reversed(range(len(plan.signs))):
        tails[k], y = hb_interpolate2(tails[k], y, taps)
        sign = -plan.signs[k]  # opposite rotation moves DC into the slot
        rot = _rotation_pattern(sign, y.shape[-1])
        if rot is not None:
            y = y * jnp.asarray(rot)
    return CascadeState(tuple(tails)), y


def upchannelize_bank(
    state: CascadeState,
    x: jnp.ndarray,
    signs: np.ndarray,
    order: int = UPCHANNELIZER_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Channel-parallel Tx mirror of `channelize_bank`: a bank of channels
    with a SHARED stage depth runs as one batched cascade, per-channel
    rotation signs as data (the ThreadedBasebandSampleSource channel
    parallelism of the reference, re-expressed as a batch axis).

    x: (C, T) complex64 at the common channel rate; signs: (C, n_stages)
    from each channel's plan; state tails carry the leading C axis.
    Returns (state', y (C, T · 2^n_stages)) at the baseband rate.
    """
    from .channelizer import _stage_rotation

    taps = jnp.asarray(hb_taps(order))
    signs = np.asarray(signs)
    n_stages = signs.shape[1]
    tails = list(state.tails)
    y = x
    for k in reversed(range(n_stages)):
        tails[k], y = hb_interpolate2(tails[k], y, taps)
        rot = _stage_rotation(-signs[:, k], y.shape[-1])
        if rot is not None:
            y = y * jnp.asarray(rot)
    return CascadeState(tuple(tails)), y


def interpolate_cascade(
    state: CascadeState,
    x: jnp.ndarray,
    log2_interp: int,
    order: int = 64,
) -> tuple[CascadeState, jnp.ndarray]:
    """Device-side ×2^k interpolation to the DAC rate (interpolators.h
    cascades; reference uses shrinking orders 64/32/16 up the chain — one
    order-64 design everywhere is strictly better filtering, and the
    batched conv runs every stage as one op)."""
    taps = jnp.asarray(hb_taps(order))
    tails = list(state.tails)
    y = x
    for k in range(log2_interp):
        tails[k], y = hb_interpolate2(tails[k], y, taps)
    return CascadeState(tuple(tails)), y

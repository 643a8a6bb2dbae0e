"""Down/Up channelizer — frequency plan + batched stage execution.

Reference: sdrbase/dsp/downchannelizer.{h,cpp} — `createFilterChain`
(downchannelizer.cpp:250-287) recursively picks Lower/Upper/Centre half-band
stages (order 48, downchannelizer.h:28) until the desired channel no longer
fits in a half of the shrinking signal band, then reports the residual offset
for the channel NCO; `feed` (:50-91) runs the per-sample stage cascade and
divides by 2^stages (our float stages are unity-gain, so no renorm).

Design: the plan is a host-side pure function → (stage modes, decimation,
residual offset). Execution maps each stage to rotate(±fs/4)+HB-decimate on
whole blocks. For channel banks, all channels share one plan *depth*; the
per-channel rotation signs become per-channel data so one vmapped cascade
serves the whole bank (threadedbasebandsamplesink channel-parallelism →
vmap/shard, SURVEY.md §2.6).
"""

from __future__ import annotations

import dataclasses
import jax.numpy as jnp
import numpy as np

from .decimators import CascadeState, hb_decimate2
from .hbfilter import DOWNCHANNELIZER_ORDER, hb_taps


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Result of the frequency-plan recursion."""

    signs: tuple[int, ...]  # per-stage quarter-shift: +1 (lower), -1 (upper), 0 (centre)
    decimation: int  # 2^len(signs)
    channel_rate: float  # input rate / decimation
    residual_offset: float  # remaining offset for the channel NCO (Hz)


def plan_channel(
    in_rate: float, requested_rate: float, requested_offset: float
) -> ChannelPlan:
    """Port of the createFilterChain recursion (downchannelizer.cpp:250-287).

    Walks [sig_start, sig_end) halving until the channel band
    [offset - req/2, offset + req/2] no longer fits in the lower half, upper
    half, or centre half; each recursion appends a stage.
    """
    req_half = requested_rate / 2.0
    chan_start = requested_offset - req_half
    chan_end = requested_offset + req_half

    def contains(sig_start, sig_end, s, e):
        return sig_end > sig_start and e > s and sig_start <= s and sig_end >= e

    signs: list[int] = []
    sig_start, sig_end = -in_rate / 2.0, in_rate / 2.0
    while True:
        bw = sig_end - sig_start
        rot = bw / 4.0
        if contains(sig_start, sig_start + bw / 2.0, chan_start, chan_end):
            signs.append(+1)  # lower half: rotate +fs/4, keep [start, mid]
            sig_end = sig_start + bw / 2.0
        elif contains(sig_end - bw / 2.0, sig_end, chan_start, chan_end):
            signs.append(-1)  # upper half: rotate -fs/4, keep [mid, end]
            sig_start = sig_end - bw / 2.0
        elif contains(sig_start + rot, sig_end - rot, chan_start, chan_end):
            signs.append(0)  # centre half
            sig_start, sig_end = sig_start + rot, sig_end - rot
        else:
            break
    ofs = (chan_end + chan_start) / 2.0 - (sig_end + sig_start) / 2.0
    k = len(signs)
    return ChannelPlan(
        signs=tuple(signs),
        decimation=1 << k,
        channel_rate=in_rate / (1 << k),
        residual_offset=ofs,
    )


def init_state(
    n_stages: int, batch_shape=(), order: int = DOWNCHANNELIZER_ORDER
) -> CascadeState:
    l_taps = order - 1
    return CascadeState(
        tuple(
            jnp.zeros((*batch_shape, l_taps - 1), dtype=jnp.complex64)
            for _ in range(n_stages)
        )
    )


def _stage_rotation(signs_per_channel: np.ndarray, length: int) -> np.ndarray | None:
    """Rotation matrix (C, T) for one stage of a channel bank; None if all
    channels are centre stages. signs_per_channel: (C,) in {-1, 0, +1}."""
    if not np.any(signs_per_channel):
        return None
    assert length % 4 == 0
    n = np.arange(4)
    base = np.stack(
        [np.exp(1j * s * np.pi / 2.0 * n) if s else np.ones(4) for s in signs_per_channel]
    ).astype(np.complex64)  # (C, 4)
    return np.tile(base, (1, length // 4))


def channelize_bank(
    state: CascadeState,
    x: jnp.ndarray,
    signs: np.ndarray,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Run a bank of channels with a shared stage depth.

    x: (C, T) complex64 — the same device block broadcast per channel (or
    already per-channel data); signs: (C, n_stages) int — per-channel
    per-stage rotation signs from each channel's plan.
    Returns (state', y) with y: (C, T / 2^n_stages).
    """
    taps = jnp.asarray(hb_taps(order))
    signs = np.asarray(signs)
    n_stages = signs.shape[1]
    tails = list(state.tails)
    y = x
    for k in range(n_stages):
        rot = _stage_rotation(signs[:, k], y.shape[-1])
        if rot is not None:
            y = y * jnp.asarray(rot)
        tails[k], y = hb_decimate2(tails[k], y, taps)
    return CascadeState(tuple(tails)), y


def channelize(
    state: CascadeState,
    x: jnp.ndarray,
    plan: ChannelPlan,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Single-channel wrapper: same shapes in and out as the input block."""
    from .decimators import _rotation_pattern

    taps = jnp.asarray(hb_taps(order))
    tails = list(state.tails)
    y = x
    for k, sign in enumerate(plan.signs):
        rot = _rotation_pattern(sign, y.shape[-1])
        if rot is not None:
            y = y * jnp.asarray(rot)
        tails[k], y = hb_decimate2(tails[k], y, taps)
    return CascadeState(tuple(tails)), y


def channelize_bank_unique(
    state: CascadeState,
    bb: jnp.ndarray,
    signs: np.ndarray,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[CascadeState, jnp.ndarray]:
    """Channel bank over ONE shared stream, deduplicated by stage path.

    A bank of C channels on the same baseband has at most 4^n_stages — and
    typically only a handful of — distinct sign paths (the reference's
    per-channel DownChannelizer trees share every prefix; running the bank
    as C independent cascades re-filters identical data, which at device
    rate dominates the whole pipeline). Runs the cascade once per DISTINCT
    path and gathers outputs back to channel order at the decimated rate.

    bb: (T,) complex64 — the shared stream; signs: (C, n_stages) int.
    state: CascadeState with leading dim U = number of unique paths (use
    `unique_paths(signs)` to size it). Returns (state', y (C, T/2^n)).
    """
    uniq, inverse = np.unique(np.asarray(signs), axis=0, return_inverse=True)
    xb = jnp.broadcast_to(bb, (len(uniq), bb.shape[-1]))
    state, y_u = channelize_bank(state, xb, uniq, order)
    return state, y_u[np.asarray(inverse)]


def unique_paths(signs: np.ndarray) -> int:
    return len(np.unique(np.asarray(signs), axis=0))

"""Symbol timing synchronizer (Gardner) — the liquid-dsp symsync role.

Reference: sdrbase/dsp/symsync.{h,cpp} wraps liquid-dsp's polyphase symbol
synchronizer for PSK-style streams (used by DATV). Block form: the stream is
oversampled at `sps` samples/symbol; a block-level Gardner detector measures
the average timing error over all symbols of the block (one reduction, no
per-symbol loop), a small loop filter carried across blocks converges the
fractional phase, and symbols are picked by gather at the corrected phase.
Per-symbol feedback becomes per-block feedback — valid when the clock
offset is ≪ 1 symbol per block, which block sizing guarantees.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class SymSyncState(NamedTuple):
    mu: jnp.ndarray  # fractional timing phase in samples [0, 2*sps)
    freq: jnp.ndarray  # timing frequency error (samples/symbol drift)
    tail: jnp.ndarray  # (..., 2*sps) carried samples (look-ahead margin)


def make_state(batch_shape=(), sps: int = 10) -> SymSyncState:
    # mu starts mid-window (= sps): a transmitter aligned to the sample grid
    # has true phase ≡ 0 (mod sps), and sitting at the centre keeps the loop
    # away from the window edges — mu is carried CONTINUOUSLY (clamped, not
    # wrapped) because a mod-wrap at a block seam drops/duplicates a whole
    # symbol (observed as periodic slips that scrambled DVB-S streams).
    return SymSyncState(
        jnp.full(batch_shape, float(sps), jnp.float32),
        jnp.zeros(batch_shape, jnp.float32),
        jnp.zeros((*batch_shape, 2 * sps), jnp.complex64),
    )


def synchronize_block(
    state: SymSyncState,
    x: jnp.ndarray,
    sps: int,
    loop_gain: float = 0.05,
) -> tuple[SymSyncState, jnp.ndarray]:
    """x: (..., T) complex at sps samples/symbol, T a multiple of sps.
    Returns (state', symbols (..., T/sps) complex) sampled at the tracked
    instant — exactly T/sps symbols per block, no loss across seams (the
    2·sps carried tail provides the mid/next look-ahead margin).
    Gardner error: e = Re[(y_k − y_{k−1})·conj(y_mid)]."""
    assert x.shape[-1] % sps == 0, (x.shape, sps)
    ext = jnp.concatenate([state.tail, x], axis=-1)
    n_sym = x.shape[-1] // sps
    base = jnp.arange(n_sym) * sps
    mu_i = jnp.round(state.mu).astype(jnp.int32)

    on_time = ext[..., base + mu_i]
    nxt = ext[..., base + sps + mu_i]
    mid = ext[..., base + sps // 2 + mu_i]
    err = jnp.mean(
        jnp.real((nxt - on_time) * jnp.conj(mid)), axis=-1
    )  # >0: sample late

    freq = state.freq + 0.1 * loop_gain * err
    # continuous phase, clamped to the tail window — NO mod: wrapping at a
    # seam slips one whole symbol. A real sustained clock skew walks mu to
    # an edge (2·sps of margin ≫ any rationally-locked source's drift).
    mu = jnp.clip(
        state.mu + loop_gain * err * sps + freq, 0.0, 2.0 * sps - 1.01
    )
    new_tail = ext[..., x.shape[-1] :]
    return (
        SymSyncState(mu.astype(jnp.float32), freq.astype(jnp.float32), new_tail),
        nxt,
    )

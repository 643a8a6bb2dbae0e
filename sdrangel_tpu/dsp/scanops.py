"""Parallel formulations of the reference's per-sample sequential recurrences.

The reference walks samples one by one (squelch gate counters, AGC ramps —
nfmdemod.cpp:178-240, agc.cpp:98-175). On a parallel device a per-sample
loop would leave it idle; these helpers re-express the recurrences as
log-depth associative scans.

Execution shape: every associative_scan here runs as a TWO-LEVEL scan over
(chunks, K) with the scanned axis moved to a MAJOR position. This was a
compile-time workaround on an earlier accelerator (a single minor-axis scan
inside a large program compiled for a minute); its A/B against the plain
scan on the H100 is queued (ROADMAP Design 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _two_level_scan(compose, elems, identity):
    """Inclusive associative scan of a tuple of (..., T) arrays along the
    last axis, executed as chunk-level + cross-chunk scans with every
    lax.associative_scan running on a major (non-minor) axis.

    identity: tuple of scalars such that compose(identity, g) == g,
    compose(f, identity) == f, and applying identity leaves the carry
    unchanged (used for the exclusive chunk prefix AND for padding).
    Returns the scanned tuple, (..., T) layout.
    """
    t = elems[0].shape[-1]
    b = elems[0].shape[:-1]
    if t < 1024:
        # short blocks: one scan, moved off the minor axis
        em = tuple(jnp.moveaxis(e, -1, 0) for e in elems)
        out = jax.lax.associative_scan(compose, em, axis=0)
        return tuple(jnp.moveaxis(o, 0, -1) for o in out)
    # pad to a multiple of the chunk with identity elements so EVERY large
    # block takes the two-level path (a block whose 2-adic factor is
    # small must not fall back to a single full-length scan)
    k = 512
    pad = (-t) % k
    if pad:
        elems = tuple(
            jnp.concatenate(
                [e, jnp.full((*b, pad), i, dtype=e.dtype)], axis=-1)
            for e, i in zip(elems, identity)
        )
    tp = t + pad
    c = tp // k
    em = tuple(jnp.moveaxis(e.reshape(*b, c, k), -1, 0) for e in elems)  # (K, ..., C)
    within = jax.lax.associative_scan(compose, em, axis=0)
    # chunk-total tuples (..., C) -> exclusive scan over chunks (major axis)
    ct = tuple(jnp.moveaxis(w[-1], -1, 0) for w in within)  # (C, ...)
    pre = jax.lax.associative_scan(compose, ct, axis=0)
    pre = tuple(
        jnp.concatenate([jnp.full_like(p[:1], i), p[:-1]])
        for p, i in zip(pre, identity)
    )
    # combine: chunk prefix (broadcast over K) composed with within-chunk
    pre_b = tuple(jnp.moveaxis(p, 0, -1)[None] for p in pre)  # (1, ..., C)
    full = compose(pre_b, within)  # (K, ..., C)
    return tuple(
        jnp.moveaxis(f, 0, -1).reshape(*b, tp)[..., :t] for f in full)


def _clamp_compose(f, g):
    # g∘f where f=(af,lf,hf) applied first, then g; the clamped-affine map
    # x -> clip(x + a, l, h) is closed under composition.
    af, lf, hf = f
    ag, lg, hg = g
    aa = af + ag
    ll = jnp.clip(lf + ag, lg, hg)
    hh = jnp.clip(hf + ag, lg, hg)
    return aa, ll, hh


def saturating_counter(
    deltas: jnp.ndarray, lo: float, hi: float, init: jnp.ndarray
) -> jnp.ndarray:
    """count[t] = clamp(count[t-1] + deltas[t], lo, hi), vectorized.

    The map x -> clamp(x + a, l, h) is closed under composition, so the whole
    recurrence is an associative scan over (a, l, h) triples — log-depth on
    the device instead of a length-T serial loop.

    deltas: (..., T); init: (...,) counter entering the block.
    Returns (..., T) float32 counter series (after each step).
    """
    a = deltas.astype(jnp.float32)
    l = jnp.full_like(a, jnp.float32(lo))
    h = jnp.full_like(a, jnp.float32(hi))
    aa, ll, hh = _two_level_scan(
        _clamp_compose, (a, l, h), (0.0, -jnp.inf, jnp.inf)
    )
    return jnp.clip(init[..., None] + aa, ll, hh)


def _ema_compose(f, g):
    df, af = f
    dg, ag = g
    return df * dg, af * dg + ag


def ema(x: jnp.ndarray, alpha: float, init: jnp.ndarray) -> jnp.ndarray:
    """y[t] = (1-alpha)*y[t-1] + alpha*x[t] as an associative scan."""
    decay = jnp.full(x.shape, 1.0 - alpha, dtype=jnp.float32)
    add = (x * alpha).astype(jnp.float32)
    d, a = _two_level_scan(_ema_compose, (decay, add), (1.0, 0.0))
    return init[..., None] * d + a

"""Polyphase rational resampler — the audio-rate decimator.

Reference: sdrbase/dsp/interpolator.{h,cpp} — `Interpolator` designs a
polyphase windowed-sinc lowpass (createPolyphaseLowPass, interpolator.cpp:7-55:
Hamming window 0.54-0.46cos, ntaps rounded even then ×phases, normalized by
DC gain) and resamples with a fractional `distance` accumulator selecting the
phase leg `floor(distance * phaseSteps)` per output (interpolator.h:23-52).

Design: the in/out ratio is rational p/q, so for block length T ≡ 0
(mod p) the per-output input index and phase leg repeat exactly every q
outputs and every block. The reference's per-sample phase schedule (both
the decimate and interpolate recurrences) is recast as ONE static
multi-output-channel strided conv / windows@legs matmul — residue class j
of the output grid becomes channel j whose kernel is phase leg phase[j]
placed at offset start_idx[j] (_polyphase_conv_kernels); no gathers, no
data-dependent shapes.
Carried state is the ntaps-1 input tail (the distance pattern is
block-periodic by construction, so no phase carry is needed).
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .precision import PRECISION


def create_polyphase_lowpass(
    phase_steps: int,
    gain: float,
    sample_rate: float,
    cutoff: float,
    nb_taps_per_phase: float = 4.5,
) -> np.ndarray:
    """Port of Interpolator::createPolyphaseLowPass (interpolator.cpp:20-55).

    Returns taps of shape (phase_steps, ntaps_per_phase): row k is the FIR
    applied when the fractional position selects phase k.
    """
    ntaps = int(nb_taps_per_phase * phase_steps)
    if ntaps % 2 != 0:
        ntaps += 1
    total = ntaps * phase_steps
    n = np.arange(total, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (total - 1))
    m = (total - 1) // 2
    fw = 2.0 * np.pi * cutoff / sample_rate
    k = n - m
    with np.errstate(invalid="ignore", divide="ignore"):
        taps = np.where(k == 0, fw / np.pi, np.sin(k * fw) / (k * np.pi)) * window
    # normalize by total DC gain: taps[M] + 2*sum(taps[M+1..]) (symmetric FIR)
    dc = taps[m] + 2.0 * taps[m + 1 :].sum()
    taps = taps * (gain / dc)
    # interleave into phase legs: output sample with phase p uses
    # taps[p], taps[p + phases], taps[p + 2*phases], ...
    legs = taps.reshape(-1, phase_steps).T  # (phases, ntaps)
    # per-leg unit-DC normalization (Interpolator::create, interpolator.cpp:103-110)
    legs = legs / legs.sum(axis=1, keepdims=True)
    return legs.astype(np.float32)


class ResamplerState(NamedTuple):
    tail: jnp.ndarray  # (..., ntaps-1) complex64 carried input samples


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash so a
# plan object can be a jit static argument (reuse the same instance per chain)
class ResamplerPlan:
    """Host-precomputed schedule for one block size: the reference's
    phase-leg schedule (interpolator.h:23-52, both directions) executed as
    one multi-channel strided conv / matmul (kernels from
    _polyphase_conv_kernels). mode is always "gather" (an XLA dilated-conv
    mode existed through r3; removed as dead once the upsample path
    adopted the reference-exact schedule)."""

    in_rate: float
    out_rate: float
    block_in: int  # input samples per block (multiple of p)
    block_out: int  # outputs per block (= block_in * q / p)
    ntaps: int
    phase_steps: int
    taps: np.ndarray  # (phase_steps, ntaps) float32
    start_idx: np.ndarray  # (block_out,) int32 — first input sample of each output frame
    phase: np.ndarray  # (block_out,) int32 — phase leg per output
    mode: str = "gather"
    p: int = 1
    q: int = 1

    @property
    def ratio(self) -> float:
        return self.in_rate / self.out_rate

    @property
    def _pq_eff(self) -> tuple[int, int]:
        return self.p, self.q

    @functools.cached_property
    def residue_kernels(self) -> np.ndarray:
        return _polyphase_conv_kernels(self)


def make_plan(
    in_rate: float,
    out_rate: float,
    block_in: int,
    cutoff: float | None = None,
    phase_steps: int = 16,
    nb_taps_per_phase: float = 4.5,
) -> ResamplerPlan:
    """Build the static resampling schedule.

    Follows Interpolator::decimate's distance recurrence (interpolator.h:23-35):
    per input sample `distance -= 1`, and an output is produced (with phase
    `floor(distance * phaseSteps)`) whenever distance < 1, after which
    `distance += in_rate/out_rate`. in_rate >= out_rate (decimation); the
    channel plumbing guarantees this like the reference's channelizer does.
    """
    frac = Fraction(in_rate / out_rate).limit_denominator(1 << 20)
    p, q = frac.numerator, frac.denominator
    assert block_in % p == 0, (
        f"block_in={block_in} must be a multiple of p={p} (in_rate/out_rate={p}/{q})"
    )
    if cutoff is None:
        cutoff = 0.4 * min(out_rate, in_rate)
    cutoff = min(cutoff, 0.45 * min(out_rate, in_rate))  # anti-alias/image guard

    if in_rate < out_rate:
        assert q <= 256, f"upsampling denominator too large: {q}"

    if in_rate >= out_rate:
        # Rx decimation, ALL ratios: the EXACT reference schedule. Simulate
        # Interpolator::decimate's recurrence (interpolator.h:23-35: per
        # input `distance -= 1`; emit doInterpolate(floor(distance *
        # phaseSteps)) whenever distance < 1 — phase CLAMPED at 0,
        # interpolator.h:126-127 — then the caller adds in/out) in integer
        # arithmetic (distance in units of 1/q; the reference's float32
        # accumulator drifts ~1e-7/step, below every golden bound). Legs are
        # the reference's own 16-phase prototype (createPolyphaseLowPass,
        # interpolator.cpp:20-110, per-leg unit DC) — including its delay
        # QUANTIZATION to the 16-phase grid for q ∤ 16 ratios. The emitted
        # stream reproduces the reference from its output 1 on: the
        # reference's stream leads with one extra phase-clamped output at
        # input 0 (distance starts at 0 → the first decrement emits
        # immediately), a pure one-output lead the golden lag fits absorb.
        # r5: this replaced a closed-form (j·p)//q+1 anchor that was only
        # correct for p ≤ 2 — at 384k→48k (p=8) it sat 2 input samples off
        # the reference window, a 1/4-output-sample shift no integer lag
        # can absorb, capping the WFM chain golden at 29.7 dB. The exact
        # schedule measures 135.8 dB on the same stage (see
        # test_wfm_resampler_stage_matches_reference).
        # Executed through the windows+einsum machinery (see
        # _resample_polyphase_conv), like every other schedule.
        legs16 = create_polyphase_lowpass(
            phase_steps, 1.0, phase_steps * in_rate, cutoff, nb_taps_per_phase
        )
        per_leg = legs16.shape[1]
        block_out = block_in * q // p
        d = 0  # distance * q
        n = 0
        emitted: list[tuple[int, int]] = []
        while n < 3 * p + 1 and len(emitted) < 2 * q + 2:
            d -= q
            if d < q:
                emitted.append((n, max((phase_steps * d) // q, 0)))
                d += p
            n += 1
        # one steady period: the q outputs emitted over inputs [p, 2p)
        base = [(nn - p, ph) for (nn, ph) in emitted if p <= nn < 2 * p]
        assert len(base) == q, (p, q, emitted)
        j = np.arange(block_out, dtype=np.int64)
        base_n = np.asarray([b[0] for b in base], np.int64)
        base_ph = np.asarray([b[1] for b in base], np.int32)
        return ResamplerPlan(
            in_rate=in_rate,
            out_rate=out_rate,
            block_in=block_in,
            block_out=block_out,
            ntaps=per_leg,
            phase_steps=phase_steps,
            taps=legs16.astype(np.float32),
            start_idx=(base_n[j % q] + (j // q) * p).astype(np.int32),
            phase=base_ph[j % q].astype(np.int32),
            mode="gather",
            p=p,
            q=q,
        )
    if in_rate < out_rate:
        # Tx interpolation: the EXACT reference Interpolator::interpolate
        # recurrence (interpolator.h:39-52 — per output: consume an input
        # when distance >= 1, then emit doInterpolate(floor(distance *
        # phaseSteps)); distance += in/out after each pull) over the same
        # polyphase legs as the decimation path. Pinned against the
        # compiled reference by tests/test_reference_golden.py
        # interp_48k_96k/interp_48k_120k. The schedule is q outputs per p
        # inputs; each leg gets a LEADING zero so the flipped kernels
        # anchor windows at the consumed-input count (the filter holds
        # samples up to input consumed-1; the padded column makes
        # start_idx = consumed line up with the executor's ext indexing).
        legs = create_polyphase_lowpass(
            phase_steps, 1.0, phase_steps * in_rate, cutoff, nb_taps_per_phase
        )
        taps = np.concatenate(
            [np.zeros((phase_steps, 1), legs.dtype), legs], axis=1)
        block_out = block_in * q // p
        d = 0  # distance in units of 1/q
        consumed = 0
        start_idx, phase = [], []
        for _ in range(block_out):
            if d >= q:
                consumed += 1
                d -= q
            phase.append((d * phase_steps) // q)
            start_idx.append(consumed)
            d += p
        assert start_idx[: len(start_idx) - q] == [
            s - p for s in start_idx[q:]], "upsample schedule must be periodic"
        return ResamplerPlan(
            in_rate=in_rate,
            out_rate=out_rate,
            block_in=block_in,
            block_out=block_out,
            ntaps=taps.shape[1],
            phase_steps=phase_steps,
            taps=taps.astype(np.float32),
            start_idx=np.asarray(start_idx, np.int32),
            phase=np.asarray(phase, np.int32),
            mode="gather",
            p=p,
            q=q,
        )


def init_state(plan: ResamplerPlan, batch_shape=()) -> ResamplerState:
    return ResamplerState(
        jnp.zeros((*batch_shape, plan.ntaps - 1), dtype=jnp.complex64)
    )


def resample_block(
    state: ResamplerState, x: jnp.ndarray, plan: ResamplerPlan
) -> tuple[ResamplerState, jnp.ndarray]:
    """(state, x[..., block_in]) -> (state', y[..., block_out]).

    All plans execute in gather mode: each output m is
    dot(taps[phase[m]], ext[start_idx[m]:+ntaps]) where ext = [tail | x];
    newest-first tap order of the reference ring buffer is matched by
    reversing the legs once on the host. (A dilated/strided-conv "conv"
    mode existed through r3 for Tx upsampling; the reference-exact
    interpolate() schedule replaced it and the mode was removed as dead.)
    """
    assert x.shape[-1] == plan.block_in
    assert plan.mode == "gather", plan.mode
    return _resample_polyphase_conv(state, x, plan)


def _polyphase_conv_kernels(plan: ResamplerPlan) -> np.ndarray:
    p_, q_ = plan._pq_eff
    starts = plan.start_idx[:q_]
    legs = plan.taps[:, ::-1]  # newest-first flip (reference ring order)
    sel = legs[plan.phase[:q_]]  # (q, ntaps)
    l_full = int(starts.max()) + plan.ntaps
    rhs = np.zeros((q_, 1, l_full), dtype=np.float32)
    for j in range(q_):
        rhs[j, 0, starts[j] : starts[j] + plan.ntaps] = sel[j]
    return rhs


def _resample_polyphase_conv(
    state: ResamplerState, x: jnp.ndarray, plan: ResamplerPlan
) -> tuple[ResamplerState, jnp.ndarray]:
    """Gather-mode schedule as ONE matmul.

    Output q·m'+j is dot(K_j, ext[m'·p : m'·p + L]) with K_j the phase leg
    embedded at start_idx[j] (period-p/q schedule), computed as window
    extraction by reshape + `windows (m', L) @ K.T (L, q)`. (The equivalent
    strided conv, stride p with L-wide kernels, compiled for tens of
    minutes at large p on an earlier accelerator; the A/B on the H100 is
    ROADMAP Design 3.)
    """
    rhs_np = plan.residue_kernels  # (q, 1, L)
    q_ = rhs_np.shape[0]
    k_mat = jnp.asarray(rhs_np[:, 0, :])  # (q, L)
    l_full = rhs_np.shape[-1]
    p_ = plan._pq_eff[0]
    m_per = plan.block_out // q_
    ext = jnp.concatenate([state.tail, x], axis=-1)
    batch_shape = ext.shape[:-1]

    # windows[m'] = ext[m'·p : m'·p + L] via r p-wide row chunks (r·p ≥ L);
    # zero-pad the tail chunk reads — padded columns are sliced off by [:L]
    r = -(-l_full // p_)
    pad = m_per * p_ + r * p_ - ext.shape[-1]
    lanes = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    lanes = jnp.pad(lanes, [(0, 0)] * (lanes.ndim - 1) + [(0, max(pad, 0))])
    chunks = [
        lanes[..., s * p_ : (s + m_per) * p_].reshape(*lanes.shape[:-1], m_per, p_)
        for s in range(r)
    ]
    windows = jnp.concatenate(chunks, axis=-1)[..., :l_full]  # (2, ..., m', L)
    out = jnp.einsum("...ml,ql->...mq", windows, k_mat,
                     precision=PRECISION)  # (2, ..., m', q)
    out = out.reshape(2, *batch_shape, plan.block_out)
    y = (out[0] + 1j * out[1]).astype(jnp.complex64)
    return ResamplerState(ext[..., plan.block_in :]), y

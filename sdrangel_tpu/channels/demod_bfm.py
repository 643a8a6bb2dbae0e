"""Broadcast FM demodulator: stereo multiplex + RDS baseband extraction.

Reference: plugins/channelrx/demodbfm/bfmdemod.cpp (`feed` :116-260): NCO mix
→ fftfilt RF filter → magsq squelch with rfBW/10 attack → phase discriminator
→ MPX; stereo via 19 kHz pilot `PhaseLock` producing harmonically locked
samples (phaselock.h:181) used to product-demod the 38 kHz subcarrier; RDS
via demod × 2cos(3θ) at 57 kHz → RDSDemod clock recovery (rdsdemod.cpp) →
RDSDecoder frame sync → RDSParser.

Block-parallel re-design of the pilot recovery: instead of the per-sample PLL, the pilot
is extracted with a narrow *complex* (analytic) bandpass at 19 kHz; the unit
phasor z/|z| IS e^{jθ}, and the 38/57 kHz references are its complex powers —
the whole stereo/RDS downmix vectorizes with no scan. (The scan-based PLL
remains available in sdrangel_tpu.dsp.phaselock for parity experiments.)

The RDS symbol/bit/frame layer (1187.5 baud) runs on the host
(sdrangel_tpu.channels.rds) on the decimated complex RDS baseband this
module emits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp import fftfilt, firdesign, iir, nco, phasediscri, resampler
from ..dsp.scanops import saturating_counter

PILOT_FREQ = 19000.0
RDS_SYMBOL_RATE = 1187.5
RDS_SPS = 8  # samples per symbol in the emitted RDS baseband


@dataclasses.dataclass(frozen=True, eq=False)
class BFMConfig:
    channel_rate: float  # e.g. 192000 or 384000
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    rf_bandwidth: float = 180000.0
    af_bandwidth: float = 15000.0
    fm_deviation: float = 75000.0
    squelch_db: float = -60.0
    volume: float = 1.0
    audio_stereo: bool = True
    deemphasis_us: float = 50.0
    rds_active: bool = False
    fft_len: int = 1024
    block_in: int = 0

    @functools.cached_property
    def rf_filter(self) -> np.ndarray:
        fc = 0.5 * self.rf_bandwidth / self.channel_rate
        return fftfilt.create_dsb_filter(fc, self.fft_len)

    @functools.cached_property
    def pilot_taps(self) -> np.ndarray:
        """Complex analytic bandpass at 19 kHz (±400 Hz).

        The group delay is padded up to a multiple of the mono resampler's
        input stride p (~250 → 256 at 384 kHz): the MPX is delayed by the
        same amount to stay phase-aligned with the pilot harmonics, and a
        delay that is not a whole number of OUTPUT samples would shift our
        audio off the reference-exact resampler grid by a fraction no
        integer lag can absorb (r5 — the old resampler anchor was off by
        exactly the compensating fraction, two wrongs cancelling)."""
        p = self.mono_plan.p
        gd = -(-250 // p) * p
        n = 2 * gd + 1
        lp = firdesign.lowpass(n, 400.0 / self.channel_rate).astype(np.float64)
        k = np.arange(n) - n // 2
        return (2.0 * lp * np.exp(1j * 2.0 * np.pi * PILOT_FREQ / self.channel_rate * k)).astype(
            np.complex64
        )

    @functools.cached_property
    def mono_plan(self) -> resampler.ResamplerPlan:
        import math
        from fractions import Fraction

        if self.block_in:
            block = self.block_in
        else:
            # block must divide by the fft hop and by both resampler numerators
            p_mono = Fraction(self.channel_rate / self.audio_rate).limit_denominator(1 << 20).numerator
            p_rds = Fraction(
                self.channel_rate / (RDS_SYMBOL_RATE * RDS_SPS)
            ).limit_denominator(1 << 20).numerator
            block = math.lcm(self.fft_len // 2, p_mono, p_rds, 4)
            while block < 4096:
                block *= 2
        return resampler.make_plan(
            self.channel_rate, self.audio_rate, block, cutoff=self.af_bandwidth
        )

    @functools.cached_property
    def rds_plan(self) -> resampler.ResamplerPlan:
        return resampler.make_plan(
            self.channel_rate,
            RDS_SYMBOL_RATE * RDS_SPS,  # 9500 Hz
            self.mono_plan.block_in,
            cutoff=2400.0,
        )

    @functools.cached_property
    def rds_prefilter(self) -> np.ndarray:
        """±2.4 kHz lowpass at channel rate ahead of the ~40× RDS decimation
        (the short polyphase prototype alone cannot anti-alias that ratio —
        this is the rdsdemod.cpp filter_lp_2400_iq role)."""
        return firdesign.lowpass(801, 2400.0 / self.channel_rate)

    @property
    def fm_scaling(self) -> float:
        return self.channel_rate / (2.0 * self.fm_deviation)


class BFMState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    squelch_count: jnp.ndarray
    discri: phasediscri.DiscriminatorState
    pilot_fir: firdesign.FirState  # complex-tap FIR state (2 real lanes)
    mpx_delay: jnp.ndarray  # demod delayed by the pilot FIR group delay
    mono_resamp: resampler.ResamplerState
    stereo_resamp: resampler.ResamplerState
    rds_fir: firdesign.FirState
    rds_resamp: resampler.ResamplerState
    deemph_l: iir.Iir1State
    deemph_r: iir.Iir1State


def make_state(cfg: BFMConfig, batch_shape=()) -> BFMState:
    n_taps = len(cfg.pilot_taps)
    gd = (n_taps - 1) // 2
    return BFMState(
        nco=nco.make_nco(batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, batch_shape),
        squelch_count=jnp.zeros(batch_shape, jnp.float32),
        discri=phasediscri.make_state(batch_shape),
        pilot_fir=firdesign.FirState(
            jnp.zeros((*batch_shape, n_taps - 1), dtype=jnp.complex64)
        ),
        mpx_delay=jnp.zeros((*batch_shape, gd), jnp.float32),
        mono_resamp=resampler.init_state(cfg.mono_plan, batch_shape),
        stereo_resamp=resampler.init_state(cfg.mono_plan, batch_shape),
        rds_fir=firdesign.FirState(
            jnp.zeros((*batch_shape, len(cfg.rds_prefilter) - 1), dtype=jnp.complex64)
        ),
        rds_resamp=resampler.init_state(cfg.rds_plan, batch_shape),
        deemph_l=iir.make_iir1(batch_shape),
        deemph_r=iir.make_iir1(batch_shape),
    )


def _complex_fir(state: firdesign.FirState, x_real: jnp.ndarray, taps: np.ndarray):
    """Real input through complex taps: two real convolutions."""
    ext = jnp.concatenate([state.tail, x_real.astype(jnp.complex64)], axis=-1)
    ext_r = jnp.real(ext)
    hr = jnp.asarray(np.real(taps))
    hi = jnp.asarray(np.imag(taps))
    st_r = firdesign.FirState(ext_r[..., : taps.shape[0] - 1])
    # reuse the real conv path twice on the same extended buffer
    _, yr = firdesign.fir_apply(st_r, ext_r[..., taps.shape[0] - 1 :], hr)
    _, yi = firdesign.fir_apply(st_r, ext_r[..., taps.shape[0] - 1 :], hi)
    new_tail = ext[..., x_real.shape[-1] :]
    return firdesign.FirState(new_tail), (yr + 1j * yi).astype(jnp.complex64)


class BFMOutputs(NamedTuple):
    audio: jnp.ndarray  # (..., A, 2) stereo float32
    rds_baseband: jnp.ndarray  # (..., R) complex64 at 9500 Hz (8 sps)
    pilot_level: jnp.ndarray  # (...,) mean pilot magnitude (lock indicator)


def process(state: BFMState, x: jnp.ndarray, cfg: BFMConfig, offset_hz=None,
            squelch_db=None, volume=None) -> tuple[BFMState, BFMOutputs]:
    if offset_hz is None:
        inc = jnp.asarray(nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))
    else:  # traced live-retune override (applySettings-on-running semantics)
        inc = nco.freq_to_increment_traced(-offset_hz, cfg.channel_rate)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    fft_state, rf = fftfilt.run_filt(state.fft, xm, jnp.asarray(cfg.rf_filter))

    magsq = (jnp.real(rf) ** 2 + jnp.imag(rf) ** 2).astype(jnp.float32)
    level = 10.0 ** ((cfg.squelch_db if squelch_db is None else squelch_db) / 10.0)
    attack = cfg.rf_bandwidth / 10.0  # bfmdemod.cpp:148 squelch attack
    deltas = jnp.where(magsq >= level, 1.0, -1.0)
    counts = saturating_counter(deltas, 0.0, attack, state.squelch_count)
    sq_open = counts > attack / 2.0

    discri_state, demod = phasediscri.discriminator_conj(
        state.discri, rf, cfg.fm_scaling
    )
    demod = jnp.where(sq_open, demod, 0.0)  # MPX

    # pilot extraction & harmonics. The linear-phase FIR delays the pilot by
    # (ntaps-1)/2 samples; the MPX is delayed identically so the references
    # stay phase-aligned with the subcarriers.
    pilot_state, z = _complex_fir(state.pilot_fir, demod, cfg.pilot_taps)
    gd = state.mpx_delay.shape[-1]
    mpx_ext = jnp.concatenate([state.mpx_delay, demod], axis=-1)
    demod = mpx_ext[..., : demod.shape[-1]]
    new_mpx_delay = mpx_ext[..., demod.shape[-1] :]
    mag = jnp.abs(z)
    unit = z / jnp.maximum(mag, 1e-9).astype(jnp.complex64)
    pilot_level = jnp.mean(mag, axis=-1)
    e2 = unit * unit  # e^{j2θ} — 38 kHz reference
    e3 = e2 * unit  # e^{j3θ} — 57 kHz reference

    # mono (L+R) path
    mono_state, mono_c = resampler.resample_block(
        state.mono_resamp, demod.astype(jnp.complex64), cfg.mono_plan
    )
    mono = jnp.real(mono_c)

    # stereo (L-R) path: product demod of the 38 kHz DSB subcarrier.
    # Phase convention (ITU-R BS.450): subcarrier = sin(2θ) when the pilot
    # is sin(θ). The analytic pilot is z ∝ -i·e^{iθ} (positive-frequency
    # half of sin), so z² ∝ -e^{2iθ}; with this FIR's analytic sign the
    # recovered term is +Im(e2) (pinned against the golden both ways). Using
    # Re(e2) here implements a cos/cos multiplex — self-consistent with a
    # cos-phased test signal but ORTHOGONAL to real broadcasts (caught by
    # the bfm384 reference golden, r4).
    stereo_bb = demod * 2.0 * jnp.imag(e2)
    stereo_state, stereo_c = resampler.resample_block(
        state.stereo_resamp, stereo_bb.astype(jnp.complex64), cfg.mono_plan
    )
    diff = jnp.real(stereo_c)

    tau = cfg.deemphasis_us * 1e-6 * cfg.audio_rate
    if cfg.audio_stereo:
        left = mono + diff
        right = mono - diff
    else:
        left = right = mono
    dl_state, left = iir.rc_lowpass(state.deemph_l, left, tau)
    dr_state, right = iir.rc_lowpass(state.deemph_r, right, tau)
    audio = jnp.stack([left, right], axis=-1) * (
        cfg.volume if volume is None else volume
    )

    # RDS baseband: coherent 57 kHz downmix, ±2.4 kHz lowpass, decimate to
    # 8 samples/symbol
    rds_bb = (demod.astype(jnp.complex64)) * jnp.conj(e3)
    rds_fir_state, rds_bb = firdesign.fir_apply(
        state.rds_fir, rds_bb, jnp.asarray(cfg.rds_prefilter)
    )
    rds_state, rds_out = resampler.resample_block(
        state.rds_resamp, rds_bb, cfg.rds_plan
    )

    new_state = BFMState(
        nco=nco_state, fft=fft_state, squelch_count=counts[..., -1],
        discri=discri_state, pilot_fir=pilot_state, mpx_delay=new_mpx_delay,
        mono_resamp=mono_state,
        stereo_resamp=stereo_state, rds_fir=rds_fir_state, rds_resamp=rds_state,
        deemph_l=dl_state, deemph_r=dr_state,
    )
    return new_state, BFMOutputs(
        audio.astype(jnp.float32), rds_out, pilot_level.astype(jnp.float32)
    )


def meters(state: BFMState, cfg: BFMConfig, dyn: dict) -> dict:
    return {"squelch": state.squelch_count > cfg.rf_bandwidth / 20.0}

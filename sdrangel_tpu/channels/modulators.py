"""Tx modulators: NFM / AM / SSB / WFM.

Reference: plugins/channeltx/mod{nfm,am,ssb,wfm}/*.cpp — pull-model per
sample: pullAF (tone NCO / file / audio FIFO) → modulateSample → Interpolator
to channel rate → carrier NCO (`ci *= m_carrierNco.nextIQ()`, nfmmod.cpp
pull). Block form: the AF block (48 kHz float) is modulated at audio rate,
up-resampled to the channel rate by the conv-mode rational resampler, and
shifted by the carrier NCO; the UpChannelizer then places the channel in the
device passband. The FM phasor accumulation (`m_modPhasor +=`) is a cumsum
with a carried phase — exactly vectorizable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..dsp import fftfilt, firdesign, nco, resampler


def _up_plan(audio_rate: float, channel_rate: float, block_af: int,
             cutoff: float | None = None):
    """Audio→channel-rate resampler with the reference Tx modulators' exact
    interpolator configuration: every channeltx modulator calls
    Interpolator::create(48, audioRate, bw, 3.0) (nfmmod.cpp:423,
    ammod.cpp:407, ssbmod.cpp:659, wfmmod.cpp:427) — 48 phase legs, 3 taps
    per leg, cutoff = rfBandwidth/2.2 (SSB: bandwidth). The cutoff
    deliberately band-limits the modulated signal to the channel's RF
    bandwidth; resampler.make_plan clamps it below the input Nyquist."""
    return resampler.make_plan(audio_rate, channel_rate, block_af,
                               cutoff=cutoff, phase_steps=48,
                               nb_taps_per_phase=3.0)


def _mod_inc(cfg, offset_hz):
    """Carrier-NCO increment: static from cfg, or a traced per-channel
    override."""
    if offset_hz is None:
        return jnp.asarray(nco.freq_to_increment(cfg.input_offset, cfg.channel_rate))
    return nco.freq_to_increment_traced(offset_hz, cfg.channel_rate)


# ---------------------------------------------------------------------------
# NFM / WFM — frequency modulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    fm_deviation: float = 5000.0
    af_bandwidth: float = 3000.0  # AF filter before modulation
    rf_bandwidth: float = 12500.0
    amplitude: float = 0.891  # -1 dB like the reference modulators
    block_af: int = 4096
    #: AF chain: "lowpass" = clean unity-gain lowpass with the true
    #: 2*pi*f_dev/fs phase convention (the reference WFM modulator's
    #: convention, wfmmod.cpp:142); "nfm_ref" = the reference NFM
    #: modulator's exact chain — its Bandpass(300..af_bw) including the
    #: near-zero-DC-sum normalization quirk, folded with the pi/378 phase
    #: fudge (nfmmod.cpp:177) so fmDeviation settings migrate 1:1
    #: (effective deviation ~0.52x the setting, as in the reference).
    af_filter: str = "lowpass"
    #: CTCSS sub-audible tone injection (nfmmod.cpp:170-172): when on, the
    #: phase step mixes 0.85*af + 0.15*378*ctcss (reference weights).
    ctcss_on: bool = False
    ctcss_freq: float = 88.5

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def af_taps(self) -> np.ndarray:
        if self.af_filter == "nfm_ref":
            # (f_dev/fs)*bp(t)*(pi/378) == (2*pi*f_dev/fs) * bp(t)/756;
            # r5: bp(t) is the ring-walk response the reference's
            # Bandpass<T>::filter actually computes, not the symmetric
            # design (firdesign.bandpass_ring_kernel)
            return firdesign.bandpass_ring_kernel(
                301, self.audio_rate, 300.0, self.af_bandwidth) / 756.0
        return firdesign.lowpass(301, self.af_bandwidth / self.audio_rate)


class FMModState(NamedTuple):
    af_filter: firdesign.FirState
    phase: jnp.ndarray  # carried FM phasor (radians)
    up: resampler.ResamplerState
    nco: nco.NCOState
    ctcss_phase: jnp.ndarray  # carried CTCSS tone phase (radians)


def make_fm_state(cfg: FMModConfig, batch_shape=()) -> FMModState:
    return FMModState(
        firdesign.make_state(len(cfg.af_taps), batch_shape),
        jnp.zeros(batch_shape, jnp.float32),
        resampler.init_state(cfg.up, batch_shape),
        nco.make_nco(batch_shape),
        jnp.zeros(batch_shape, jnp.float32),
    )


def fm_modulate(
    state: FMModState, af: jnp.ndarray, cfg: FMModConfig, offset_hz=None
) -> tuple[FMModState, jnp.ndarray]:
    """af: (..., block_af) float in [-1,1] -> (..., block_af*ratio) complex.

    offset_hz: optional traced override of cfg.input_offset (per-channel
    arrays for banked Tx groups — mirrors demod_nfm.process)."""
    fir_state, af_f = firdesign.fir_apply(state.af_filter, af, jnp.asarray(cfg.af_taps))
    ctcss_phase = state.ctcss_phase
    if cfg.ctcss_on:
        # reference mix (nfmmod.cpp:172): (f_dev/fs)*(0.85*bp + 0.15*378*c)
        # *(pi/378) == (2*pi*f_dev/fs)*(0.85*bp/756 + 0.15*c/2) — af_taps
        # already carry the /756 in nfm_ref mode, so weight the filtered AF
        # by 0.85 and add the tone at 0.15/2.
        n = af.shape[-1]
        inc = np.float32(2.0 * np.pi * cfg.ctcss_freq / cfg.audio_rate)
        ph = state.ctcss_phase[..., None] + inc * jnp.arange(
            1, n + 1, dtype=jnp.float32)
        af_f = 0.85 * af_f + 0.075 * jnp.cos(ph)
        ctcss_phase = jnp.mod(ph[..., -1], 2.0 * np.pi).astype(jnp.float32)
    dphi = (2.0 * np.pi * cfg.fm_deviation / cfg.audio_rate) * af_f
    phase = state.phase[..., None] + jnp.cumsum(dphi, axis=-1)
    iq = jnp.exp(1j * phase.astype(jnp.complex64)) * cfg.amplitude
    new_phase = jnp.mod(phase[..., -1], 2.0 * np.pi).astype(jnp.float32)
    up_state, up = resampler.resample_block(state.up, iq.astype(jnp.complex64), cfg.up)
    inc = _mod_inc(cfg, offset_hz)
    nco_state, out = nco.mix_block(state.nco, up, inc)
    return FMModState(fir_state, new_phase, up_state, nco_state,
                      ctcss_phase), out


@dataclasses.dataclass(frozen=True, eq=False)
class NFMModConfig(FMModConfig):
    """The NFM Tx channel's config: FM modulation through the reference
    NFMMod AF chain (bandpass + pi/378 pair — see FMModConfig.af_filter)
    so fmDeviation/afBandwidth settings migrate 1:1 from the reference
    (plugins/channeltx/modnfm/nfmmod.cpp:162-182)."""

    af_filter: str = "nfm_ref"


# ---------------------------------------------------------------------------
# AM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class AMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    mod_factor: float = 0.5  # modulation depth (ammod.cpp:165)
    rf_bandwidth: float = 12500.0
    amplitude: float = 0.5
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)


class AMModState(NamedTuple):
    up: resampler.ResamplerState
    nco: nco.NCOState


def make_am_state(cfg: AMModConfig, batch_shape=()) -> AMModState:
    return AMModState(resampler.init_state(cfg.up, batch_shape), nco.make_nco(batch_shape))


def am_modulate(
    state: AMModState, af: jnp.ndarray, cfg: AMModConfig, offset_hz=None
) -> tuple[AMModState, jnp.ndarray]:
    env = (af * cfg.mod_factor + 1.0) * cfg.amplitude  # ammod.cpp:165 semantics
    iq = env.astype(jnp.complex64)
    up_state, up = resampler.resample_block(state.up, iq, cfg.up)
    inc = _mod_inc(cfg, offset_hz)
    nco_state, out = nco.mix_block(state.nco, up, inc)
    return AMModState(up_state, nco_state), out


# ---------------------------------------------------------------------------
# SSB
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SSBModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    bandwidth: float = 3000.0
    low_cutoff: float = 300.0
    usb: bool = True
    amplitude: float = 0.891
    fft_len: int = 1024
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.bandwidth)

    @functools.cached_property
    def filter_freq(self) -> np.ndarray:
        return fftfilt.create_filter(
            self.low_cutoff / self.audio_rate, self.bandwidth / self.audio_rate,
            self.fft_len,
        )


class SSBModState(NamedTuple):
    fft: fftfilt.FftFiltState
    up: resampler.ResamplerState
    nco: nco.NCOState


def make_ssb_state(cfg: SSBModConfig, batch_shape=()) -> SSBModState:
    return SSBModState(
        fftfilt.make_state(cfg.fft_len, batch_shape),
        resampler.init_state(cfg.up, batch_shape),
        nco.make_nco(batch_shape),
    )


def ssb_modulate(
    state: SSBModState, af: jnp.ndarray, cfg: SSBModConfig, offset_hz=None
) -> tuple[SSBModState, jnp.ndarray]:
    """Real audio → analytic SSB signal via runSSB (ssbmod.cpp pullAF path)."""
    fft_state, ssb = fftfilt.run_ssb(
        state.fft, af.astype(jnp.complex64), cfg.filter_freq, usb=cfg.usb
    )
    up_state, up = resampler.resample_block(state.up, ssb * cfg.amplitude, cfg.up)
    inc = _mod_inc(cfg, offset_hz)
    nco_state, out = nco.mix_block(state.nco, up, inc)
    return SSBModState(fft_state, up_state, nco_state), out


# ---------------------------------------------------------------------------
# WFM — FM with wider deviation and RF filtering
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class WFMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    fm_deviation: float = 75000.0
    af_bandwidth: float = 15000.0
    rf_bandwidth: float = 180000.0
    amplitude: float = 0.891
    fft_len: int = 1024
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        # wfmmod.cpp:454: create(48, audioRate, rfBw/2.2, 3.0) — note the
        # cutoff exceeds the audio Nyquist for wide rfBw (the reference
        # effectively does not AF-filter); make_plan clamps it below
        # Nyquist, which only improves image rejection
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def rf_filter(self) -> np.ndarray:
        # wfmmod.cpp:455-457: create_filter(-rfBw/2, +rfBw/2) — the band
        # form (not create_dsb_filter), symmetric around DC
        fc = 0.5 * self.rf_bandwidth / self.channel_rate
        return fftfilt.create_filter(-fc, fc, self.fft_len)


class WFMModState(NamedTuple):
    up: resampler.ResamplerState
    phase: jnp.ndarray  # carried FM phasor (radians)
    fft: fftfilt.FftFiltState
    nco: nco.NCOState


def make_wfm_state(cfg: WFMModConfig, batch_shape=()) -> WFMModState:
    return WFMModState(
        resampler.init_state(cfg.up, batch_shape),
        jnp.zeros(batch_shape, jnp.float32),
        fftfilt.make_state(cfg.fft_len, batch_shape),
        nco.make_nco(batch_shape),
    )


def wfm_modulate(
    state: WFMModState, af: jnp.ndarray, cfg: WFMModConfig, offset_hz=None
) -> tuple[WFMModState, jnp.ndarray]:
    """The reference WFM composition (wfmmod.cpp pull:110-160): the AF is
    interpolated to the CHANNEL rate first, THEN FM-modulated there with
    the clean 2*pi*f_dev/fs convention (:142), lowpassed by the rfBw/2 OLA
    filter, and shifted by the carrier NCO. (Modulating at the audio rate
    would alias — WFM deviation exceeds the audio Nyquist.)"""
    up_state, afi = resampler.resample_block(
        state.up, af.astype(jnp.complex64), cfg.up)
    dphi = (2.0 * np.pi * cfg.fm_deviation / cfg.channel_rate) * jnp.real(afi)
    phase = state.phase[..., None] + jnp.cumsum(dphi, axis=-1)
    iq = jnp.exp(1j * phase.astype(jnp.complex64)) * cfg.amplitude
    new_phase = jnp.mod(phase[..., -1], 2.0 * np.pi).astype(jnp.float32)
    fft_state, rf = fftfilt.run_filt(
        state.fft, iq.astype(jnp.complex64), jnp.asarray(cfg.rf_filter))
    inc = _mod_inc(cfg, offset_hz)
    nco_state, out = nco.mix_block(state.nco, rf, inc)
    return WFMModState(up_state, new_phase, fft_state, nco_state), out


# ---------------------------------------------------------------------------
# ATV modulator (plugins/channeltx/modatv — analog TV transmitter)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ATVModConfig:
    channel_rate: float
    input_offset: float = 0.0
    # am | fm | usb | lsb | vusb | vlsb (ATVModSettings::ATVModulation,
    # atvmodsettings.h:52-59; v* = vestigial sideband via asym filtering)
    modulation: str = "am"
    lines: int = 625
    fps: float = 25.0
    fm_deviation: float = 2_500_000.0
    sync_level: float = 0.15  # sync tip as a fraction of full scale
    black_level: float = 0.3  # blanking/black pedestal
    hsync_fraction: float = 0.08  # sync-tip width as a fraction of a line
    amplitude: float = 0.891
    rf_bandwidth: float = 6_000_000.0  # in-band width (m_rfBandwidth)
    rf_opp_bandwidth: float = 750_000.0  # vestige width (m_rfOppBandwidth)
    fft_len: int = 1024  # SSB/VSB filter length (atvmod.cpp m_ssbFftLen)

    @property
    def samples_per_line(self) -> int:
        return int(round(self.channel_rate / (self.lines * self.fps)))


class ATVModState(NamedTuple):
    phase: jnp.ndarray  # (...,) FM integrator phase
    off_nco: nco.NCOState  # carried offset-carrier phase (block-seam safe)
    fft: fftfilt.FftFiltState  # SSB/VSB sideband filter overlap


def make_atv_state(cfg: ATVModConfig, batch_shape=()) -> ATVModState:
    return ATVModState(jnp.zeros(batch_shape, jnp.float32), nco.make_nco(batch_shape),
                       fftfilt.make_state(cfg.fft_len, batch_shape))


def atv_composite(cfg: ATVModConfig, frame: jnp.ndarray) -> jnp.ndarray:
    """(n_lines, width) luma in [0,1] -> (n_lines · samples_per_line,)
    composite video: per line [sync tip | black porch | scaled luma].
    The reference builds the same line structure in atvmod.cpp (pointsPerSync
    / pointsPerBP per standard)."""
    spl = cfg.samples_per_line
    n_sync = max(1, int(cfg.hsync_fraction * spl))
    n_porch = max(1, spl // 16)
    n_active = spl - n_sync - n_porch
    n_lines = frame.shape[0]
    # nearest-index resample of luma rows to the active width (host-static)
    idx = (np.arange(n_active) * frame.shape[1] / n_active).astype(np.int32)
    luma = jnp.clip(frame[:, idx].astype(jnp.float32), 0.0, 1.0)
    # levels: sync tip (minimum) < black pedestal < white
    video_lo = cfg.sync_level + cfg.black_level * (1.0 - cfg.sync_level)
    comp = jnp.concatenate(
        [
            jnp.full((n_lines, n_sync), cfg.sync_level, jnp.float32),  # tip
            jnp.full((n_lines, n_porch), video_lo, jnp.float32),  # porch
            video_lo + (1.0 - video_lo) * luma,
        ],
        axis=-1,
    )
    return comp.reshape(-1)


def atv_modulate(
    state: ATVModState, video: jnp.ndarray, cfg: ATVModConfig
) -> tuple[ATVModState, jnp.ndarray]:
    """Composite video (T,) in [0,1] -> complex baseband at channel rate.
    AM: envelope = video (positive modulation); FM: phase integral of the
    deviation-scaled video; USB/LSB: SSB filter over the AM signal; vestigial
    USB/LSB: asymmetric filter keeping rf_opp_bandwidth of the suppressed
    sideband (atvmod.cpp modulation branches :195-250, modulateSSB /
    modulateVestigialSSB). SSB/VSB modes need the block length to be a
    multiple of fft_len/2 (overlap-add hop)."""
    new_fft = state.fft
    if cfg.modulation == "am":
        y = (video * cfg.amplitude).astype(jnp.float32).astype(jnp.complex64)
        new_phase = state.phase
    elif cfg.modulation in ("usb", "lsb"):
        # m_SSBFilter = fftfilt(0, rfBandwidth/rate) + runSSB (atvmod.cpp:85,220)
        x = (video * cfg.amplitude).astype(jnp.float32).astype(jnp.complex64)
        h = fftfilt.create_filter(
            0.0, cfg.rf_bandwidth / cfg.channel_rate, cfg.fft_len)
        new_fft, y = fftfilt.run_ssb(
            state.fft, x, h, usb=(cfg.modulation == "usb"))
        new_phase = state.phase
    elif cfg.modulation in ("vusb", "vlsb"):
        # runAsym through the asym pair: full rf_bandwidth on the kept side,
        # rf_opp_bandwidth vestige on the other (atvmod.cpp:233-250)
        x = (video * cfg.amplitude).astype(jnp.float32).astype(jnp.complex64)
        h_in, h_opp = fftfilt.create_asym_filter(
            cfg.rf_opp_bandwidth / cfg.channel_rate,
            cfg.rf_bandwidth / cfg.channel_rate, cfg.fft_len)
        new_fft, y = fftfilt.run_asym(
            state.fft, x, h_in, h_opp, usb=(cfg.modulation == "vusb"))
        new_phase = state.phase
    else:
        dphi = (
            2.0 * np.pi * cfg.fm_deviation / cfg.channel_rate
        ) * (video - 0.5)
        phase = state.phase[..., None] + jnp.cumsum(dphi, axis=-1)
        y = cfg.amplitude * jnp.exp(1j * phase.astype(jnp.complex64))
        new_phase = jnp.mod(phase[..., -1], 2.0 * np.pi).astype(jnp.float32)
    off_state = state.off_nco
    if cfg.input_offset:
        # carried NCO phase — a per-block arange restarts at 0 each block,
        # jumping the carrier phase at every seam (the other modulators all
        # carry nco state for the same reason)
        inc = jnp.asarray(nco.freq_to_increment(cfg.input_offset, cfg.channel_rate))
        off_state, y = nco.mix_block(state.off_nco, y, inc)
    return ATVModState(new_phase, off_state, new_fft), y

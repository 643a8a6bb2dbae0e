"""Parity vs goldens generated by the ACTUAL reference code.

Every vector in tests/goldens/ was produced by compiling the reference's own
DSP sources (decimators.h, inthalfbandfiltereo.h, nco.cpp, fftfilt.cpp,
interpolator.cpp, phasediscri.h + the nfmdemod.cpp:140-330 feed composition)
behind a 25-line typedef shim — see native/ref_golden_gen.cc and
tools/gen_reference_goldens.py. Unlike the NumPy oracles in the other test
files (independent transcriptions), a shared misreading of the reference
cannot pass here.

Alignment conventions (discovered once, asserted forever):
  * integer decimator cascades: the reference's polyphase commutator anchors
    the output grid at input index 2^log2-1, ours at 0 — goldens compare
    against the JAX path fed x[2^log2-1:]. Output-sample lag beyond that is
    asserted == 0 (cascade) / in {-2..2} (channelizer warmup).
  * scale: the reference pipeline carries gain 2^pre_shift (16 for
    12-bit-in-16 at every factor, decimation_shifts<16,12>) plus gain 2 per
    half-band stage divided out at the end; ours is unity-gain float. The
    fitted complex scale is asserted at the documented value.

SNR bounds are set ~3-5 dB under values measured at commit time; the floor
is the reference's Q12 coefficient quantization (the JAX path uses exact
f64-designed taps), transition-band response differences, and (gather-mode
resampler) the reference's float distance accumulator vs our exact rational
schedule.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from sdrangel_tpu.dsp import (
    channelizer as rchan,
    decimators as rdec,
    fftfilt as rff,
    goertzel as rgz,
    nco as rnco,
    resampler as rres,
)

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
_MANIFEST = json.loads((GOLDEN_DIR / "manifest.json").read_text())


def load(name: str) -> tuple[np.ndarray, dict]:
    entry = _MANIFEST[name]
    if entry["dtype"] == "int16":
        arr = np.fromfile(GOLDEN_DIR / (name + ".i16"), dtype=np.int16)
    else:
        arr = np.fromfile(GOLDEN_DIR / (name + ".f32"), dtype=np.float32)
    assert len(arr) == entry["count"]
    return arr, entry["params"]


def load_iq(name: str) -> tuple[np.ndarray, dict]:
    flat, params = load(name)
    z = flat[0::2].astype(np.float64) + 1j * flat[1::2].astype(np.float64)
    return z, params


def fit_snr(golden: np.ndarray, ours: np.ndarray, skip: int = 256):
    """Least-squares complex scale fit; returns (snr_db, scale)."""
    n = min(len(golden), len(ours))
    a = np.asarray(golden[skip:n], dtype=np.complex128)
    b = np.asarray(ours[skip:n], dtype=np.complex128)
    s = np.vdot(b, a) / max(abs(np.vdot(b, b)), 1e-30)
    err = a - s * b
    snr = 10 * np.log10(abs(np.vdot(s * b, s * b)) / max(abs(np.vdot(err, err)), 1e-30))
    return float(snr), complex(s)


def best_lag(golden, ours, lags, skip=256):
    results = [
        (lag, *fit_snr(golden[max(0, lag):], ours[max(0, -lag):], skip))
        for lag in lags
    ]
    return max(results, key=lambda t: t[1])


# ---------------------------------------------------------------------------
# Integer decimator cascades (Decimators<qint32,qint16,16,12>)
# ---------------------------------------------------------------------------

def test_decimate1_is_exact_preshift():
    """decimate1 = <<4 pre-shift (decimation_shifts<16,12>::pre1), bit-exact."""
    x, _ = load("decii_cen_l0_input")
    g, _ = load("decii_cen_l0")
    np.testing.assert_array_equal(g, x.astype(np.int32) * 16)


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_decimator_cascade_matches_reference(log2, fc_pos):
    name = f"decii_{fc_pos}_l{log2}"
    x, _ = load_iq(name + "_input")
    golden, _ = load_iq(name)
    shift = (1 << log2) - 1
    ours = rdec.decimate_reference_oracle(x[shift:], log2, fc_pos)
    snr, scale = fit_snr(golden, ours, skip=128)
    # measured r3: 60.7..76.8 dB; scale 2^4 from the 12->16 bit pre-shift
    assert snr > 57.0, f"{name}: snr {snr:.1f} dB"
    assert abs(abs(scale) - 16.0) < 0.16, f"{name}: scale {scale}"


def test_decimator_jax_path_matches_reference():
    """The jitted cascade (not just the NumPy oracle) against the golden."""
    name = "decii_cen_l6"
    x, _ = load_iq(name + "_input")
    golden, _ = load_iq(name)
    xx = x[63:]
    xx = xx[: len(xx) // 64 * 64].astype(np.complex64)
    state = rdec.init_state(6)
    state, y = rdec.decimate_cascade(state, xx, 6, "cen")
    snr, scale = fit_snr(golden, np.asarray(y), skip=128)
    assert snr > 57.0, f"{name} jax: snr {snr:.1f} dB"
    assert abs(abs(scale) - 16.0) < 0.16


def test_decimators_unsigned_matches_reference():
    """DecimatorsU<qint32,quint8,16,8,127> (rtlsdr u8 ingest), ÷4 centre."""
    flat, params = load("decu_input")
    u8 = flat.astype(np.float64)  # stored widened to i16
    x = (u8[0::2] - 127.0) + 1j * (u8[1::2] - 127.0)
    golden, _ = load_iq("decu_cen_l2")
    ours = rdec.decimate_reference_oracle(x[3:], 2, "cen")
    a = golden - golden.mean()  # the reference's 127 vs our 127.4 offset is DC
    b = ours - ours.mean()
    snr, scale = fit_snr(a, b, skip=128)
    assert snr > 45.0, f"decu: snr {snr:.1f} dB"
    # 8-bit in 16: 2^8 pre-shift (decimation_shifts<16,8>)
    assert abs(abs(scale) - 256.0) < 2.0, f"decu: scale {scale}"


@pytest.mark.parametrize("name", ["decif_cen_l4", "decff_cen_l4", "decfi_cen_l4"])
def test_decimators_float_paths_match_reference(name):
    """DecimatorsIF/FF/FI ÷16 centre — one float kernel in our design."""
    inp = {"decif_cen_l4": "decif_input", "decff_cen_l4": "decff_input",
           "decfi_cen_l4": "decff_input"}[name]
    x, _ = load_iq(inp)
    golden, _ = load_iq(name)
    ours = rdec.decimate_reference_oracle(x[15:], 4, "cen")
    snr, scale = fit_snr(golden, ours, skip=64)
    assert snr > 45.0, f"{name}: snr {snr:.1f} dB"


# ---------------------------------------------------------------------------
# NCO (nco.cpp LUT wheel) — bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["nco_m12000_48k", "nco_1234p5_48k", "nco_100k_768k"])
def test_nco_lut_bit_exact(name):
    golden, params = load_iq(name)
    state = rnco.make_nco_lut()
    inc = rnco.lut_increment(params["freq"], params["rate"])
    _, z = rnco.nco_lut_block(state, inc, len(golden))
    np.testing.assert_array_equal(np.asarray(z), golden.astype(np.complex64))


# ---------------------------------------------------------------------------
# fftfilt OLA (fftfilt.cpp) — SSB / DSB / Asym
# ---------------------------------------------------------------------------

def _fftfilt_input() -> np.ndarray:
    x, _ = load_iq("fftfilt_input")
    return x.astype(np.complex64)


@pytest.mark.parametrize("name,usb,bound", [
    ("fftfilt_ssb_usb", True, 95.0),
    ("fftfilt_ssb_lsb", False, 80.0),
])
def test_fftfilt_ssb(name, usb, bound):
    golden, params = load_iq(name)
    h = rff.create_filter(300 / 48000, 3000 / 48000, 1024)
    _, y = rff.run_ssb(rff.make_state(1024), _fftfilt_input(), h, usb=usb)
    snr, scale = fit_snr(golden, np.asarray(y).ravel(), skip=0)
    assert snr > bound, f"{name}: snr {snr:.1f} dB"
    assert abs(scale - 1.0) < 1e-3


def test_fftfilt_dsb():
    golden, _ = load_iq("fftfilt_dsb")
    h = rff.create_dsb_filter(3000 / 48000, 1024)
    _, y = rff.run_dsb(rff.make_state(1024), _fftfilt_input(), h)
    snr, scale = fit_snr(golden, np.asarray(y).ravel(), skip=0)
    assert snr > 120.0, f"dsb: snr {snr:.1f} dB"
    assert abs(scale - 1.0) < 1e-4


def test_fftfilt_asym():
    golden, _ = load_iq("fftfilt_asym_usb")
    h_in, h_opp = rff.create_asym_filter(500 / 48000, 3000 / 48000, 1024)
    _, y = rff.run_asym(rff.make_state(1024), _fftfilt_input(), h_in, h_opp, usb=True)
    snr, scale = fit_snr(golden, np.asarray(y).ravel(), skip=0)
    assert snr > 80.0, f"asym: snr {snr:.1f} dB"
    assert abs(scale - 1.0) < 1e-3


# ---------------------------------------------------------------------------
# Interpolator (polyphase resampler, interpolator.{h,cpp})
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,bound,expect_mode", [
    ("interp_96k_48k", 110.0, "gather"),  # measured 133 dB: exact-delay legs
    ("interp_125k_48k", 48.0, "gather"),  # measured 52 dB: float-vs-exact
])                                        # distance accumulator phase picks
def test_interpolator_matches_reference(name, bound, expect_mode):
    x, _ = load_iq("interp_input")
    golden, params = load_iq(name)
    plan = rres.make_plan(params["in_rate"], params["out_rate"], 16000,
                          cutoff=params["cutoff"])
    assert plan.mode == expect_mode
    state = rres.init_state(plan)
    _, y = rres.resample_block(state, x[:16000].astype(np.complex64), plan)
    lag, snr, scale = best_lag(golden, np.asarray(y).ravel(), range(-4, 5))
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(scale) - 1.0) < 2e-3


# ---------------------------------------------------------------------------
# DownChannelizer order-48 stage chains (inthalfbandfiltereo.h workDecimate*)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,modes", [
    ("chan_cen_cen", (0, 0)),
    ("chan_low_up_cen", (1, 2, 0)),
    ("chan_up_low", (2, 1)),
])
def test_channelizer_chain_matches_reference(name, modes):
    x, _ = load_iq(name + "_input")
    golden, _ = load_iq(name)
    k = len(modes)
    # golden mode codes 0/1/2 = centre/lower/upper -> plan signs 0/+1/-1
    signs = tuple({0: 0, 1: +1, 2: -1}[m] for m in modes)
    plan = rchan.ChannelPlan(signs=signs, decimation=1 << k,
                             channel_rate=0.0, residual_offset=0.0)
    shift = (1 << k) - 1
    blk = 8 << k
    xx = x[shift:]
    xx = xx[: len(xx) // blk * blk].astype(np.complex64)
    state = rchan.init_state(k)
    _, y = rchan.channelize(state, xx, plan)
    lag, snr, scale = best_lag(golden, np.asarray(y).ravel(), range(-2, 3))
    # measured r3: 60.8..62.2 dB, lag 0, |scale| 1 (sign of the rotation
    # sequence start shows up as a constant -1 for some chains)
    assert snr > 57.0, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert lag == 0
    assert abs(abs(scale) - 1.0) < 5e-3


# ---------------------------------------------------------------------------
# Full NFM chain (nfmdemod.cpp feed composition, reference primitives)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,rate,offset,bound", [
    ("nfm48", 48000.0, 0.0, 58.0),   # measured 65.7 (was 50.9 before the
    ("nfm96", 96000.0, 12000.0, 58.0),  # measured 66.9  rf/2.2 cutoff fix)
    # r5: the PRODUCT path's channel rate (10 MS/s /64 -> 156250 Hz,
    # resampler 625/192) — certifies the reference-exact schedule at the
    # awkward-rational ratio the session actually runs
    ("nfm156", 156250.0, 20000.0, 58.0),  # measured 62.1
])
def test_nfm_chain_matches_reference(name, rate, offset, bound):
    from sdrangel_tpu.channels import demod_nfm

    gi, _ = load_iq(name + "_input")
    x = (gi / 32768.0).astype(np.complex64)
    golden, params = load(name + "_audio")
    cfg = demod_nfm.NFMConfig(
        channel_rate=rate, input_offset=offset, audio_rate=48000.0,
        rf_bandwidth=12500.0, af_bandwidth=3000.0, fm_deviation=2000.0,
        squelch_db=-30.0,  # reference centibels -300 -> power 1e-3
        squelch_gate_ms=50.0, volume=1.0, block_in=0,
    )
    blk = (len(x) // cfg.resampler_plan.block_in) * cfg.resampler_plan.block_in
    cfg = demod_nfm.NFMConfig(
        channel_rate=rate, input_offset=offset, audio_rate=48000.0,
        rf_bandwidth=12500.0, af_bandwidth=3000.0, fm_deviation=2000.0,
        squelch_db=-30.0, squelch_gate_ms=50.0, volume=1.0, block_in=blk,
    )
    state = demod_nfm.make_state(cfg)
    _, audio = demod_nfm.process(state, x[:blk], cfg)
    y = np.asarray(audio).ravel()
    # steady state: skip squelch gate (2400) + filter transients
    lag, snr, scale = best_lag(golden.astype(np.float64), y, range(-8, 9), skip=8000)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag}, scale {scale})"


@pytest.mark.parametrize("name,rate,offset,bound", [
    # the full chain with the reference's OWN atan2_approximation2 as the
    # test-only parity mode: near bit-parity — the exact-mode residual IS
    # the reference's approximation (the r5 demonstrated-attribution
    # pattern, cf. test_wfm_chain_ref_atan2_parity)
    ("nfm48", 48000.0, 0.0, 130.0),    # measured 136.9
    ("nfm96", 96000.0, 12000.0, 130.0),  # measured 137.5
    # nfm156 stays ~61: capped by the reference's f32 resampler distance
    # drift at q=192 (see test_nfm_stage_resampler docstring), which the
    # atan2 mode cannot recover
    ("nfm156", 156250.0, 20000.0, 55.0),
])
def test_nfm_chain_ref_atan2_parity(name, rate, offset, bound):
    from sdrangel_tpu.channels import demod_nfm

    gi, _ = load_iq(name + "_input")
    x = (gi / 32768.0).astype(np.complex64)
    golden, params = load(name + "_audio")
    probe = demod_nfm.NFMConfig(
        channel_rate=rate, input_offset=offset, rf_bandwidth=12500.0,
        af_bandwidth=3000.0, fm_deviation=2000.0, squelch_db=-30.0,
        squelch_gate_ms=50.0, block_in=0)
    blk = (len(x) // probe.resampler_plan.block_in) * probe.resampler_plan.block_in
    cfg = demod_nfm.NFMConfig(
        channel_rate=rate, input_offset=offset, rf_bandwidth=12500.0,
        af_bandwidth=3000.0, fm_deviation=2000.0, squelch_db=-30.0,
        squelch_gate_ms=50.0, block_in=blk, ref_atan2_approx=True)
    state = demod_nfm.make_state(cfg)
    _, audio = demod_nfm.process(state, x[:blk], cfg)
    lag, snr, scale = best_lag(golden.astype(np.float64),
                               np.asarray(audio).ravel(), range(-8, 9),
                               skip=8000)
    assert snr > bound, f"{name} approx parity: {snr:.1f} dB (lag {lag})"


# ---------------------------------------------------------------------------
# CTCSS detector (ctcssdetector.cpp via the NFM ÷8 tap)
# ---------------------------------------------------------------------------

def test_ctcss_detected_tone_matches_reference():
    golden, params = load("ctcss_detected_idx")
    idx = int(golden[-1])
    # first analysis window is warmup (-1 = no detection), then stable
    assert np.all(golden[1:] == idx), "reference detection should settle"
    # our detector on the same synthetic scene (88.5 Hz + voice tone)
    n = 48000 * 2
    t = np.arange(n)
    s = (0.15 * np.sin(2 * np.pi * 88.5 * t / 48000.0)
         + 0.5 * np.sin(2 * np.pi * 700.0 * t / 48000.0))
    x6k = s[7::8].astype(np.float32)
    frame = 3000  # = audio_rate/16 at 48 kHz (nfmdemod.cpp:86)
    frames = x6k[: len(x6k) // frame * frame].reshape(-1, frame)
    res = rgz.ctcss_detect(frames, 6000.0)
    got = np.asarray(res.tone_index)
    tone_hz = rgz.CTCSS_TONES[idx] if idx >= 0 else None
    ours_hz = rgz.CTCSS_TONES[int(got[-1])]
    assert tone_hz is not None and abs(ours_hz - 88.5) < 0.5
    assert abs(tone_hz - 88.5) < 3.0  # reference tone set resolution


# ---------------------------------------------------------------------------
# Tx path (VERDICT r3 #3 — previously validated only by self-loopback):
# device interpolation cascades, UpChannelizer interpolation chains, the
# Tx-direction Interpolator, and the full NFM modulator composition, all
# against goldens from the compiled reference code (ref_golden_gen_tx.cc).
# ---------------------------------------------------------------------------

def band_fit(a: np.ndarray, b: np.ndarray, frac: float):
    """Least-squares fit restricted to |f| <= frac (normalized): the Tx
    cascades' wanted band is the input band; outside it the reference's
    order-16 deep stages leak interpolation images at -16 dB that our
    uniform order-64 chain suppresses (a deliberate improvement, like the
    Rx in-band-tones convention at the top of this file)."""
    n = min(len(a), len(b))
    aw = np.asarray(a[:n]) * np.hanning(n)
    bw = np.asarray(b[:n]) * np.hanning(n)
    fa, fb = np.fft.fft(aw), np.fft.fft(bw)
    m = np.abs(np.fft.fftfreq(n)) <= frac
    fa, fb = fa[m], fb[m]
    s = np.vdot(fb, fa) / max(abs(np.vdot(fb, fb)), 1e-30)
    err = fa - s * fb
    snr = 10 * np.log10(abs(np.vdot(s * fb, s * fb))
                        / max(abs(np.vdot(err, err)), 1e-30))
    return float(snr), complex(s)


@pytest.mark.parametrize("log2,lag,bound", [
    (1, 0, 60.0),     # measured 66.2
    (2, -16, 57.0),   # measured 62.6
    (4, -136, 55.0),  # measured 60.4
    (6, -618, 38.0),  # measured 43.4 (Q12 order-16 stages + comb skirts)
])
def test_tx_cascade_matches_reference(log2, lag, bound):
    """Interpolators<qint16,16,16> interpolateN_cen (interpolators.h:103-130,
    the filesinkthread.h:73 device Tx cascade) vs interpolate_cascade.

    The x64 case needs TWO documented accommodations:
      * in-band comparison (uniform order-64 vs the reference's 64/32/16
        orders — its images sit at -16 dB, ours below -60);
      * the reference's interpolate64_cen writes only buf[pos+0..109] of
        each 128-int block (interpolators.h — the last 18 ints are LEFT
        UNWRITTEN, an upstream bug zeroing 9 of every 64 output samples);
        the test applies the same 55-of-64 mask to our output. With the
        mask the fitted scale returns to 1.0 (= 55/64 unmasked).
    """
    from sdrangel_tpu.dsp import interpolators as itp
    import jax.numpy as jnp

    x, _ = load_iq("txinterp_input")
    golden, _ = load_iq(f"txinterp_cen_l{log2}")
    state = itp.init_state(log2, order=64)
    _, y = itp.interpolate_cascade(
        state, jnp.asarray(x.astype(np.complex64)), log2)
    y = np.asarray(y)
    gg = golden[max(0, lag):]
    oo = y[max(0, -lag):]
    if log2 == 6:
        idx = np.arange(min(len(gg), len(oo)))
        oo = oo[: len(idx)] * ((idx % 64) < 55)
    snr, s = band_fit(gg[2048:2048 + (1 << 17)], oo[2048:2048 + (1 << 17)],
                      0.45 / (1 << log2))
    assert snr > bound, f"l{log2}: in-band snr {snr:.1f} dB"
    assert abs(abs(s) - 1.0) < 2e-3, f"l{log2}: scale {s}"


@pytest.mark.parametrize("name,modes,lag,bound", [
    ("upchan_cen_cen", (0, 0), 12, 54.0),       # measured 59.1
    ("upchan_low_up", (1, 2), 12, 55.0),        # measured 60.1
    ("upchan_up_low_cen", (2, 1, 0), 28, 53.0),  # measured 57.7
])
def test_upchannelizer_chain_matches_reference(name, modes, lag, bound):
    """UpChannelizer pull chains (IntHalfbandFilterDB<qint32,96>
    workInterpolateCenter/LowerHalf/UpperHalf driven by the exact
    upchannelizer.cpp:51-88 loop) vs upchannelize — pins the interpolation
    AND the per-stage placement rotations against compiled reference code."""
    from sdrangel_tpu.dsp import interpolators as itp
    from sdrangel_tpu.dsp.channelizer import ChannelPlan
    import jax.numpy as jnp

    x, _ = load_iq(name + "_input")
    golden, _ = load_iq(name)
    k = len(modes)
    signs = tuple({0: 0, 1: +1, 2: -1}[m] for m in modes)
    plan = ChannelPlan(signs=signs, decimation=1 << k,
                       channel_rate=0.0, residual_offset=0.0)
    state = itp.init_state(k)
    _, y = itp.upchannelize(state, jnp.asarray(x.astype(np.complex64)), plan)
    got_lag, snr, s = best_lag(golden, np.asarray(y), range(lag - 4, lag + 5))
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {got_lag})"
    assert abs(abs(s) - 1.0) < 2e-3


@pytest.mark.parametrize("name,out_rate,bound", [
    ("interp_48k_96k", 96000.0, 120.0),   # measured 132.0
    ("interp_48k_120k", 120000.0, 118.0),  # measured 130.3
])
def test_tx_interpolator_matches_reference(name, out_rate, bound):
    """Interpolator::interpolate (interpolator.h:39-52 — the Tx direction
    of every channeltx modulator) vs the resampler's upsample schedule:
    same legs, same recurrence, lag 0, scale 1."""
    x, _ = load_iq("interp_input")
    golden, _ = load_iq(name)
    plan = rres.make_plan(48000.0, out_rate, 16000, cutoff=12500.0 / 2.2,
                          phase_steps=48, nb_taps_per_phase=3.0)
    assert plan.mode == "gather"
    state = rres.init_state(plan)
    _, y = rres.resample_block(
        state, np.asarray(x[:16000], np.complex64), plan)
    lag, snr, s = best_lag(golden, np.asarray(y).ravel(), range(-4, 5))
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert lag == 0
    assert abs(abs(s) - 1.0) < 1e-4


@pytest.mark.parametrize("name,offset,ctcss,bound,f_bound", [
    ("nfmmod96", 0.0, False, 58.0, 2.0),        # measured 65.8 / 0.51 Hz
    ("nfmmod96_off12k", 12000.0, False, 58.0, 2.0),
    ("nfmmod96_ctcss", 0.0, True, 24.0, 8.0),   # measured 29.8 / 2.91 Hz:
    # the floor is the reference NCOF's 4096-entry table truncation on the
    # 88.5 Hz tone (we integrate the exact phase) accumulating in the FM
    # phasor — the instantaneous-frequency bound pins the trajectory.
])
def test_nfm_modulator_matches_reference(name, offset, ctcss, bound, f_bound):
    """Full NFMMod composition (nfmmod.cpp pull:104-146 +
    modulateSample:162-182, tone input): NCOF tone -> Bandpass(300..3k with
    its near-zero-DC-sum normalization) -> pi/378 phase step -> -1 dB ->
    Interpolator(48,rfBw/2.2,3) -> carrier NCO, vs fm_modulate with
    NFMModConfig (af_filter="nfm_ref"). The golden's exact tone sequence is
    saved by the generator and fed to both sides."""
    from sdrangel_tpu.channels import modulators as mods
    import jax.numpy as jnp

    af, _ = load(name + "_af")
    golden, _ = load_iq(name)
    cfg = mods.NFMModConfig(
        channel_rate=96000.0, input_offset=offset, fm_deviation=5000.0,
        af_bandwidth=3000.0, rf_bandwidth=12500.0,
        amplitude=0.891235351562, block_af=len(af),
        ctcss_on=ctcss, ctcss_freq=88.5)
    state = mods.make_fm_state(cfg)
    _, y = mods.fm_modulate(state, jnp.asarray(af.astype(np.float32)), cfg)
    y = np.asarray(y)
    lag, snr, s = best_lag(golden, y, range(-10, 11), skip=1024)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag})"
    # scale = SDR_TX_SCALEF (dsptypes.h:38) — our [-1,1] float vs the
    # reference's 16-bit full-scale floats
    assert abs(abs(s) / 32768.0 - 1.0) < 2e-3, f"scale {s}"
    n = min(len(golden), len(y))
    gg, oo = golden[max(0, lag):n], y[max(0, -lag):n]
    m = min(len(gg), len(oo))
    fg = np.angle(gg[1:m] * np.conj(gg[:m - 1])) * 96000 / (2 * np.pi)
    fo = np.angle(oo[1:m] * np.conj(oo[:m - 1])) * 96000 / (2 * np.pi)
    rmse = float(np.sqrt(np.mean((fg[4096:] - fo[4096:]) ** 2)))
    assert rmse < f_bound, f"{name}: inst-freq RMSE {rmse:.2f} Hz"


# ---------------------------------------------------------------------------
# Per-stage NFM decomposition (VERDICT r3 #9): each stage of the NFM chain
# pinned against the reference feed's own intermediate taps, fed with the
# REFERENCE's stage input so errors cannot cascade. Finding: the old
# resampler cutoff rf_bw/2.0 measured 41 dB here — the reference uses
# rf_bw/2.2 (nfmdemod.cpp:425); aligned, the stage hits 137 dB.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,rate,offset,bound", [
    ("nfm48", 48000.0, 0.0, 300.0),   # measured 355.8 (exact)
    ("nfm96", 96000.0, 12000.0, 130.0),  # measured 138.5
])
def test_nfm_stage_nco_matches_reference(name, rate, offset, bound):
    x, _ = load_iq(name + "_input")
    golden, _ = load_iq(name + "_postnco")
    state = rnco.make_nco()
    import jax.numpy as jnp
    inc = jnp.asarray(rnco.freq_to_increment(-offset, rate))
    _, xm = rnco.mix_block(state, jnp.asarray(x.astype(np.complex64)), inc)
    snr, s = fit_snr(golden, np.asarray(xm), skip=16)
    assert snr > bound, f"{name} postnco: {snr:.1f} dB"
    assert abs(abs(s) - 1.0) < 1e-4


@pytest.mark.parametrize("name,rate,bound", [
    ("nfm48", 48000.0, 130.0),   # measured 136.8
    ("nfm96", 96000.0, 130.0),   # measured 136.6
    # r5: the 625/192 product ratio. Measured 56.6 dB — the residual is
    # the reference's FLOAT32 distance accumulator: at q=192 its
    # floor(distance*16) lands near phase boundaries and f32 drift flips
    # ~8.3% of leg choices (and shifts 0.5% of emission positions) vs the
    # exact-rational schedule here; re-simulating the recurrence in f32
    # raises the match to 70.2 dB with the remaining gap being compiled-
    # code fp details. Our schedule is the exact one; the reference's is
    # the drifted one (demonstrated in-session, r5).
    ("nfm156", 156250.0, 50.0),
])
def test_nfm_stage_resampler_matches_reference(name, rate, bound):
    """Feed the reference's post-NCO tap through OUR resampler configured
    exactly as demod_nfm configures it; compare to the reference's
    post-resampler tap."""
    from sdrangel_tpu.channels import demod_nfm

    gn, _ = load_iq(name + "_postnco")
    golden, _ = load_iq(name + "_postresamp")
    probe = demod_nfm.NFMConfig(channel_rate=rate, rf_bandwidth=12500.0,
                                block_in=0)
    per = probe.resampler_plan.block_in
    cfg = demod_nfm.NFMConfig(channel_rate=rate, rf_bandwidth=12500.0,
                              block_in=(len(gn) // per) * per)
    plan = cfg.resampler_plan
    state = rres.init_state(plan)
    _, ci = rres.resample_block(
        state, np.asarray(gn[:plan.block_in], np.complex64), plan)
    lag, snr, s = best_lag(golden, np.asarray(ci).ravel(), range(-4, 5))
    assert snr > bound, f"{name} postresamp: {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) - 1.0) < 1e-4


@pytest.mark.parametrize("name,bound", [
    ("nfm48", 34.0),   # measured 39.1
    ("nfm96", 34.0),   # measured 37.8
])
def test_nfm_stage_discriminator_matches_reference(name, bound):
    """Reference post-resampler tap through OUR discriminator vs the
    reference's post-discriminator tap. The ~38 dB floor is the
    REFERENCE's atan2_approximation2 (phasediscri.h — a scalar-CPU speed
    hack; we use exact atan2), not a chain divergence. The
    fitted scale pins the fmScaling convention ratio: reference
    8*audioRate/fmDev = 192 vs our unit-normalized audio_rate/(2*fm_dev)."""
    from sdrangel_tpu.dsp import phasediscri as rpd

    gr, _ = load_iq(name + "_postresamp")
    golden, _ = load(name + "_postdiscri")
    state = rpd.make_state()
    _, dem, _ = rpd.discriminator_delta(
        state, np.asarray(gr, np.complex64), 1.0)
    lag, snr, s = best_lag(golden.astype(np.float64),
                           np.asarray(dem).astype(np.float64), range(-2, 3))
    assert snr > bound, f"{name} postdiscri: {snr:.1f} dB"
    assert abs(s.real - 192.0) < 0.2  # 8*48000/2000 (nfmdemod applySettings:507)


def test_wfm_modulator_matches_reference():
    """Full WFMMod composition (wfmmod.cpp pull:110-160, file-input branch):
    AF interpolated to the channel rate, FM phasor THERE (the 2*pi
    convention of :142 — modulating at the audio rate would alias the
    75 kHz deviation), rfBw/2 OLA band filter, carrier NCO. The ~35 dB
    waveform floor is f32 FM phase accumulation; the instantaneous-
    frequency bound (~32 Hz RMSE on a 53 kHz-RMS trajectory, -64 dB) pins
    the modulation itself."""
    from sdrangel_tpu.channels import modulators as mods
    import jax.numpy as jnp

    af, _ = load("wfmmod384_af")
    af = af[: len(af) // 64 * 64]  # fftfilt hop alignment
    golden, _ = load_iq("wfmmod384")
    cfg = mods.WFMModConfig(
        channel_rate=384000.0, fm_deviation=75000.0, rf_bandwidth=180000.0,
        amplitude=0.891235351562, block_af=len(af))
    state = mods.make_wfm_state(cfg)
    _, y = mods.wfm_modulate(state, jnp.asarray(af.astype(np.float32)), cfg)
    y = np.asarray(y)
    lag, snr, s = best_lag(golden, y, range(129, 142), skip=2048)
    assert snr > 30.0, f"wfm: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) / 32768.0 - 1.0) < 2e-3
    n = min(len(golden), len(y))
    gg, oo = golden[max(0, lag):n], y[max(0, -lag):n]
    m = min(len(gg), len(oo))
    fg = np.angle(gg[1:m] * np.conj(gg[:m - 1])) * 384000 / (2 * np.pi)
    fo = np.angle(oo[1:m] * np.conj(oo[:m - 1])) * 384000 / (2 * np.pi)
    rmse = float(np.sqrt(np.mean((fg[8192:] - fo[8192:]) ** 2)))
    assert rmse < 60.0, f"wfm inst-freq RMSE {rmse:.1f} Hz"


# ---------------------------------------------------------------------------
# AM / SSB / WFM Rx full chains (r4): the exact feed compositions of
# amdemod.cpp:101-282, ssbdemod.cpp:152-262 and wfmdemod.cpp:96-160 compiled
# into goldens (ref_golden_gen.cc gen_am_chain/gen_ssb_chain/gen_wfmrx_chain).
# Chasing these flushed out two real divergences: the AM envelope was not
# SimpleAGC-normalized ((env-mean)/mean — loudness must track modulation
# depth, not carrier level), and the NCO block phase convention was one step
# behind the reference's increment-before-read (invisible to FM/AM
# detectors, a hard ~20 dB cap on the SSB mono sum).
# ---------------------------------------------------------------------------

def _real_best_lag(golden, ours, lags, skip):
    def fit(a, b):
        n = min(len(a), len(b))
        a, b = np.asarray(a[skip:n], float), np.asarray(b[skip:n], float)
        s = np.dot(b, a) / max(np.dot(b, b), 1e-30)
        err = a - s * b
        return (10 * np.log10(max(np.dot(s * b, s * b), 1e-30)
                              / max(np.dot(err, err), 1e-30)), s)
    return max(((l, *fit(golden[max(0, l):], ours[max(0, -l):]))
                for l in lags), key=lambda t: t[1])


def test_am_chain_matches_reference():
    """Envelope-path AM (amdemod.cpp processOneSample): squelch-delayed
    sqrt(magsq), SimpleAGC volume normalization, 300..rfBw/2 bandpass,
    smootherstep attack. Measured 109.2 dB at lag 1921 (= the reference's
    rate/20 envelope delay 2400 − our 480 squelch gate + resampler lead)
    with scale EXACTLY audioRate/24 — absolute loudness migrates 1:1
    (the exact near-zero-DC-sum x 1/301 gain pair, ADVICE r4).

    r5 post-mortem of the old "55.9 dB at lag ~2738" record: BOTH numbers
    were artifacts. The lag window missed the true alignment and the fit
    tone-locked a half-period off (the audio is nearly a pure 1 kHz
    tone), and the remaining gap was the audio bandpass being the
    reference's symmetric DESIGN instead of the one-sample-asymmetric
    response its ring filter ACTUALLY computes
    (firdesign.bandpass_ring_kernel; stage-pinned at 124.4 dB vs 77.2 on
    the reference's own pre-bandpass stream)."""
    from sdrangel_tpu.channels import demod_am
    import jax.numpy as jnp

    flat, _ = load("am96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load("am96_audio")
    cfg = demod_am.AMConfig(channel_rate=96000.0, input_offset=5000.0,
                            rf_bandwidth=5000.0, squelch_db=-40.0,
                            volume=1.0, bandpass_enable=True, block_in=len(x))
    state = demod_am.make_state(cfg)
    _, audio = demod_am.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel()
    lag, snr, s = _real_best_lag(golden.astype(float), y,
                                 range(1890, 1960), 16000)
    assert snr > 100.0, f"am96: snr {snr:.1f} dB (lag {lag})"
    assert abs(s / 2000.0 - 1.0) < 0.001, f"scale {s} (expect rate/24)"


@pytest.mark.parametrize("name,usb", [
    ("ssb96agc", True),
    ("ssb96lsb", False),
])
def test_ssb_chain_matches_reference(name, usb):
    """SSB with AGC (the only live SSB configuration in this reference
    version — see below), both sidebands: NCO → 2-taps/leg resampler →
    runSSB → MagAGC → stepDownDelay line → read-side step gating →
    (re+im)*0.7*(volume/4). Measured 118.3/118.1 dB with fitted scale
    EXACTLY 1.0 in 32768-units. (r5: the old 60.0 dB record was the
    one-sample resampler stream lead hitting the framing-sensitive OLA
    sideband filter — every stage measured 118+ dB individually; the
    structural one-sample aligner, SSBState.align, restored the
    reference's framing.)"""
    from sdrangel_tpu.channels import demod_ssb
    import jax.numpy as jnp

    flat, _ = load(name + "_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load(name + "_audio")
    cfg = demod_ssb.SSBConfig(channel_rate=96000.0, input_offset=3000.0,
                              bandwidth=3000.0, low_cutoff=300.0, usb=usb,
                              volume=2.0, agc_enable=True, block_in=len(x))
    state = demod_ssb.make_state(cfg)
    _, audio = demod_ssb.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel() * 32768.0
    lag, snr, s = _real_best_lag(golden.astype(float), y, range(-5, 6), 12000)
    assert snr > 110.0, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-4, f"scale {s}"


def test_ssb_agc_off_is_muted_in_reference():
    """Upstream quirk record: with m_agcActive false the v4.0.6 SSB path
    multiplies by a step value that is never advanced (ssbdemod.cpp:216-225,
    agc.cpp:196-207) — the golden is ALL ZEROS. This framework deliberately
    keeps a sane passthrough instead (demod_ssb.process agc-off branch)."""
    golden, _ = load("ssb96_audio")
    assert np.abs(golden).max() == 0.0


def test_wfm_chain_matches_reference():
    """WFM Rx (wfmdemod.cpp feed): NCO → ±rfBw/2 OLA band filter at the
    channel rate → discriminator AT the channel rate → afBw resampler.
    79.1 dB measured in the shipping (exact-atan2) mode — the r4 29.7 dB
    floor was a REAL divergence, not the asserted atan2 attribution: the
    audio resampler's window anchor was 2 input samples off the reference
    schedule at 8:1 ratios (a 1/4-output-sample shift; fixed r5 by
    simulating Interpolator::decimate's recurrence exactly in
    resampler.make_plan). The remaining ~79 dB residual IS the reference's
    atan2_approximation2 — demonstrated by test_wfm_chain_ref_atan2_parity
    jumping to 134 dB with the approximation enabled."""
    from sdrangel_tpu.channels import demod_wfm
    import jax.numpy as jnp

    flat, _ = load("wfmrx384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load("wfmrx384_audio")
    cfg = demod_wfm.WFMConfig(channel_rate=384000.0, input_offset=0.0,
                              rf_bandwidth=180000.0, af_bandwidth=15000.0,
                              squelch_db=-60.0, volume=1.0, block_in=len(x))
    state = demod_wfm.make_state(cfg)
    _, audio = demod_wfm.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel()
    lag, snr, s = _real_best_lag(golden.astype(float), y, range(-30, 31), 8000)
    assert snr > 70.0, f"wfmrx384: snr {snr:.1f} dB (lag {lag})"


def test_wfm_chain_ref_atan2_parity():
    """Demonstrated attribution (VERDICT r4 next #3): with the reference's
    own atan2_approximation2 (phasediscri.h:172-197) enabled as the
    test-only parity mode, the SAME chain matches its golden at 134 dB —
    the exact-mode 79 dB residual is the reference's approximation error,
    not a divergence here."""
    from sdrangel_tpu.channels import demod_wfm
    import jax.numpy as jnp

    flat, _ = load("wfmrx384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load("wfmrx384_audio")
    cfg = demod_wfm.WFMConfig(channel_rate=384000.0, input_offset=0.0,
                              rf_bandwidth=180000.0, af_bandwidth=15000.0,
                              squelch_db=-60.0, volume=1.0, block_in=len(x),
                              ref_atan2_approx=True)
    state = demod_wfm.make_state(cfg)
    _, audio = demod_wfm.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel()
    lag, snr, s = _real_best_lag(golden.astype(float), y, range(-30, 31), 8000)
    assert snr > 120.0, f"wfmrx384 approx-parity: snr {snr:.1f} dB (lag {lag})"


def test_wfm_stage_taps_match_reference():
    """Per-stage decomposition of the WFM chain (the NFM r4 pattern —
    wfmrx384_postnco/_postrf/_postdiscri emitted by gen_wfmrx_chain):
    each boundary is pinned tight so the 70 dB end-to-end budget cannot
    silently absorb a single-stage regression. The resampler stage runs on
    the REFERENCE's own post-discriminator stream, isolating the schedule
    from upstream effects."""
    import jax.numpy as jnp

    from sdrangel_tpu.channels.demod_wfm import WFMConfig
    from sdrangel_tpu.dsp import fftfilt as ff, nco as nco_mod
    from sdrangel_tpu.dsp import phasediscri, resampler

    flat, _ = load("wfmrx384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    gn, _ = load("wfmrx384_postnco")
    gn = (gn[0::2] + 1j * gn[1::2])
    gr, _ = load("wfmrx384_postrf")
    gr = (gr[0::2] + 1j * gr[1::2])
    gd, _ = load("wfmrx384_postdiscri")
    ga, _ = load("wfmrx384_audio")
    cfg = WFMConfig(channel_rate=384000.0, input_offset=0.0,
                    rf_bandwidth=180000.0, af_bandwidth=15000.0,
                    block_in=len(x))

    def snr_c(g, o, skip=8192):
        n = min(len(g), len(o))
        g, o = g[skip:n], o[skip:n]
        sc = np.vdot(o, g) / max(np.vdot(o, o).real, 1e-30)
        e = g - sc * o
        return 10 * np.log10(max(np.vdot(sc * o, sc * o).real, 1e-30)
                             / max(np.vdot(e, e).real, 1e-30))

    # stage 1: NCO mix (bit-parity class; measured 142.9)
    inc = nco_mod.freq_to_increment(0.0, 384000.0)
    _, xm = nco_mod.mix_block(nco_mod.make_nco(), jnp.asarray(x), jnp.asarray(inc))
    xm = np.asarray(jnp.stack([jnp.real(xm), jnp.imag(xm)]))
    assert snr_c(gn, (xm[0] + 1j * xm[1]) * 32768.0) > 135.0

    # stage 2: OLA rf filter on the reference's own post-NCO (measured 133.2)
    _, rf = ff.run_filt(ff.make_state(cfg.fft_len),
                        jnp.asarray(gn.astype(np.complex64)),
                        jnp.asarray(cfg.rf_filter))
    rf = np.asarray(jnp.stack([jnp.real(rf), jnp.imag(rf)]))
    assert snr_c(gr, rf[0] + 1j * rf[1]) > 125.0

    # stage 3: discriminator on the reference's own post-rf — exact atan2
    # sits at the approximation floor (24.2); the parity mode matches at
    # 137 dB. Skip 16384: the reference's squelch is closed (demod forced
    # 0, prevArg frozen) for the first ~9k samples of this golden.
    for approx, bound in ((False, 20.0), (True, 130.0)):
        _, dem, _ = phasediscri.discriminator_delta(
            phasediscri.make_state(), jnp.asarray(gr.astype(np.complex64)),
            384000.0 / 180000.0, approx=approx)
        lag, snr, _ = _real_best_lag(gd.astype(float), np.asarray(dem),
                                     range(-3, 4), 16384)
        assert snr > bound, f"discri approx={approx}: {snr:.1f} dB"

    # stage 4: audio resampler on the reference's own post-discriminator
    # (the r5 schedule fix; measured 135.8)
    rplan = cfg.resampler_plan
    blk = (len(gd) // rplan.block_in) * rplan.block_in
    _, au = resampler.resample_block(
        resampler.init_state(rplan), jnp.asarray(gd[:blk].astype(np.complex64)),
        rplan)
    au = np.asarray(jnp.real(au)).ravel()
    lag, snr, s = _real_best_lag(ga.astype(float), au, range(-5, 6), 8000)
    assert snr > 125.0, f"wfm resampler stage: {snr:.1f} dB (lag {lag})"
    assert abs(s - 3276.8) < 1.0, f"scale {s} (audio_f = ci * 3276.8)"


def test_dsd_front_end_matches_reference():
    """DSD front end vs the reference's own compiled feed composition
    (dsddemod.cpp:127-210 up to the DSDcc hand-off boundary, emitted by
    gen_dsd_chain): NCO -> Interpolator(16, rate, rfBW/2.2) ->
    phaseDiscriminator x demodGain (fmScaling 48000/(2 fmDev)) -> 16-tap
    magsq moving-average squelch with the 480-sample delay line. Both the
    discriminator stream and the final gated `sample` stream match at
    129.4/129.5 dB with scale EXACTLY 1.0 — the r5 reference-exact
    resampler schedule covers the 2:1 path; before r5 this chain had no
    reference-compiled golden (oracle/loopback tests only)."""
    import jax.numpy as jnp

    from sdrangel_tpu.channels import demod_dsd
    from sdrangel_tpu.dsp import movingavg, nco as nco_mod
    from sdrangel_tpu.dsp import phasediscri, resampler, squelch as sq

    flat, _ = load("dsd96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    gd, _ = load("dsd96_postdiscri")
    gs, _ = load("dsd96_sample")
    cfg = demod_dsd.DSDConfig(channel_rate=96000.0, input_offset=6000.0,
                              rf_bandwidth=12500.0, fm_deviation=5400.0,
                              squelch_db=-40.0)
    plan = cfg.resampler_plan
    inc = nco_mod.freq_to_increment(-6000.0, 96000.0)
    st = (nco_mod.make_nco(), resampler.init_state(plan),
          phasediscri.make_state(), movingavg.make_state(16),
          sq.make_state(480))
    dem_all, gat_all = [], []
    for b in range(len(x) // plan.block_in):
        xb = jnp.asarray(x[b * plan.block_in:(b + 1) * plan.block_in])
        n0, xm = nco_mod.mix_block(st[0], xb, jnp.asarray(inc))
        r0, ci = resampler.resample_block(st[1], xm, plan)
        d0, dem, magsq = phasediscri.discriminator_delta(
            st[2], ci, cfg.fm_scaling)
        m0, avg = movingavg.moving_average(st[3], magsq)
        s0, gated, _ = sq.gate_block(st[4], dem, avg >= 1e-4, 480)
        st = (n0, r0, d0, m0, s0)
        dem_all.append(np.asarray(dem))
        gat_all.append(np.asarray(gated))
    dem_np = np.concatenate(dem_all)
    gat_np = np.concatenate(gat_all)
    lag, snr, s = _real_best_lag(gd.astype(float), dem_np, range(-3, 4), 8000)
    assert snr > 120.0, f"dsd post-discri: {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-3, f"scale {s}"
    lag, snr, s = _real_best_lag(gs.astype(float), gat_np, range(-3, 4), 8000)
    assert snr > 120.0, f"dsd gated sample: {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-3, f"scale {s}"


def test_bfm_chain_matches_reference():
    """BFM stereo chain (bfmdemod.cpp:118-250 feed with the StereoPhaseLock
    pilot, compiled via phaselock.cpp/filterrc.cpp): the MONO path (L+R,
    where the stereo difference cancels) matches at 137 dB. The stereo
    DIFFERENCE path diverges BY DESIGN: the reference mixes with the PLL's
    sin(2x) harmonic and achieves only ~10-13 dB separation on a clean
    standard-phase multiplex (pinned below as its behavior record), while
    the analytic-pilot downmix here measures >40 dB.

    Composition note baked into the golden: the multiplex must follow the
    broadcast phase convention (subcarrier sin(2θ) with pilot sin(θ)) — a
    cos/cos multiplex is orthogonal to the reference PLL's harmonic and
    silently nulls its stereo (found while building this golden)."""
    import math

    from sdrangel_tpu.channels import demod_bfm
    import jax.numpy as jnp

    flat, _ = load("bfm384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    blk = (len(x) // math.lcm(768, 512)) * math.lcm(768, 512)
    x = x[:blk]
    g, _ = load("bfm384_audio_lr")
    gl, gr = g[0::2].astype(float), g[1::2].astype(float)

    cfg = demod_bfm.BFMConfig(channel_rate=384000.0, input_offset=0.0,
                              rf_bandwidth=180000.0, af_bandwidth=15000.0,
                              audio_stereo=True, block_in=blk)
    state = demod_bfm.make_state(cfg)
    _, out = demod_bfm.process(state, jnp.asarray(x), cfg)
    y = np.asarray(out.audio)
    yl = y[..., 0].ravel().astype(float)
    yr = y[..., 1].ravel().astype(float)

    lag, snr, s = _real_best_lag(gl + gr, yl + yr, range(-40, 41), 12000)
    assert snr > 125.0, f"bfm mono sum: {snr:.1f} dB"  # measured 137.5

    def separation_db(left, right):
        n = 16384
        w = np.hanning(n)
        fr = np.fft.rfftfreq(n, 1 / 48000)
        sl = np.abs(np.fft.rfft(left[12000:12000 + n] * w))
        p1 = sl[np.abs(fr - 1000) < 10].max()
        p2 = sl[np.abs(fr - 2500) < 10].max()
        return 20 * np.log10(p1 / p2)

    # reference behavior record: its harmonic-mix separation is ~+13/-10 dB
    assert 5.0 < separation_db(gl, gr) < 25.0
    assert -25.0 < separation_db(gr, gl) < -3.0
    # ours: the analytic-pilot downmix separates >35 dB on the same signal
    assert separation_db(yl, yr) > 35.0
    assert separation_db(yr, yl) < -30.0


def test_bfm_golden_pilot_locked():
    """Validity check of the golden composition itself: the reference
    StereoPhaseLock's 2f output is a clean 38 kHz unit tone."""
    p, _ = load("bfm384_pilot")
    mid = p[100000:165536].astype(float)
    assert abs(mid.std() - 0.707) < 0.02  # unit sin amplitude
    n = len(mid)
    spec = np.abs(np.fft.rfft(mid * np.hanning(n)))
    frq = np.fft.rfftfreq(n, 1 / 384000)
    assert abs(frq[int(np.argmax(spec))] - 38000.0) < 50.0


def test_am_sync_chain_matches_reference():
    """Synchronous-AM branch (amdemod.cpp:191-251, compiled with
    phaselockcomplex.cpp): PLL carrier lock -> the j*ci*conj(pll)
    quadrature mix -> 0..rfBw runSSB with dc=false -> MagAGC(12000, R=0.1)
    -> (re+im)*4. 25.7 dB in the shipping mode with |scale| EXACTLY
    audioRate/24 — an EXACT-MODE BEHAVIOR RECORD, not a tolerance: the r4
    "biquad topology" attribution was wrong (the parity biquad alone moved
    nothing). The real residual, demonstrated stage by stage in r5
    (test_am_sync_parity_modes / test_am_sync_residual_is_ref_nco_quant):
    the reference's NCO tunes on an fs/4096 grid (nco.cpp:48-52), so its
    "5000 Hz" offset mixes 4992.1875 Hz and its PLL tracks a +7.8125 Hz
    carrier while ours holds true DC lock — the constant relative carrier
    rotation caps the re+im projection at exactly this level."""
    from sdrangel_tpu.channels import demod_am
    import jax.numpy as jnp

    flat, _ = load("amsync96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load("amsync96_audio")
    cfg = demod_am.AMConfig(channel_rate=96000.0, input_offset=5000.0,
                            rf_bandwidth=5000.0, squelch_db=-40.0,
                            volume=1.0, bandpass_enable=False, sync_am=True,
                            sync_usb=True, block_in=len(x))
    state = demod_am.make_state(cfg)
    _, audio = demod_am.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel()
    lag, snr, s = _real_best_lag(golden.astype(float), y,
                                 range(300, 500, 2), 20000)
    assert snr > 20.0, f"amsync96: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) / 2000.0 - 1.0) < 0.02, f"scale {s} (expect ±rate/24)"


def test_am_sync_residual_is_ref_nco_quant():
    """The demonstrated root cause of the exact-mode AM-sync residual: the
    reference PLL carrier (amsync96_pllcarrier tap, emitted by its own
    compiled PhaseLockComplex) rotates at +7.8125 Hz — exactly the
    5000 Hz-offset truncation error of the fs/4096 NCO grid
    (trunc(5000·4096/96000) = 213 steps = 4992.1875 Hz) — although the
    golden's carrier sits at offset+0. Our default NCO (2^32 wheel)
    leaves <0.01 Hz."""
    gc, _ = load("amsync96_pllcarrier")
    gcar = gc[0::2] + 1j * gc[1::2]
    d = np.angle(gcar[20001:32000] * np.conj(gcar[20000:31999]))
    freq = float(d.mean()) * 48000.0 / (2.0 * np.pi)
    assert abs(freq - 7.8125) < 0.5, f"golden carrier at {freq:.3f} Hz"
    from sdrangel_tpu.dsp import nco as nco_mod

    inc = nco_mod.freq_to_increment_ref_quant(-5000.0, 96000.0)
    achieved = (float(np.int64(np.uint32(inc).astype(np.int64)
                               - (1 << 32))) / (1 << 32)) * 96000.0
    assert abs(achieved - (-4992.1875)) < 1e-6


def test_am_sync_parity_modes():
    """Demonstrated attribution (VERDICT r4 next #3): the AM-sync residual
    decomposes into three reference quirks, each reproduced as a test-only
    parity mode, composing 25.7 -> 45.4 dB:
      1. ref_nco_quant — the fs/4096 NCO tuning grid (the dominant cause:
         the PLL then tracks the same +7.8125 Hz carrier as the golden);
      2. ref_pll_parity — the PhaseLockComplex biquad (wn .05/zeta .707/
         K 1000) behind its 101-tap 200 Hz prefilter;
      3. sync_frame_offset=148 — the reference feeds its SSB OLA filter
         only from the squelch-open instant (sample 2412 in this golden;
         first nonzero of amsync96_postmix), and the brickwall sideband
         IR exceeds flen/2 so the OLA is framing-sensitive:
         (512 - 2412 % 512) % 512 = 148 (on top of the structural
         one-sample stream aligner, r5 — measured 46.8 dB).
    The remainder is the reference's squelch-gated PLL/AGC warmup history
    (it processes nothing before sample 2412; we stream from 0)."""
    from sdrangel_tpu.channels import demod_am
    import jax.numpy as jnp

    flat, _ = load("amsync96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    golden, _ = load("amsync96_audio")
    cfg = demod_am.AMConfig(channel_rate=96000.0, input_offset=5000.0,
                            rf_bandwidth=5000.0, squelch_db=-40.0,
                            volume=1.0, bandpass_enable=False, sync_am=True,
                            sync_usb=True, block_in=len(x),
                            ref_nco_quant=True, ref_pll_parity=True,
                            sync_frame_offset=148)
    state = demod_am.make_state(cfg)
    _, audio = demod_am.process(state, jnp.asarray(x), cfg)
    y = np.asarray(audio).ravel()
    lag, snr, s = _real_best_lag(golden.astype(float), y,
                                 range(-200, 200), 20000)
    assert snr > 42.0, f"amsync96 full parity: snr {snr:.1f} dB (lag {lag})"
    assert abs(s - 2000.0) < 1.0, f"scale {s} (audioRate/24, positive lock)"


def test_am_sync_tail_matches_reference_exactly():
    """The sync TAIL (runSSB + MagAGC + (re+im)·4) on the reference's own
    post-mix stream, framing-aligned: 127.8 dB at scale exactly 1.0 —
    pinning that every stage downstream of the PLL mix is
    reference-exact, so the chain residual lives entirely in the
    carrier/NCO behaviors recorded above."""
    from sdrangel_tpu.channels import demod_am
    from sdrangel_tpu.dsp import agc as agc_mod, fftfilt as ff
    import jax.numpy as jnp

    gm, _ = load("amsync96_postmix")
    gmix = (gm[0::2] + 1j * gm[1::2])
    gd, _ = load("amsync96_demod")
    OFF = 148
    cfg = demod_am.AMConfig(channel_rate=96000.0, input_offset=5000.0,
                            rf_bandwidth=5000.0, sync_am=True, sync_usb=True,
                            bandpass_enable=False, block_in=len(gmix))
    fed = np.concatenate([np.zeros(OFF), gmix])
    fed = fed[: len(fed) // 512 * 512].astype(np.complex64)
    _, filt = ff.run_ssb(ff.make_state(cfg.sync_fft_len), jnp.asarray(fed),
                         cfg.sync_filter, usb=True, get_dc=False)
    _, lev, _, _ = agc_mod.mag_agc(agc_mod.make_state(cfg.sync_agc_config),
                                   filt, cfg.sync_agc_config)
    dem = np.asarray((jnp.real(lev) + jnp.imag(lev)) * 4.0)
    lag, snr, s = _real_best_lag(gd.astype(float), dem,
                                 range(-OFF - 520, -OFF + 530), 20000)
    assert snr > 120.0, f"amsync tail: {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-5, f"scale {s}"

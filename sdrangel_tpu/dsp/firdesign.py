"""FIR designers (host-side) and the block FIR applier.

Reference designers: sdrbase/dsp/bandpass.h:18-130 (windowed-sinc bandpass as
lowpass(f2) convolved spectrally with highpass(f1) — implemented as
lowpass*highpass tap product sum form), sdrbase/dsp/lowpass.h, highpass.h,
and the generic windowed-sinc WFIR (wfir.{h,cpp}:26-78, Kaiser & co).

Designs are NumPy at configure time; application is a stride-1 valid conv
with a carried (ntaps-1) tail, sharing the conv machinery of the decimators.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .precision import PRECISION


def _hamming(n: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc lowpass; cutoff normalized to sample rate (0..0.5).
    Matches Lowpass<T>::create semantics (Hamming window, unity DC gain)."""
    assert ntaps % 2 == 1, "odd tap count keeps the filter symmetric"
    m = ntaps // 2
    k = np.arange(ntaps, dtype=np.float64) - m
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.where(k == 0, 2.0 * cutoff, np.sin(2.0 * np.pi * cutoff * k) / (np.pi * k))
    h *= _hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def highpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Spectral inversion of the lowpass (Highpass<T>::create semantics)."""
    h = -lowpass(ntaps, cutoff).astype(np.float64)
    h[ntaps // 2] += 1.0
    return h.astype(np.float32)


def bandpass(ntaps: int, f_lo: float, f_hi: float) -> np.ndarray:
    """Bandpass [f_lo, f_hi] as lowpass(f_hi) ∗ highpass(f_lo) cascade
    collapsed into one tap set (Bandpass<T>::create, bandpass.h:18-130
    convolves the two tap sets)."""
    h_lp = lowpass(ntaps, f_hi).astype(np.float64)
    h_hp = highpass(ntaps, f_lo).astype(np.float64)
    h = np.convolve(h_lp, h_hp)
    # keep the central ntaps to preserve the configured length
    start = (len(h) - ntaps) // 2
    h = h[start : start + ntaps]
    # normalize passband gain at the geometric centre frequency
    fc = np.sqrt(f_lo * f_hi)
    w = 2.0 * np.pi * fc
    n = np.arange(ntaps) - ntaps // 2
    gain = np.abs(np.sum(h * np.exp(-1j * w * n)))
    return (h / gain).astype(np.float32)


def nfm_mod_bandpass(ntaps: int, fs: float, f_lo: float, f_hi: float) -> np.ndarray:
    """The EXACT reference Bandpass<Real>::create design (bandpass.h:15-76),
    including its normalization quirk: the taps are divided by the DC tap
    sum, which for a bandpass is nearly zero — leaving a large passband gain
    (~393 for 301 taps, 300..3000 Hz at 48 kHz). The reference NFM modulator
    compensates with an experimentally-established /378 in its phase step
    (nfmmod.cpp:177: "378 = 302 * 1.25"); reproducing the pair exactly is
    what makes fmDeviation settings migrate 1:1 (effective deviation is
    ~0.52x the setting in BOTH implementations).

    Returns the full symmetric ntaps impulse response, UNSCALED — callers
    fold in the modulator's pi/378 against their phase convention."""
    assert ntaps % 2 == 1
    wcl = 2.0 * np.pi * f_lo / fs
    wch = 2.0 * np.pi * f_hi / fs
    n2 = ntaps // 2 + 1
    i = np.arange(n2, dtype=np.float64)
    d = i - (ntaps - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        lp = np.sin(d * wch) / (d * np.pi)
        hp = -np.sin(d * wcl) / (d * np.pi)
    lp[n2 - 1] = wch / np.pi
    hp[n2 - 1] = -(wcl / np.pi)
    hp[n2 - 1] += 1.0
    win = 0.54 + 0.46 * np.cos(2.0 * np.pi * d / ntaps)
    taps = -(lp * win + hp * win)
    taps[n2 - 1] += 1.0
    s = taps[:-1].sum() * 2.0 + taps[-1]
    taps = taps / s  # the reference's near-zero-DC-sum normalization
    full = np.concatenate([taps[:-1], taps[::-1]])
    return full.astype(np.float32)


def bandpass_ring_kernel(ntaps: int, fs: float, f_lo: float,
                         f_hi: float) -> np.ndarray:
    """The FIR the reference's Bandpass<T>::filter ACTUALLY applies —
    which is NOT its designed symmetric m_taps (r5 finding, +47 dB on the
    am96 golden). bandpass.h:78-121 walks the ring with `b` starting at
    ptr-1, so tap t0 multiplies the newest TWO samples (ages 0 and 1),
    t1..t[c-1] hit ages 2..c (new side) and ntaps-1..c+2 (old side), and
    the centre tap lands at age c+1 — a one-sample-asymmetric kernel with
    a slightly non-linear phase. Verified against a verbatim ring
    simulation and pinned by the am96 chain golden (124.4 dB vs 77.2 for
    the symmetric design on the reference's own pre-bandpass stream).
    Lowpass<T>/Highpass<T> share the same walk, so every reference
    `.filter()` audio path has this response.

    Returns the kernel ORIENTED FOR fir_apply (tap k applies at delay
    ntaps-1-k), UNSCALED like nfm_mod_bandpass — callers fold their own
    /301-style pairing."""
    full = nfm_mod_bandpass(ntaps, fs, f_lo, f_hi)
    n2 = ntaps // 2 + 1
    t = full[:n2].astype(np.float64)
    c = np.zeros(ntaps, np.float64)  # index = age (delay in samples)
    c[0] = t[0]
    c[1] = t[0]
    c[2:n2] = t[1:n2 - 1]
    c[n2] = t[n2 - 1]
    ages = np.arange(n2 + 1, ntaps)
    c[ages] = t[ntaps - ages]
    return c[::-1].astype(np.float32)


class FirState(NamedTuple):
    tail: jnp.ndarray  # (..., ntaps-1)


def make_state(ntaps: int, batch_shape=(), dtype=jnp.float32) -> FirState:
    return FirState(jnp.zeros((*batch_shape, ntaps - 1), dtype=dtype))


def fir_apply(
    state: FirState, x: jnp.ndarray, taps: jnp.ndarray
) -> tuple[FirState, jnp.ndarray]:
    """Stride-1 FIR over a real or complex block with carried tail.

    Long filters (≥64 taps) run as FFT fast convolution. This was a
    compile workaround on an earlier accelerator, whose direct conv
    compiled for minutes at long kernels; its A/B against the direct conv
    on the H100 is queued (ROADMAP Design 3).
    """
    ext = jnp.concatenate([state.tail, x], axis=-1)
    is_complex = jnp.iscomplexobj(x)
    l_taps = taps.shape[-1]
    if l_taps >= 64:
        n_fft = 1 << int(np.ceil(np.log2(ext.shape[-1] + l_taps - 1)))
        # valid correlation == linear convolution with reversed taps,
        # sliced at the L-1 offset
        if not (is_complex or jnp.iscomplexobj(taps)):
            # real signal x real taps: half-spectrum FFTs — half the
            # memory traffic of full complex FFTs
            tf = jnp.fft.rfft(taps[::-1].astype(jnp.float32), n_fft)
            xf = jnp.fft.rfft(ext.astype(jnp.float32), n_fft, axis=-1)
            full = jnp.fft.irfft(xf * tf, n_fft, axis=-1)
            y = full[..., l_taps - 1 : l_taps - 1 + x.shape[-1]]
            return FirState(ext[..., x.shape[-1] :]), y.astype(jnp.float32)
        tf = jnp.fft.fft(taps[::-1].astype(jnp.complex64), n_fft)
        xf = jnp.fft.fft(ext.astype(jnp.complex64), n_fft, axis=-1)
        full = jnp.fft.ifft(xf * tf, axis=-1)
        y = full[..., l_taps - 1 : l_taps - 1 + x.shape[-1]]
        y = y.astype(jnp.complex64)
        return FirState(ext[..., x.shape[-1] :]), y
    if is_complex:
        lanes = jnp.stack([jnp.real(ext), jnp.imag(ext)], axis=0)
    else:
        lanes = ext[None]
    batch_shape = lanes.shape[:-1]
    lhs = lanes.reshape(-1, 1, lanes.shape[-1])
    rhs = taps.astype(jnp.float32).reshape(1, 1, -1)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=PRECISION,
    )
    out = out.reshape(*batch_shape, out.shape[-1])
    if is_complex:
        y = (out[0] + 1j * out[1]).astype(jnp.complex64)
    else:
        y = out[0] if out.shape[0] == 1 else out
        y = y.astype(jnp.float32)
    return FirState(ext[..., x.shape[-1] :]), y


def kaiser_lowpass(ntaps: int, cutoff: float, atten_db: float = 60.0) -> np.ndarray:
    """Kaiser-window lowpass (WFIR::BasicFIR LPF + wKaiser,
    sdrbase/dsp/wfir.cpp:26-78 — the reference's generic windowed designer
    offers Kaiser beside Hamming/Blackman/etc). cutoff in cycles/sample.
    β from the standard attenuation formula (Kaiser's empirical fit)."""
    if atten_db > 50.0:
        beta = 0.1102 * (atten_db - 8.7)
    elif atten_db >= 21.0:
        beta = 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    else:
        beta = 0.0
    n = np.arange(ntaps, dtype=np.float64)
    m = (ntaps - 1) / 2.0
    k = n - m
    with np.errstate(invalid="ignore"):
        h = np.where(k == 0, 2.0 * cutoff, np.sin(2.0 * np.pi * cutoff * k) / (np.pi * k))
    w = np.kaiser(ntaps, beta)
    h = h * w
    return (h / h.sum()).astype(np.float32)

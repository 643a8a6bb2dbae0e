"""FFT fast-convolution channel filters (overlap-add), batched.

Reference: sdrbase/dsp/fftfilt.{h,cpp} (from fldigi) — accumulates flen/2
samples, FFTs [chunk | zeros], multiplies by the frequency-domain filter,
IFFTs, emits first half + saved overlap, saves second half
(runFilt fftfilt.cpp:261-282; runSSB :285-326 zeroes the rejected sideband;
runDSB :328; runAsym :361). Filter builders: windowed-sinc bandpass
(create_filter :108), DSB lowpass (:149), asymmetric/vestigial (:193),
RRC (:223).

Design: a block of T samples is reshaped to (T/hop, hop) frames and the
whole overlap-add pipeline runs as batched jnp.fft over the frame axis —
embarrassingly parallel across frames and channels; the sequential overlap
add between consecutive frames is a shift of the frame axis, and only one
hop of state crosses block boundaries.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Filter builders (host-side, NumPy — design happens at configure time).
# ---------------------------------------------------------------------------

def _fsinc(fc: float, i: int | np.ndarray, length: int) -> np.ndarray:
    """Shifted sinc as in fftfilt::fsinc (fftfilt.cpp:87-94)."""
    n = np.asarray(i, dtype=np.float64)
    m = length / 2.0
    arg = n - m
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(
            arg == 0.0,
            2.0 * fc,
            np.sin(2.0 * np.pi * fc * arg) / (np.pi * arg),
        )
    return out


def _blackman(i: np.ndarray, length: int) -> np.ndarray:
    n = np.asarray(i, dtype=np.float64)
    return (
        0.42
        - 0.50 * np.cos(2.0 * np.pi * n / length)
        + 0.08 * np.cos(4.0 * np.pi * n / length)
    )


def _normalize_peak(h_freq: np.ndarray, half_only: bool = True) -> np.ndarray:
    scale = np.abs(h_freq[: len(h_freq) // 2] if half_only else h_freq).max()
    return h_freq if scale == 0 else h_freq / scale


def create_filter(f1: float, f2: float, flen: int = 1024) -> np.ndarray:
    """Bandpass [f1, f2] (freqs normalized to the sample rate) as a length
    `flen` frequency response — semantics of fftfilt::create_filter."""
    flen2 = flen // 2
    i = np.arange(flen2)
    h = np.zeros(flen, dtype=np.complex128)
    ht = np.zeros(flen2, dtype=np.float64)
    if f2 != 0:
        ht += _fsinc(f2, i, flen2)
    if f1 != 0:
        ht -= _fsinc(f1, i, flen2)
    if f1 != 0 and f2 < f1:
        ht[flen2 // 2] += 1.0  # highpass = delta - lowpass
    ht *= _blackman(i, flen2)
    h[:flen2] = ht
    H = np.fft.fft(h)
    return _normalize_peak(H).astype(np.complex64)


def create_dsb_filter(f2: float, flen: int = 1024) -> np.ndarray:
    """Lowpass at f2 for DSB (fftfilt::create_dsb_filter)."""
    flen2 = flen // 2
    i = np.arange(flen2)
    ht = _fsinc(f2, i, flen2) * _blackman(i, flen2)
    h = np.zeros(flen, dtype=np.complex128)
    h[:flen2] = ht
    H = np.fft.fft(h)
    return _normalize_peak(H).astype(np.complex64)


def create_asym_filter(fopp: float, fin: float, flen: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """In-band + opposite-band pair for vestigial sideband (create_asym_filter)."""
    return create_dsb_filter(fin, flen), create_dsb_filter(fopp, flen)


def create_rrc_filter(fb: float, alpha: float, flen: int = 1024) -> np.ndarray:
    """Root-raised-cosine constructed directly in the frequency domain
    (fftfilt::create_rrc_filter / frrc)."""
    H = np.zeros(flen, dtype=np.float64)
    for i in range(flen):
        f = i / flen if i < flen // 2 else (i - flen) / flen
        a = abs(f)
        lo = fb * (1.0 - alpha) / 2.0
        hi = fb * (1.0 + alpha) / 2.0
        if a <= lo:
            H[i] = 1.0
        elif a < hi:
            H[i] = np.sqrt(0.5 * (1.0 + np.cos(np.pi / (fb * alpha) * (a - lo))))
    H = _normalize_peak(H, half_only=False)
    return H.astype(np.complex64)


# ---------------------------------------------------------------------------
# Runtime: batched overlap-add
# ---------------------------------------------------------------------------

class FftFiltState(NamedTuple):
    overlap: jnp.ndarray  # (..., flen/2) complex64 carried overlap tail


def make_state(flen: int = 1024, batch_shape=()) -> FftFiltState:
    return FftFiltState(jnp.zeros((*batch_shape, flen // 2), dtype=jnp.complex64))


def _frame(x: jnp.ndarray, hop: int) -> jnp.ndarray:
    t = x.shape[-1]
    assert t % hop == 0, f"block length {t} must be a multiple of flen/2={hop}"
    return x.reshape(*x.shape[:-1], t // hop, hop)


def _overlap_add(y_frames: jnp.ndarray, overlap_in: jnp.ndarray, hop: int):
    """y_frames: (..., F, flen) time-domain filtered frames.
    Emits (..., F*hop) = first half of each frame + previous frame's second
    half; returns the last frame's tail as the new carried overlap."""
    first = y_frames[..., :hop]
    second = y_frames[..., hop:]
    prev = jnp.concatenate(
        [overlap_in[..., None, :], second[..., :-1, :]], axis=-2
    )
    out = first + prev
    new_overlap = second[..., -1, :]
    return out.reshape(*out.shape[:-2], -1), new_overlap


def run_filt(
    state: FftFiltState, x: jnp.ndarray, h_freq: jnp.ndarray
) -> tuple[FftFiltState, jnp.ndarray]:
    """Overlap-add filter (fftfilt::runFilt semantics), batched.

    x: (..., T) complex64, T a multiple of flen/2. h_freq: (flen,) complex64.
    Returns (state', y) with y: (..., T).
    """
    flen = h_freq.shape[-1]
    hop = flen // 2
    frames = _frame(x, hop)  # (..., F, hop)
    spec = jnp.fft.fft(frames, n=flen, axis=-1) * h_freq
    yf = jnp.fft.ifft(spec, axis=-1)
    out, new_ovl = _overlap_add(yf, state.overlap, hop)
    return FftFiltState(new_ovl.astype(jnp.complex64)), out.astype(jnp.complex64)


@functools.lru_cache(maxsize=32)
def _ssb_multiplier(h_key: tuple, usb: bool, get_dc: bool) -> np.ndarray:
    """Combined per-bin multiplier for runSSB (fftfilt.cpp:285-326):
    kept sideband bins 1..flen2-1 (usb) / flen2+1..flen-1 (lsb) get the
    filter; the other sideband is zeroed; bin flen2 (Nyquist) passes
    unfiltered in both branches; DC is filtered or zeroed per getDC."""
    h = np.asarray(h_key, dtype=np.complex64)
    flen = len(h)
    hop = flen // 2
    mult = np.zeros(flen, dtype=np.complex64)
    if usb:
        mult[1:hop] = h[1:hop]
    else:
        mult[hop + 1 :] = h[hop + 1 :]
    mult[hop] = 1.0
    mult[0] = h[0] if get_dc else 0.0
    return mult


def run_ssb(
    state: FftFiltState,
    x: jnp.ndarray,
    h_freq: jnp.ndarray | np.ndarray,
    usb: bool,
    get_dc: bool = False,
) -> tuple[FftFiltState, jnp.ndarray]:
    """SSB filter (fftfilt::runSSB): multiply the kept sideband by the
    filter, zero the rejected sideband (and optionally DC)."""
    h_np = np.asarray(h_freq)
    mult = _ssb_multiplier(tuple(h_np.tolist()), usb, get_dc)
    return run_filt(state, x, jnp.asarray(mult))


def run_dsb(
    state: FftFiltState, x: jnp.ndarray, h_freq: jnp.ndarray
) -> tuple[FftFiltState, jnp.ndarray]:
    """DSB: both sidebands filtered (fftfilt::runDSB)."""
    return run_filt(state, x, h_freq)


def run_asym(
    state: FftFiltState,
    x: jnp.ndarray,
    h_in: jnp.ndarray,
    h_opp: jnp.ndarray,
    usb: bool,
) -> tuple[FftFiltState, jnp.ndarray]:
    """Asymmetric / vestigial filtering (fftfilt::runAsym): in-band sideband
    gets h_in, opposite sideband gets h_opp."""
    flen = h_in.shape[-1]
    hop = flen // 2
    h = np.zeros(flen, dtype=np.complex64)
    h_in_np = np.asarray(h_in)
    h_opp_np = np.asarray(h_opp)
    if usb:
        h[:hop] = h_in_np[:hop]
        h[hop:] = h_opp_np[hop:]
    else:
        h[:hop] = h_opp_np[:hop]
        h[hop:] = h_in_np[hop:]
    # runAsym's loops cover bins 1..flen2-1 of each half, so the Nyquist bin
    # passes unfiltered (fftfilt.cpp:344-361, same quirk as runSSB); DC always
    # takes the in-band filter (fftfilt.cpp:352 regardless of usb).
    h[hop] = 1.0
    h[0] = h_in_np[0]
    return run_filt(state, x, jnp.asarray(h))

"""Sample-type policy and scale constants.

The reference (sdrbase/dsp/dsptypes.h:25-97) uses fixed-point I/Q samples
(qint16, or qint24 when RX_SAMPLE_24BIT) with scale constants
SDR_RX_SCALEF = 32768.0 (or 8388608.0 in 24-bit mode).

Policy: ingestion accepts int8/int16/int24/float raw streams and
normalizes to float32 in [-1, 1); all DSP compute is float32/complex64;
audio egress is int16. A fixed-point "parity
mode" is provided by the integer NCO LUT and by reproducing the reference
decimation scale policy as pure gains.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Reference scale constants (dsptypes.h:80-97).
SDR_RX_SAMP_SZ_16 = 16
SDR_RX_SAMP_SZ_24 = 24
SCALE_16 = 32768.0  # SDR_RX_SCALEF in 16-bit mode
SCALE_24 = 8388608.0  # SDR_RX_SCALEF in 24-bit mode

# dtype policy
REAL_DTYPE = jnp.float32
COMPLEX_DTYPE = jnp.complex64
AUDIO_DTYPE = jnp.int16


#: Raw ingestion formats: name -> (dtype, zero offset, scale divisor).
#: Mirrors the reference's per-ADC Decimators instantiations (SURVEY §8.1):
#: u8 = RTL-SDR (DecimatorsU<..., quint8, 8, 127>), i8 = HackRF, i12 =
#: Airspy/PlutoSDR (12-bit in int16), i16 = file/test source, i24 = 24-bit
#: DSP mode (int32 container).
INPUT_FORMATS = {
    "i16": (jnp.int16, 0.0, 32768.0),
    "u8": (jnp.uint8, 127.4, 128.0),
    "i8": (jnp.int8, 0.0, 128.0),
    "i12": (jnp.int16, 0.0, 2048.0),
    "i24": (jnp.int32, 0.0, 8388608.0),
}


def iq_raw_to_complex64(raw: jnp.ndarray, fmt: str = "i16") -> jnp.ndarray:
    """Interleaved raw I/Q in any supported ADC format -> complex64 [-1,1).

    raw: (..., T, 2) (or (..., 2*T) interleaved). The offset/scale policy
    replaces the reference's decimation_shifts tables (decimators.h:43-185):
    normalization happens once at ingest, the float cascade needs no
    per-stage shifts.
    """
    dtype, offset, scale = INPUT_FORMATS[fmt]
    if raw.shape[-1] != 2:
        raw = raw.reshape(*raw.shape[:-1], -1, 2)
    f = (raw.astype(jnp.float32) - jnp.float32(offset)) * jnp.float32(1.0 / scale)
    return (f[..., 0] + 1j * f[..., 1]).astype(jnp.complex64)


def iq_int16_to_complex64(raw: jnp.ndarray) -> jnp.ndarray:
    """Interleaved int16 I/Q -> complex64 in [-1, 1).

    raw: (..., 2*T) int16 interleaved or (..., T, 2) int16.
    Returns (..., T) complex64.
    """
    if raw.shape[-1] != 2:
        raw = raw.reshape(*raw.shape[:-1], -1, 2)
    f = raw.astype(jnp.float32) * (1.0 / SCALE_16)
    return jax_lax_complex(f[..., 0], f[..., 1])


def complex64_to_iq_int16(x: jnp.ndarray) -> jnp.ndarray:
    """complex64 in [-1, 1) -> interleaved int16 (..., T, 2)."""
    i = jnp.clip(jnp.real(x) * SCALE_16, -32768, 32767).astype(jnp.int16)
    q = jnp.clip(jnp.imag(x) * SCALE_16, -32768, 32767).astype(jnp.int16)
    return jnp.stack([i, q], axis=-1)


def audio_float_to_int16(x: jnp.ndarray) -> jnp.ndarray:
    """float audio in [-1, 1) -> int16 with saturation (AudioOutput semantics:
    sdrbase/audio/audiooutput.cpp:210-270 saturating mix)."""
    return jnp.clip(x * 32768.0, -32768, 32767).astype(jnp.int16)


def jax_lax_complex(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return (re + 1j * im.astype(jnp.complex64)).astype(jnp.complex64)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of an I/Q stream (shapes must stay static under jit)."""

    sample_rate: float
    center_frequency: float = 0.0
    block_size: int = 1 << 17  # complex samples per processed block

    def __post_init__(self):
        assert self.block_size > 0 and (self.block_size & (self.block_size - 1)) == 0, (
            "block_size must be a power of two for the decimator cascades"
        )


def np_tone(freq: float, fs: float, n: int, phase0: float = 0.0, amp: float = 0.5):
    """Host-side complex tone generator (NumPy oracle helper)."""
    t = np.arange(n, dtype=np.float64)
    ph = phase0 + 2.0 * np.pi * freq / fs * t
    return (amp * np.exp(1j * ph)).astype(np.complex64)

"""Decimator cascade unit tests vs NumPy oracle and analytic tone expectations.

Mirrors the verification intent of the reference bench (sdrbench/mainbench.cpp
testDecimateII/InfII/SupII) but with actual correctness assertions the
reference never had (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.dsp import decimators as dec
from sdrangel_tpu.dsp import hbfilter
from sdrangel_tpu.dsp.types import np_tone


def test_hb_taps_structure():
    for order in hbfilter.HB_COEFFS:
        h = hbfilter.hb_taps(order)
        assert len(h) == order - 1
        centre = (order - 1) // 2
        # half-band structure: even offsets zero except centre tap 0.5
        offs = np.arange(len(h)) - centre
        assert h[centre] == np.float32(0.5)
        assert np.all(h[(offs % 2 == 0) & (offs != 0)] == 0.0)
        # symmetry and ~unity DC gain
        np.testing.assert_allclose(h, h[::-1])
        np.testing.assert_allclose(h.sum(), 1.0, atol=1e-3)


def test_designed_halfband_matches_reference_response():
    """Our Kaiser design and the reference's table are both ~unity-gain
    half-band lowpass filters; compare magnitude responses in the passband."""
    for order in (32, 64):
        h_ref = hbfilter.hb_taps(order).astype(np.float64)
        h_new = hbfilter.design_halfband(order).astype(np.float64)
        w = np.fft.rfftfreq(4096)
        H_ref = np.abs(np.fft.rfft(h_ref, 4096))
        H_new = np.abs(np.fft.rfft(h_new, 4096))
        passband = w < 0.15
        stopband = w > 0.35
        np.testing.assert_allclose(H_ref[passband], 1.0, atol=0.02)
        np.testing.assert_allclose(H_new[passband], 1.0, atol=0.02)
        assert H_ref[stopband].max() < 0.02
        assert H_new[stopband].max() < 0.02


@pytest.mark.parametrize("log2", [1, 2, 3, 6])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_cascade_matches_oracle(log2, fc_pos):
    rng = np.random.default_rng(42)
    t = 4096
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64) * 0.1
    state = dec.init_state(log2)
    state, y = jax.jit(
        dec.decimate_cascade, static_argnames=("log2_decim", "fc_pos")
    )(state, jnp.asarray(x), log2, fc_pos)
    y_oracle = dec.decimate_reference_oracle(x, log2, fc_pos)
    np.testing.assert_allclose(np.asarray(y), y_oracle, atol=2e-5)


def test_cascade_block_continuity():
    """Processing one long block == processing two half blocks with carried
    state (the stateful-stream property, SURVEY.md §7.3 #1)."""
    rng = np.random.default_rng(0)
    t = 8192
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    fn = jax.jit(dec.decimate_cascade, static_argnames=("log2_decim", "fc_pos"))

    state = dec.init_state(3)
    _, y_full = fn(state, jnp.asarray(x), 3, "cen")

    state = dec.init_state(3)
    state, y1 = fn(state, jnp.asarray(x[: t // 2]), 3, "cen")
    _, y2 = fn(state, jnp.asarray(x[t // 2 :]), 3, "cen")
    y_split = jnp.concatenate([y1, y2])
    np.testing.assert_allclose(np.asarray(y_full), np.asarray(y_split), atol=1e-6)


@pytest.mark.parametrize("log2,fc_pos", [(2, "cen"), (2, "inf"), (2, "sup"), (4, "inf"), (4, "sup")])
def test_tone_lands_at_expected_frequency(log2, fc_pos):
    """A tone at the wanted-band centre (devicesamplesource.cpp:84-110) must
    come out at DC; a tone in the rejected region must be attenuated."""
    fs = 1.0
    if fc_pos == "cen":
        f_want = 0.0
    else:
        shift = 1.0 / (1 << (log2 + 1)) if log2 < 3 else 1.0 / (1 << log2)
        f_want = -shift if fc_pos == "inf" else shift
    t = 1 << 14
    x = np_tone(f_want + 0.001 / (1 << log2), fs, t)  # slightly off DC to avoid transients hiding
    state = dec.init_state(log2)
    _, y = jax.jit(dec.decimate_cascade, static_argnames=("log2_decim", "fc_pos"))(
        state, jnp.asarray(x), log2, fc_pos
    )
    y = np.asarray(y)[64:]  # drop filter transient
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    peak_bin = np.argmax(spec)
    peak_freq = np.fft.fftfreq(len(y))[peak_bin]  # in units of decimated rate
    assert abs(peak_freq - 0.001) < 0.002, (peak_freq, fc_pos, log2)
    # amplitude preserved within the passband (unity gain)
    np.testing.assert_allclose(np.abs(y).mean(), 0.5, rtol=0.05)


def test_out_of_band_rejection():
    """Aliasing rejection: a tone near fs/2 of the output rate must be heavily
    attenuated after one stage (stopband of the order-64 half-band)."""
    fs = 1.0
    t = 1 << 14
    x = np_tone(0.4, fs, t)  # in the stopband of the ÷2 stage (cutoff 0.25)
    state = dec.init_state(1)
    _, y = jax.jit(dec.decimate_cascade, static_argnames=("log2_decim", "fc_pos"))(
        state, jnp.asarray(x), 1, "cen"
    )
    y = np.asarray(y)[64:]
    assert np.abs(y).mean() < 0.01  # > 34 dB down


def test_vmap_over_channels():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((8, 2048)) + 1j * rng.standard_normal((8, 2048))).astype(
        np.complex64
    )
    state = dec.init_state(2, batch_shape=(8,))
    _, y = jax.jit(dec.decimate_cascade, static_argnames=("log2_decim", "fc_pos"))(
        state, jnp.asarray(x), 2, "cen"
    )
    assert y.shape == (8, 512)
    for c in range(8):
        np.testing.assert_allclose(
            np.asarray(y[c]), dec.decimate_reference_oracle(x[c], 2), atol=2e-5
        )


@pytest.mark.parametrize("log2", [1, 3, 6])
def test_flat_cascade_matches_staged(log2):
    """decimate_flat (single composed-filter conv) streams identically to
    the staged cascade across block seams, for several ÷2^k."""
    from sdrangel_tpu.dsp import decimators as dec

    rng = np.random.default_rng(11 + log2)
    n = 4 << max(10, log2 + 6)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.3
    cs = dec.init_state(log2)
    fs_ = dec.init_flat_state(log2)
    block = n // 4
    ys, yf = [], []
    for b in range(4):
        xb = jnp.asarray(x[b * block : (b + 1) * block])
        cs, a = dec.decimate_cascade(cs, xb, log2, "cen")
        fs_, c = dec.decimate_flat(fs_, xb, log2)
        ys.append(np.asarray(a))
        yf.append(np.asarray(c))
    a = np.concatenate(ys)
    c = np.concatenate(yf)
    np.testing.assert_allclose(c, a, atol=2e-3, rtol=0)
    assert np.abs(a).max() > 0.1  # non-vacuous


@pytest.mark.parametrize("log2", [1, 2, 4, 6])
@pytest.mark.parametrize("fc_pos", ["inf", "sup"])
def test_flat_rotated_matches_staged_inf_sup(fc_pos, log2):
    """decimate_flat_any == staged cascade for inf/sup placements across
    block seams (input-modulated composed filter)."""
    from sdrangel_tpu.dsp import decimators as dec

    rng = np.random.default_rng(3 + log2 + (fc_pos == "sup"))
    n = 4 << max(11, log2 + 7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * 0.3
    cs = dec.init_state(log2)
    fs_ = dec.init_flat_state(log2)
    block = n // 4
    ys, yf = [], []
    for b in range(4):
        xb = jnp.asarray(x[b * block : (b + 1) * block])
        cs, a = dec.decimate_cascade(cs, xb, log2, fc_pos)
        fs_, c = dec.decimate_flat_any(fs_, xb, log2, fc_pos)
        ys.append(np.asarray(a))
        yf.append(np.asarray(c))
    a = np.concatenate(ys)
    c = np.concatenate(yf)
    assert np.abs(a).max() > 0.05
    np.testing.assert_allclose(c, a, atol=3e-3, rtol=0,
                               err_msg=f"{fc_pos} /{1<<log2}")


@pytest.mark.parametrize("log2", [1, 4, 6])
def test_flat_iq_matches_flat_complex(log2):
    """The layout-native NWC form equals the complex flat cascade across
    block seams."""
    from sdrangel_tpu.dsp import decimators as dec

    rng = np.random.default_rng(9 + log2)
    n = 4 << max(10, log2 + 6)
    x = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    xc = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
    sc = dec.init_flat_state(log2)
    si = dec.init_flat_iq_state(log2)
    block = n // 4
    yc, yi = [], []
    for b in range(4):
        sc, a = dec.decimate_flat(sc, jnp.asarray(xc[b * block : (b + 1) * block]), log2)
        si, c = dec.decimate_flat_iq(si, jnp.asarray(x[b * block : (b + 1) * block]), log2)
        yc.append(np.asarray(a))
        yi.append(np.asarray(c))
    a = np.concatenate(yc)
    c = np.concatenate(yi, axis=0)
    np.testing.assert_allclose(c[:, 0], a.real, atol=1e-5, rtol=0)
    np.testing.assert_allclose(c[:, 1], a.imag, atol=1e-5, rtol=0)
    assert np.abs(a).max() > 0.05

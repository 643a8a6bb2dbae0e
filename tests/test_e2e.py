"""End-to-end slice tests: .sdriq file → device cascade → channelizer →
demod → WAV (the L2 milestone chain, SURVEY.md §7.2)."""

import subprocess
import sys

import numpy as np
import pytest

from sdrangel_tpu.io import sdriq, testsource, wav
from sdrangel_tpu.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline


def _tone_snr(audio, tone_hz, fs):
    n = len(audio)
    audio = audio - audio.mean()
    spec = np.abs(np.fft.rfft(audio * np.hanning(n))) ** 2
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    tone_bins = np.abs(freqs - tone_hz) < 4.0 * fs / n
    return 10.0 * np.log10(spec[tone_bins].sum() / max(spec[~tone_bins].sum(), 1e-30))


def test_sdriq_roundtrip(tmp_path):
    path = str(tmp_path / "x.sdriq")
    rng = np.random.default_rng(0)
    iq = (
        rng.uniform(-0.9, 0.9, 5000) + 1j * rng.uniform(-0.9, 0.9, 5000)
    ).astype(np.complex64)
    sdriq.write(path, iq, sample_rate=768000, center_frequency=145_000_000)
    info = sdriq.read_header(path)
    assert info.sample_rate == 768000
    assert info.center_frequency == 145_000_000
    assert info.sample_size == 16
    assert info.n_samples == 5000
    _, mm = sdriq.open_mmap(path)
    back = sdriq.to_complex64(sdriq.read_block(mm, 0, 5000))
    np.testing.assert_allclose(back, iq, atol=1.0 / 32768.0)
    # wraparound replay (filesourcethread.cpp:188-195 loop-at-EOF)
    wrapped = sdriq.read_block(mm, 4990, 20)
    np.testing.assert_array_equal(wrapped[10:], mm[:10])


def test_file_to_wav_nfm(tmp_path):
    """The north-star chain with an off-centre channel and device decimation."""
    rate = 768_000.0
    offset = 100_000.0  # channel at +100 kHz from centre
    path = str(tmp_path / "cap.sdriq")
    src = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=offset, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4,
    )
    device = DeviceConfig(sample_rate=rate, log2_decim=1)
    pipe = RxPipeline(
        device,
        [ChannelSpec("sdrangel.channel.nfmdemod", offset, {"squelch_db": -60.0})],
    )
    n_blocks = 3
    iq = testsource.generate(src, pipe.device_block * n_blocks)
    sdriq.write(path, iq, sample_rate=int(rate))

    _, mm = sdriq.open_mmap(path)
    audio_parts = [
        outs["channels"][0]["audio"]
        for _, outs in pipe.run(
            lambda b, n: sdriq.read_block(mm, b * n, n), n_blocks
        )
    ]
    audio = np.concatenate(audio_parts)
    out_wav = str(tmp_path / "audio.wav")
    wav.write_wav(out_wav, audio)
    data, fs = wav.read_wav(out_wav)
    a = data[:, 0].astype(np.float64)[len(data) // 2 :] / 32768.0
    snr = _tone_snr(a, 1000.0, fs)
    assert snr > 25.0, f"file->wav NFM SNR {snr:.1f} dB"
    assert pipe.plans[0].decimation >= 4  # channelizer actually narrowed


def test_two_channels_one_pass(tmp_path):
    """Two channels demodulated from one baseband in a single fused step."""
    rate = 384_000.0
    device = DeviceConfig(sample_rate=rate, log2_decim=0)
    pipe = RxPipeline(
        device,
        [
            ChannelSpec("sdrangel.channel.nfmdemod", 100_000.0, {"squelch_db": -60.0}),
            ChannelSpec("sdrangel.channel.amdemod", -50_000.0, {"squelch_db": -60.0}),
        ],
    )
    n_blocks = 3
    fm = testsource.generate(
        testsource.TestSourceConfig(
            sample_rate=rate, carrier_freq=100_000.0, modulation="fm",
            tone_freq=800.0, fm_deviation=5000.0, amplitude=0.3,
        ),
        pipe.device_block * n_blocks,
    )
    am = testsource.generate(
        testsource.TestSourceConfig(
            sample_rate=rate, carrier_freq=-50_000.0, modulation="am",
            tone_freq=1500.0, am_depth=0.8, amplitude=0.3,
        ),
        pipe.device_block * n_blocks,
    )
    iq = (fm + am).astype(np.complex64)
    raw = np.empty((len(iq), 2), dtype=np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)

    chunks = {0: [], 1: []}
    for _, outs in pipe.run(lambda b, n: raw[b * n : (b + 1) * n], n_blocks):
        chunks[0].append(outs["channels"][0]["audio"])
        chunks[1].append(outs["channels"][1]["audio"])
    nfm_audio = np.concatenate(chunks[0])
    am_audio = np.concatenate(chunks[1])
    snr_fm = _tone_snr(nfm_audio[len(nfm_audio) // 2 :], 800.0, 48000.0)
    snr_am = _tone_snr(am_audio[len(am_audio) // 2 :], 1500.0, 48000.0)
    assert snr_fm > 20.0, f"NFM {snr_fm:.1f} dB"
    assert snr_am > 20.0, f"AM {snr_am:.1f} dB"


@pytest.mark.slow
def test_cli_info_and_demod(tmp_path):
    """Drive the actual CLI surface."""
    path = str(tmp_path / "c.sdriq")
    rate = 192_000.0
    src = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=0.0, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4,
    )
    iq = testsource.generate(src, 1 << 19)
    sdriq.write(path, iq, sample_rate=int(rate), center_frequency=7_100_000)

    r = subprocess.run(
        [sys.executable, "-m", "sdrangel_tpu", "info", "--in", path],
        capture_output=True, text=True, cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0
    assert "192000" in r.stdout and "7100000" in r.stdout

    out = str(tmp_path / "o.wav")
    r = subprocess.run(
        [sys.executable, "-m", "sdrangel_tpu", "demod", "--in", path,
         "--channel", "nfm:0", "--squelch", "-60", "--out", out],
        capture_output=True, text=True, cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr
    data, fs = wav.read_wav(out)
    a = data[:, 0].astype(np.float64)[len(data) // 2 :] / 32768.0
    assert _tone_snr(a, 1000.0, fs) > 25.0


def test_input_formats():
    """u8/i8/i12 ADC ingest paths (the DecimatorsU / per-ADC-width role)."""
    import jax.numpy as jnp
    from sdrangel_tpu.dsp.types import iq_raw_to_complex64

    # u8 (RTL-SDR): 127.4 offset
    raw = np.full((16, 2), 127, dtype=np.uint8)
    x = np.asarray(jnp.stack([jnp.real(iq_raw_to_complex64(jnp.asarray(raw), "u8")),
                              jnp.imag(iq_raw_to_complex64(jnp.asarray(raw), "u8"))]))
    assert np.abs(x).max() < 0.01  # mid-scale ~ zero
    raw255 = np.full((16, 2), 255, dtype=np.uint8)
    x255 = np.asarray(jnp.real(iq_raw_to_complex64(jnp.asarray(raw255), "u8")))
    assert 0.9 < x255.max() <= 1.0

    # i12 in int16 container
    raw12 = np.full((16, 2), 2047, dtype=np.int16)
    x12 = np.asarray(jnp.real(iq_raw_to_complex64(jnp.asarray(raw12), "i12")))
    assert 0.99 < x12.max() <= 1.0

    # full pipeline with u8 input
    rate = 192_000.0
    device = DeviceConfig(sample_rate=rate, log2_decim=0, input_format="u8")
    pipe = RxPipeline(
        device, [ChannelSpec("sdrangel.channel.nfmdemod", 0.0, {"squelch_db": -60.0})]
    )
    src = testsource.TestSourceConfig(
        sample_rate=rate, modulation="fm", tone_freq=1000.0,
        fm_deviation=5000.0, amplitude=0.4,
    )
    iq = testsource.generate(src, pipe.device_block * 3)
    raw_u8 = np.empty((len(iq), 2), dtype=np.uint8)
    raw_u8[:, 0] = np.clip(iq.real * 128.0 + 127.4, 0, 255)
    raw_u8[:, 1] = np.clip(iq.imag * 128.0 + 127.4, 0, 255)
    audio = np.concatenate([
        outs["channels"][0]["audio"]
        for _, outs in pipe.run(lambda b, n: raw_u8[b * n : (b + 1) * n], 3)
    ])
    snr = _tone_snr(audio[len(audio) // 2 :], 1000.0, 48000.0)
    assert snr > 20.0, f"u8 ingest NFM SNR {snr:.1f} dB"


def test_sdriq_24bit_roundtrip(tmp_path):
    """24-bit DSP mode (.sdriq sampleSize=24, RX_SAMPLE_24BIT role)."""
    path = str(tmp_path / "x24.sdriq")
    rng = np.random.default_rng(0)
    iq = (rng.uniform(-0.9, 0.9, 3000) + 1j * rng.uniform(-0.9, 0.9, 3000)).astype(
        np.complex64
    )
    sdriq.write(path, iq, sample_rate=500000, sample_size=24)
    info = sdriq.read_header(path)
    assert info.sample_size == 24 and info.n_samples == 3000
    _, mm = sdriq.open_mmap(path)
    back = sdriq.to_complex64(sdriq.read_block(mm, 0, 3000), sample_size=24)
    np.testing.assert_allclose(back, iq, atol=1.5 / 8388608.0)  # 24-bit LSB


def _served_bank(wfm_frac):
    """10 MS/s ÷64 with NFM, AM, SSB and WFM (WFM at the given fraction of
    the baseband rate); building the pipeline solves its block, no compile."""
    bb = 10e6 / 64
    return RxPipeline(DeviceConfig(sample_rate=10e6, log2_decim=6), [
        ChannelSpec("sdrangel.channel.nfmdemod", -0.32 * bb, {}),
        ChannelSpec("sdrangel.channel.amdemod", 0.45 * bb, {}),
        ChannelSpec("sdrangel.channel.ssbdemod", -0.128 * bb, {}),
        ChannelSpec("sdrangel.channel.wfmdemod", wfm_frac * bb,
                    {"rf_bandwidth": 40000.0, "fm_deviation": 10000.0}),
    ])


@pytest.mark.parametrize("wfm_frac,depth,device_block", [
    (0.128, 0, 20_480_000),  # WFM's FFT hop at channel rate 156.25 kHz
    (0.18, 1, 40_960_000),   # ... at 78.125 kHz: twice the block
])
def test_block_solver_fft_hop_depth(wfm_frac, depth, device_block):
    pipe = _served_bank(wfm_frac)
    assert len(pipe.plans[3].signs) == depth
    assert pipe.device_block == device_block


def test_block_solver_refuses_above_cap(monkeypatch):
    from sdrangel_tpu.runtime import engine

    monkeypatch.setattr(engine, "MAX_DEVICE_BLOCK", 1 << 25)
    with pytest.raises(ValueError, match="40960000 device samples"):
        _served_bank(0.18)


def test_bfm_through_engine():
    """BFM attached via the engine (REST path) builds and runs — its internal
    RDS/mono resampler divisibility is honored by the block solver."""
    import jax.numpy as jnp

    rate = 768_000.0
    pipe = RxPipeline(
        DeviceConfig(sample_rate=rate, log2_decim=1),
        [ChannelSpec("sdrangel.channel.bfm", 0.0, {"squelch_db": -100.0},
                     requested_rate=300_000.0)],
    )
    n = pipe.device_block
    t = np.arange(n) / rate
    mono = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    pilot = 0.09 * np.cos(2 * np.pi * 19000.0 * t)
    mpx = 0.45 * mono + pilot
    phase = 2 * np.pi * 75000.0 * np.cumsum(mpx) / rate
    iq = (0.5 * np.exp(1j * phase)).astype(np.complex64)
    raw = np.empty((n, 2), np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    outs_all = list(pipe.run(lambda b, c: raw, 2))
    audio = np.concatenate([o["channels"][0]["audio"] for _, o in outs_all], axis=0)
    assert audio.ndim == 2 and audio.shape[1] == 2  # stereo frames
    a = audio[audio.shape[0] // 2 :, 0]
    assert _tone_snr(a, 1000.0, 48000.0) > 15.0


@pytest.mark.parametrize("fc_pos", ["inf", "sup"])
def test_engine_fc_pos_placement(fc_pos):
    """Device-level inf/sup placements through the engine: the wanted band
    sits at ∓fs/2^n (devicesamplesource.cpp:84-110) and the cascade brings
    it to baseband centre."""
    rate = 768_000.0
    log2 = 3
    shift = rate / (1 << log2)  # n>=3: fs/2^n
    f_want = -shift if fc_pos == "inf" else shift
    device = DeviceConfig(sample_rate=rate, log2_decim=log2, fc_pos=fc_pos)
    pipe = RxPipeline(
        device, [ChannelSpec("sdrangel.channel.nfmdemod", 0.0, {"squelch_db": -60.0})]
    )
    src = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=f_want, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4,
    )
    iq = testsource.generate(src, pipe.device_block * 3)
    raw = np.empty((len(iq), 2), dtype=np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    audio = np.concatenate([
        o["channels"][0]["audio"]
        for _, o in pipe.run(lambda b, n: raw[b * n : (b + 1) * n], 3)
    ])
    snr = _tone_snr(audio[len(audio) // 2 :], 1000.0, 48000.0)
    assert snr > 25.0, f"{fc_pos} placement SNR {snr:.1f} dB"


def test_mixed_audio_and_data_bank():
    """One fused step serving an NFM audio channel and two data channels
    (channel analyzer + LoRa): block solving honours each kind's grid and
    the outputs carry the right payloads."""
    rate = 768_000.0
    src = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=50_000.0, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4,
    )
    device = DeviceConfig(sample_rate=rate, log2_decim=0)
    pipe = RxPipeline(
        device,
        [
            ChannelSpec("sdrangel.channel.nfmdemod", 50_000.0, {"squelch_db": -60.0}),
            ChannelSpec("sdrangel.channel.chanalyzer", 50_000.0, {"bandwidth": 12000.0}),
            ChannelSpec("sdrangel.channel.lorademod", -100_000.0,
                        {"bandwidth": 96000.0, "spread_factor": 7}),
        ],
    )
    iq = testsource.generate(src, pipe.device_block * 2)

    def reader(b, n):
        raw = np.empty((n, 2), np.int16)
        blk = iq[b * n : (b + 1) * n]
        raw[:, 0] = np.clip(blk.real * 32768, -32768, 32767)
        raw[:, 1] = np.clip(blk.imag * 32768, -32768, 32767)
        return raw

    results = list(pipe.run(reader, 2))
    _, outs = results[-1]
    chans = outs["channels"]
    assert "audio" in chans[0] and "data" not in chans[0]
    assert set(chans[1]["data"]) >= {"iq_real", "iq_imag", "spectrum"}
    assert set(chans[2]["data"]) == {"symbols", "magnitudes", "snr_est"}
    # LoRa frame grid: whole symbols per block
    lora_cfg = pipe.demod_cfgs[2]
    chips_per_block = lora_cfg.resamp_plan.block_out
    assert chips_per_block % lora_cfg.n_bins == 0
    assert np.asarray(chans[2]["data"]["symbols"]).shape[-1] == chips_per_block // lora_cfg.n_bins
    # analyzer sees the FM carrier: power well above the LoRa channel's noise
    assert float(chans[1]["data"]["channelPowerDB"]) > -30.0


def test_raw_cu8_capture_through_session(tmp_path):
    """Raw headerless 8-bit capture playback (the rtl_sdr .cu8 format):
    the session ingests at the ADC width (u8 scale policy, half the
    host->device bytes of i16) and recovers the FM tone; publish_every
    batches the device->host fetches into one per burst."""
    import time

    from sdrangel_tpu.io import testsource
    from sdrangel_tpu.runtime.session import DeviceSet

    rate = 768_000.0
    cfg = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=20_000.0, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.5)
    c = testsource.generate(cfg, 1 << 20)
    u8 = np.empty((len(c), 2), np.uint8)
    u8[:, 0] = np.clip(c.real * 128.0 + 127.4, 0, 255)
    u8[:, 1] = np.clip(c.imag * 128.0 + 127.4, 0, 255)
    path = str(tmp_path / "cap.cu8")
    with open(path, "wb") as f:
        f.write(u8.tobytes())

    ds = DeviceSet(0)
    ds.update_source({
        "kind": "filesource", "file_path": path, "sample_rate": rate,
        "log2_decim": 4, "run_blocks": 6, "publish_every": 2,
    })
    ds.add_channel("sdrangel.channel.nfmdemod",
                   {"inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})
    ds.start()
    t0 = time.time()
    while ds.running and time.time() - t0 < 180:
        time.sleep(0.2)
    ds.stop()
    assert not ds.error, ds.error
    assert ds.blocks_processed == 6
    a = ds.drain_audio(0)
    n = len(a) // 2
    a = a[n:] - a[n:].mean()
    sp = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.fft.rfftfreq(len(a), 1 / 48000.0)
    snr = 10 * np.log10(sp[np.abs(f - 1000) < 40].sum()
                        / sp[(f > 100) & (np.abs(f - 1000) >= 40)].sum())
    assert snr > 20.0, f"cu8 tone SNR {snr:.1f} dB"


def test_file_preload_matches_streaming(tmp_path):
    """file_preload plays the capture from device-resident memory (zero
    per-block H2D); the audio equals the streaming reader's bit for bit."""
    import time

    from sdrangel_tpu.io import sdriq, testsource
    from sdrangel_tpu.runtime.session import DeviceSet

    rate = 768_000.0
    cfg = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=20_000.0, modulation="fm",
        tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.5)
    c = testsource.generate(cfg, 1 << 19)
    iq = np.empty((len(c), 2), np.int16)
    iq[:, 0] = np.clip(c.real * 32768.0, -32768, 32767)
    iq[:, 1] = np.clip(c.imag * 32768.0, -32768, 32767)
    path = str(tmp_path / "cap.sdriq")
    w = sdriq.SdriqWriter(path, sample_rate=int(rate), center_frequency=0)
    w.write(iq)
    w.close()

    audio = {}
    for preload in (False, True):
        ds = DeviceSet(0)
        ds.update_source({
            "kind": "filesource", "file_path": path, "log2_decim": 4,
            "run_blocks": 5, "publish_every": 2, "file_preload": preload,
        })
        ds.add_channel("sdrangel.channel.nfmdemod",
                       {"inputFrequencyOffset": 20_000.0,
                        "squelch_db": -100.0})
        ds.start()
        t0 = time.time()
        while ds.running and time.time() - t0 < 180:
            time.sleep(0.1)
        ds.stop()
        assert not ds.error, ds.error
        audio[preload] = ds.drain_audio(0)
    np.testing.assert_array_equal(audio[False], audio[True])


def test_file_preload_size_guard(tmp_path):
    from sdrangel_tpu.io import sdriq
    from sdrangel_tpu.runtime.session import DeviceSet

    path = str(tmp_path / "cap.sdriq")
    w = sdriq.SdriqWriter(path, sample_rate=768000, center_frequency=0)
    w.write(np.zeros((1 << 16, 2), np.int16))
    w.close()
    ds = DeviceSet(0)
    ds.update_source({"kind": "filesource", "file_path": path,
                      "file_preload": True, "file_preload_max_mb": 0})
    ds.add_channel("sdrangel.channel.nfmdemod", {})
    ds.start()
    import time
    t0 = time.time()
    while ds.running and time.time() - t0 < 60:
        time.sleep(0.1)
    assert "file_preload" in ds.error

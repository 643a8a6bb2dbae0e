"""Session / orchestration layer — the MainCore equivalent.

Reference: sdrsrv/maincore.{h,cpp} — owns DeviceSets, adds/removes devices
and channels, loads/saves presets, start/stops acquisition; driven by the
REST API (sdrsrv/webapi/webapiadaptersrv.cpp). Here a DeviceSet wraps an
RxPipeline; acquisition runs in a worker thread streaming file/synthetic
blocks through the jitted step (the DSPDeviceSourceEngine thread role) and
publishing per-channel reports and audio sinks.

Live reconfiguration (the reference's typed-message applySettings path,
webapiadaptersrv.cpp:1637 → nfmdemod.cpp handleMessage, channelizer reconfig
downchannelizer.cpp:111-189): settings apply to a RUNNING pipeline at block
boundaries. Dynamic knobs (inputFrequencyOffset within the channel's
passband, squelch_db, volume) thread through the jitted step as traced args
every block — no recompilation. Static changes (bandwidths, rates, channel
add/remove, device settings) bump a generation counter; the worker rebuilds
and re-jits the pipeline between blocks, keeping the stream position.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional

import numpy as np

from ..channels import registry
from ..channels.registry import REGISTRY
from ..io import sdriq, testsource
from .engine import ChannelSpec, DeviceConfig, RxPipeline
from .fifo import BlockFifo
from .tx import _MOD_KINDS, TxChannelSpec, TxDeviceConfig, TxPipeline

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class ChannelState:
    uri: str
    frequency_offset: float
    settings: dict
    # live report fields (channel report endpoint)
    channel_power_db: float = -120.0
    audio_sample_rate: int = 48000
    squelch: bool = False
    audio_samples: int = 0
    data_blocks: int = 0
    latest_data: dict | None = None  # data channels: last block's arrays
    host_report: dict | None = None  # host-side decode results (e.g. DATV)


@dataclasses.dataclass
class SourceSettings:
    """File or synthetic front end (filesource/testsource settings)."""

    kind: str = "testsource"  # testsource | filesource | daemonsource
    file_path: str = ""
    # filesource container: "sdriq" (32-byte header, 16/24-bit) or a raw
    # headerless capture — "cu8" (rtl_sdr), "cs8" (hackrf), "cs16";
    # "auto" picks sdriq for .sdriq else by extension. Raw captures take
    # rate/centre from these settings (no header to read) and ingest at
    # the ADC width — half the host->device bytes for 8-bit sources.
    file_format: str = "auto"
    # Preload the whole capture into device memory at start (bounded by
    # file_preload_max_mb): playback then reads device-side slices with
    # ZERO per-block host->device traffic: one upload replaces a
    # synchronous per-block host->device copy. Whether that pays on the
    # H100 waits on the served-path measurement (ROADMAP Design 4).
    file_preload: bool = False
    file_preload_max_mb: int = 2048
    sample_rate: float = 768000.0
    center_frequency: float = 0.0
    log2_decim: int = 0
    fc_pos: str = "cen"
    dc_correction: bool = False
    iq_correction: bool = False
    throttle: bool = False  # True = real-time pacing like the 50ms master timer
    # daemonsource extras (UDP+FEC ingest, io/daemon.py)
    daemon_address: str = "127.0.0.1"
    daemon_port: int = 9090
    # testsource extras
    modulation: str = "fm"
    carrier_freq: float = 0.0
    tone_freq: float = 1000.0
    amplitude: float = 0.5
    # spectrum display tap (SpectrumVis config: spectrumvis.cpp:77-200)
    spectrum_fft_size: int = 1024
    spectrum_averaging: str = "moving"  # none | moving | fixed
    spectrum_averaging_n: int = 8
    spectrum_overlap: int = 0  # frames advance by fft_size - overlap
    # Rx IQ record: non-empty -> the running device stream is recorded to
    # this .sdriq path (the FileRecord direct-sink role, filerecord.h:17-23)
    record_file: str = ""
    # Sharded acquisition: run this device set through the mesh-sharded
    # pipeline (parallel/sharded.py) instead of the single-device engine —
    # a distributed launch is a session flag, not a worker script (SURVEY §5
    # distributed backend; under jax.distributed each process feeds only its
    # addressable shards via parallel/hostfeed.py and publishes only its
    # addressable channels' reports/audio).
    sharded: bool = False
    mesh_time: int = 0  # 0 = auto: all devices / mesh_channel
    mesh_channel: int = 1
    sharded_block: int = 0  # device-rate samples per step (0 = auto)
    # >0: the sharded bank runs the M-channel polyphase DFT filter bank
    # (dsp/pfb.py uniform-grid gear) instead of per-channel NCO mixing;
    # channel offsets snap to the grid with the residual on the demod NCO
    sharded_pfb_m: int = 0
    # with sharded_pfb_m: run the Ulysses axis-swap gear (pfb_all_to_all —
    # frame-sharded analysis + one all_to_all; D-fold less inter-device
    # traffic than the all_gather gear). Channels are placed by grid chunk (a2a_placement);
    # the baseband spectrum tap is frame-sharded over the time axis (r5).
    sharded_pfb_a2a: bool = False
    # >0: acquisition ends itself after N blocks (play-once). Required for
    # clean multi-process sharded shutdown: every process leaves the
    # collective step loop at the same block instead of racing stop()
    # against a peer already blocked inside the next step's collectives.
    run_blocks: int = 0
    # Publish (fetch device outputs to host) every N blocks instead of
    # every block. The reports are one concatenated device-side vector per
    # burst — raising this amortizes the per-fetch latency at the cost of
    # N-block-stale reports/audio (the ThreadedBasebandSampleSink FIFO
    # depth analog).
    publish_every: int = 1


_FIELD_TYPES = {"str": str, "float": float, "int": int, "bool": bool}


def coerce_settings(target, settings: dict) -> dict:
    """Type-check/coerce a JSON settings dict against a dataclass instance.

    Returns {field: coerced_value}; raises ValueError on unknown fields or
    wrong types (the API maps that to HTTP 400 — the reference's typed SWG
    DTOs reject these at parse time)."""
    fields = {f.name: f for f in dataclasses.fields(target)}
    out = {}
    for k, v in settings.items():
        f = fields.get(k)
        if f is None:
            raise ValueError(
                f"unknown device setting {k!r}; allowed: {sorted(fields)}"
            )
        want = _FIELD_TYPES.get(f.type if isinstance(f.type, str) else f.type.__name__)
        if want is None:
            out[k] = v
        elif want is bool:
            if not isinstance(v, bool):
                raise ValueError(f"{k} must be a boolean, got {v!r}")
            out[k] = v
        elif want is float:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{k} must be a number, got {v!r}")
            out[k] = float(v)
        elif want is int:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"{k} must be an integer, got {v!r}")
            out[k] = v
        else:  # str
            if not isinstance(v, str):
                raise ValueError(f"{k} must be a string, got {v!r}")
            out[k] = v
    return out


class DeviceSet:
    """One source + its channels (sdrsrv/device/deviceset.h:31-53).

    A channel setting `audioFile` streams its demod audio to a WAV file
    continuously while running (the FileRecord-for-audio role)."""

    direction = "rx"

    def __init__(self, index: int):
        self.index = index
        self.source = SourceSettings()
        self.channels: list[ChannelState] = []
        self.running = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._audio_buffers: list[list[np.ndarray]] = []
        self.audio_keep_blocks = 64
        self._data_sinks: dict = {}  # id(ch) -> ((addr, port, fmt), UdpSink)
        self.blocks_processed = 0
        self.error: str = ""
        # settings generation: bumped by static config changes; the worker
        # rebuilds/re-jits the pipeline between blocks when it moves
        # (dynamic knobs bypass this — they thread through as traced args)
        self._gen = 0
        # tracing/observability: wall-clock vs sample-clock (SURVEY §5 —
        # the framework's per-block "real-time factor" metric)
        self.realtime_factor = 0.0
        self.spectrum: np.ndarray | None = None  # latest baseband spectrum
        self.scope: np.ndarray | None = None  # latest scope traces (3, 1024)
        # display-history taps (GLSpectrum waterfall + histogram-with-decay
        # semantics, headless — glspectrum.h:135-174)
        self.waterfall: list[np.ndarray] = []  # ring of recent spectra (dB)
        self.waterfall_keep = 64
        self.histogram: np.ndarray | None = None  # (100, fft) uint8 intensity
        # a2a gear degradation: when a live retune makes the grid-channel
        # placement unbalanceable (a2a_placement refuses), the worker falls
        # back to the all_gather gear for the REST of this generation
        # instead of erroring out; a static reconfig (gen bump) retries the
        # a2a gear. Stored as the generation the fallback applies to.
        self._a2a_fallback_gen = -1

    @property
    def a2a_fallback(self) -> bool:
        """True while the sharded worker runs the all_gather gear because
        the configured a2a gear could not place the current channel grid."""
        return self._a2a_fallback_gen == self._gen

    # -- configuration -----------------------------------------------------

    def add_channel(self, uri: str, settings: dict | None = None) -> int:
        if uri not in REGISTRY:
            raise KeyError(uri)
        settings = dict(settings or {})
        registry.validate_settings(uri, settings)
        offset = float(settings.pop("inputFrequencyOffset", 0.0))
        with self._lock:
            self.channels.append(ChannelState(uri, offset, settings))
            self._audio_buffers.append([])
            self._gen += 1
            return len(self.channels) - 1

    def remove_channel(self, index: int) -> None:
        with self._lock:
            del self.channels[index]
            del self._audio_buffers[index]
            self._gen += 1

    #: settings names whose live changes thread through as traced args
    #: (paired with the matching process kwarg in ChannelKind.dynamic_fields)
    _DYN_SETTINGS = {"squelch_db": "squelch_db", "volume": "volume"}

    def update_channel(self, index: int, settings: dict) -> None:
        """Apply channel settings; takes effect on a RUNNING pipeline at the
        next block boundary (webapiadaptersrv.cpp:1637 →
        nfmdemod.cpp handleMessage/applySettings semantics)."""
        with self._lock:
            ch = self.channels[index]
            registry.validate_settings(ch.uri, settings)
            dyn_fields = REGISTRY[ch.uri].dynamic_fields
            static_change = False
            if "inputFrequencyOffset" in settings:
                new_off = float(settings.pop("inputFrequencyOffset"))
                if new_off != ch.frequency_offset and "offset_hz" not in dyn_fields:
                    static_change = True
                ch.frequency_offset = new_off
                # in-passband retunes ride the NCO (traced); the worker bumps
                # the generation itself when the offset leaves the passband
            for k, v in settings.items():
                if ch.settings.get(k) == v:
                    continue
                if not (self._DYN_SETTINGS.get(k) in dyn_fields):
                    static_change = True
            ch.settings.update(settings)
            if static_change:
                self._gen += 1

    def update_source(self, settings: dict) -> None:
        """Typed device-settings update (400-on-wrong-type at the API)."""
        target = self.sink if self.direction == "tx" else self.source
        coerced = coerce_settings(target, settings)
        with self._lock:
            changed = False
            for k, v in coerced.items():
                if getattr(target, k) != v:
                    setattr(target, k, v)
                    changed = True
            if changed:
                self._gen += 1

    # -- acquisition -------------------------------------------------------

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self.error = ""
        # running flips BEFORE the thread starts: a fast-failing worker's
        # finally (running = False) must not be overwritten afterwards,
        # which left dead sets stuck "running" and unrestartable
        self.running = True
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30.0)
        self.running = False

    def _build_pipeline(self) -> tuple[RxPipeline, Any]:
        src = self.source
        input_format = "i16"
        fmt = src.file_format
        if fmt == "auto" and src.file_path:
            fmt = "sdriq" if src.file_path.lower().endswith(".sdriq") \
                else src.file_path.rsplit(".", 1)[-1].lower()
        raw_file = src.kind == "filesource" and fmt in sdriq.RAW_FORMATS
        if raw_file:
            input_format = sdriq.RAW_FORMATS[fmt][1]
        elif src.kind == "filesource" and src.file_path:
            # the capture header is authoritative for rate/centre/width (the
            # reference reads it in filesourcethread.cpp and reconfigures)
            info = sdriq.read_header(src.file_path)
            src.sample_rate = float(info.sample_rate)
            if info.center_frequency:
                src.center_frequency = float(info.center_frequency)
            if info.sample_size == 24:
                # 24-bit mmaps as int32: keep SDR_RX_SCALEF=2^23, not 2^15
                input_format = "i24"
        device = DeviceConfig(
            sample_rate=src.sample_rate,
            center_frequency=src.center_frequency,
            log2_decim=src.log2_decim,
            fc_pos=src.fc_pos,
            dc_correction=src.dc_correction,
            iq_correction=src.iq_correction,
            input_format=input_format,
        )
        specs = []
        for ch in self.channels:
            st = dict(ch.settings)
            for k in registry.SESSION_KEYS:  # session-level, not demod knobs
                st.pop(k, None)
            specs.append(ChannelSpec(
                ch.uri, ch.frequency_offset, st,
                requested_rate=registry.requested_rate(ch.uri, st),
            ))
        from ..dsp import spectrum as dsp_spectrum

        pipe = RxPipeline(
            device, specs, block_size=1 << 16,
            spectrum_cfg=dsp_spectrum.SpectrumConfig(
                fft_size=int(src.spectrum_fft_size),
                averaging_mode=src.spectrum_averaging,
                averaging_n=int(src.spectrum_averaging_n),
                overlap=int(src.spectrum_overlap),
            ),
        )
        if src.kind == "daemonsource":
            from ..io.daemon import DaemonReceiver

            rx = getattr(self, "_daemon_rx", None)
            if rx is None:  # reuse the socket across pipeline rebuilds
                rx = DaemonReceiver(src.daemon_address, src.daemon_port, timeout=5.0)
                self._daemon_rx = rx
            pending = [np.zeros((0, 2), np.int16)]

            def reader(pos, count):  # network stream — position-independent
                buf = pending[0]
                while buf.shape[0] < count:
                    try:
                        iq, _meta = rx.recv_frame()
                    except (TimeoutError, OSError):
                        # stream gap (sender still compiling, link down, or
                        # shutdown): a network source emits silence instead
                        # of killing the device set — "running, no signal",
                        # like the reference's daemon source; the worker's
                        # stop flag ends the run at the block boundary
                        iq = np.zeros((count - buf.shape[0], 2), np.int16)
                    buf = np.concatenate([buf, iq], axis=0)
                pending[0] = buf[count:]
                return buf[:count]
        elif src.kind == "filesource" and raw_file:
            mm = sdriq.open_raw(src.file_path, fmt)
            reader = self._file_reader(mm, pipe_block=None)
        elif src.kind == "filesource":
            info, mm = sdriq.open_mmap(src.file_path)
            reader = self._file_reader(mm, pipe_block=None)
        else:
            cfg = testsource.TestSourceConfig(
                sample_rate=src.sample_rate,
                carrier_freq=src.carrier_freq,
                modulation=src.modulation,
                tone_freq=src.tone_freq,
                amplitude=src.amplitude,
            )

            def reader(pos, count):
                c = testsource.generate(cfg, count, start_sample=pos)
                out = np.empty((count, 2), dtype=np.int16)
                out[:, 0] = np.clip(c.real * 32768.0, -32768, 32767)
                out[:, 1] = np.clip(c.imag * 32768.0, -32768, 32767)
                return out

        if getattr(reader, "_needs_block", False):
            reader = reader(pipe.device_block)  # bind the preload extension
        return pipe, reader

    def _file_reader(self, mm, pipe_block):
        """Playback reader over an (N, 2) host array. With file_preload the
        whole capture (extended by one block so wrap reads never straddle)
        is device_put ONCE and blocks are device-side slices — no per-block
        host->device transfer (see SourceSettings.file_preload)."""
        src = self.source
        if not src.file_preload:
            def reader(pos, count):
                return sdriq.read_block(mm, pos, count)
            return reader

        mb = mm.nbytes / 1e6
        if mb > src.file_preload_max_mb:
            raise ValueError(
                f"file_preload: capture is {mb:.0f} MB > "
                f"file_preload_max_mb={src.file_preload_max_mb}")

        def bind(block):
            import jax

            n = mm.shape[0]
            pad = sdriq.read_block(mm, 0, block)  # head copy for the wrap
            dev = jax.device_put(np.concatenate([np.asarray(mm), pad]))

            def reader(pos, count):
                start = pos % n
                return dev[start:start + count]
            return reader

        bind._needs_block = True
        return bind

    def _sync_sinks(self, wav_writers: dict, net_sinks: dict) -> None:
        """Reconcile per-channel egress objects with the current settings
        (called between generations; keyed by ChannelState identity so an
        unrelated settings change never truncates a live WAV)."""
        import wave as _wave

        live = {id(ch): ch for ch in self.channels}
        for cid in list(wav_writers):
            path, w = wav_writers[cid]
            ch = live.get(cid)
            if ch is None or ch.settings.get("audioFile") != path:
                try:
                    w.close()
                except Exception:
                    pass
                del wav_writers[cid]
        for ch in self.channels:
            path = ch.settings.get("audioFile")
            # data channels (chanalyzer/LoRa/...) produce no audio —
            # opening a writer would leave an empty WAV silently
            if path and REGISTRY[ch.uri].output == "audio" and id(ch) not in wav_writers:
                w = _wave.open(path, "wb")
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(48000)
                wav_writers[id(ch)] = (path, w)
        # network audio egress (AudioNetSink role, audionetsink.h:29-63 —
        # raw UDP or RTP L16): settings "audioUdp"/"audioRtp" take "host:port"
        for cid in list(net_sinks):
            key, sinks = net_sinks[cid]
            ch = live.get(cid)
            now = (ch.settings.get("audioUdp"), ch.settings.get("audioRtp")) if ch else None
            if now != key:
                for s in sinks:
                    try:
                        s.close()
                    except Exception:
                        pass
                del net_sinks[cid]
        for ch in self.channels:
            key = (ch.settings.get("audioUdp"), ch.settings.get("audioRtp"))
            if key == (None, None) or id(ch) in net_sinks:
                continue
            sinks = []
            if key[0]:
                from ..io.udp import UdpSink

                host, port = key[0].rsplit(":", 1)
                sinks.append(UdpSink(host, int(port), "mono16"))
            if key[1]:
                from ..io.rtp import RtpAudioSender

                host, port = key[1].rsplit(":", 1)
                sinks.append(RtpAudioSender(host, int(port)))
            net_sinks[id(ch)] = (key, sinks)
        # udpsrc data egress (udpsrc.cpp feed → UDPSink datagrams): settings
        # udpAddress/udpPort/udpFormat on a udpsrc channel stream the
        # channel's formatted output as raw datagrams
        data_sinks = self._data_sinks
        for cid in list(data_sinks):
            key, sink = data_sinks[cid]
            ch = live.get(cid)
            now = self._udpsrc_key(ch) if ch is not None else None
            if now != key:
                try:
                    sink.close()
                except Exception:
                    pass
                del data_sinks[cid]
        for ch in self.channels:
            key = self._udpsrc_key(ch)
            if key is None or id(ch) in data_sinks:
                continue
            from ..io.udp import UdpSink

            addr, port, fmt = key
            data_sinks[id(ch)] = (key, UdpSink(addr, port, fmt))

    @staticmethod
    def _udpsrc_key(ch) -> tuple | None:
        if ch.uri != "sdrangel.channel.udpsrc":
            return None
        addr = ch.settings.get("udpAddress")
        port = ch.settings.get("udpPort")
        if not addr or not port:
            return None
        fmt = ch.settings.get(
            "udpFormat", "iq16" if ch.settings.get("fmt", "iq") == "iq" else "mono16"
        )
        return (str(addr), int(port), str(fmt))

    def _live_dyn(self, pipe) -> tuple[list, bool]:
        """Per-channel dynamic params from the live settings (caller holds
        the lock). Returns (dyn, rebuild): rebuild is True when a retune
        left the channelizer passband — the NCO can't absorb it, so the
        plan must be recomputed (downchannelizer.cpp applyConfiguration)."""
        dyn = []
        rebuild = False
        for i, ch in enumerate(self.channels):
            kind = pipe.kinds[i]
            cfg = pipe.demod_cfgs[i]
            d = {}
            if "offset_hz" in kind.dynamic_fields:
                delta = ch.frequency_offset - pipe.channel_specs[i].frequency_offset
                if abs(delta) > 0.25 * pipe.plans[i].channel_rate:
                    rebuild = True
                d["offset_hz"] = float(cfg.input_offset + delta)
            if "squelch_db" in kind.dynamic_fields:
                d["squelch_db"] = float(ch.settings.get("squelch_db", cfg.squelch_db))
            if "volume" in kind.dynamic_fields:
                d["volume"] = float(ch.settings.get("volume", cfg.volume))
            dyn.append(d)
        return dyn, rebuild

    def _bank_plan(self, n_channel: int):
        """Group this set's channels into homogeneous BankGroups for the
        sharded pipeline. Returns (groups, chmap): chmap[g] lists the channel
        indices occupying group g's bank rows, in order. Caller holds the
        lock."""
        from ..parallel.sharded import BankGroup

        order: list = []
        by_key: dict = {}
        for idx, ch in enumerate(self.channels):
            kind = REGISTRY.get(ch.uri)
            if kind is None or kind.output != "audio":
                raise ValueError(
                    f"sharded device sets support audio channel kinds; "
                    f"channel {idx} is {ch.uri}"
                )
            if "offset_hz" not in kind.dynamic_fields:
                raise ValueError(
                    f"{ch.uri} cannot run sharded (offset is not a traced arg)"
                )
            st = {k: v for k, v in ch.settings.items()
                  if k not in registry.SESSION_KEYS}
            key = (ch.uri, tuple(sorted(st.items())))
            if key not in by_key:
                by_key[key] = []
                order.append(key)
            by_key[key].append(idx)
        groups, chmap = [], []
        for key in order:
            idxs = by_key[key]
            if len(idxs) % n_channel:
                raise ValueError(
                    f"{key[0]}: {len(idxs)} channels with identical settings "
                    f"needed in multiples of the mesh channel axis {n_channel}"
                )
            groups.append(BankGroup(key[0], len(idxs), dict(key[1])))
            chmap.append(idxs)
        return tuple(groups), chmap

    def _work_sharded(self) -> None:
        """Sharded engine thread: the mesh-sharded pipeline as the device
        set's acquisition loop. Same generation semantics as _work; audio
        and reports are published per addressable channel shard, so under
        jax.distributed every process serves its own channels."""
        import jax
        import jax.numpy as jnp  # noqa: F401  (device arrays built below)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel import sharded as shmod
        from ..parallel.hostfeed import ShardedSdriqFeeder

        wav_writers: dict = {}
        net_sinks: dict = {}
        pos_blocks = 0  # block index (survives rebuilds)
        try:
            while not self._stop.is_set():
                with self._lock:
                    gen = self._gen
                    src = self.source
                    if not src.sharded:
                        return  # mode flipped: _work re-dispatches
                    n_channel = max(1, int(src.mesh_channel))
                    n_devices = len(jax.devices())
                    n_time = int(src.mesh_time) or max(1, n_devices // n_channel)
                    groups, chmap = self._bank_plan(n_channel)
                    if src.kind == "filesource" and src.file_path:
                        info = sdriq.read_header(src.file_path)
                        src.sample_rate = float(info.sample_rate)
                        if info.center_frequency:
                            src.center_frequency = float(info.center_frequency)
                    self._sync_sinks(wav_writers, net_sinks)
                if not groups:
                    time.sleep(0.05)
                    continue
                import math as _math

                # shard-length (4·2^k per time shard) and, with the PFB
                # gear, analysis-frame (M·2^k) divisibility in one align.
                # Both PFB gears frame-shard the analysis over ALL
                # n_time·n_channel devices, so the frame count must divide
                # the full mesh — otherwise build_sharded_step degrades to
                # replicated analysis (D× redundant flops, VERDICT r3 weak
                # #3); aligning on the full mesh here guarantees the
                # frame-sharded path for every requested sharded_block.
                pfb_m = int(src.sharded_pfb_m)
                a2a = (bool(src.sharded_pfb_a2a) and bool(pfb_m)
                       and not self.a2a_fallback)
                align = (_math.lcm(4, pfb_m or 1) << src.log2_decim) \
                    * n_time * (n_channel if pfb_m else 1)
                if a2a:
                    # a2a spectrum tap: the display frame grid must align
                    # with the time shards (build_a2a_step validates)
                    align = _math.lcm(
                        align, int(src.spectrum_fft_size) * n_time
                        << src.log2_decim)
                block = int(src.sharded_block) or (1 << 17)
                block = max(block // align, 1) * align
                from ..dsp import spectrum as dsp_spectrum

                cfg = shmod.ShardedPipelineConfig(
                    n_time=n_time, n_channel=n_channel,
                    device_rate=src.sample_rate, log2_decim=src.log2_decim,
                    fc_pos=src.fc_pos, block=block, bank=groups,
                    pfb_m=pfb_m, pfb_all_to_all=a2a,
                    spectrum=dsp_spectrum.SpectrumConfig(
                        fft_size=int(src.spectrum_fft_size),
                        averaging_mode="none"),
                )
                mesh = shmod.make_mesh(n_time, n_channel)
                step, init_fn = shmod.build_sharded_step(cfg, mesh)
                # the align above guarantees the frame-sharded analysis
                # path — the replicated fallback must be unreachable here
                assert not getattr(step, "replicated_analysis", False)
                state, carry = init_fn()
                in_sharding = NamedSharding(mesh, P("time", None))
                if src.kind == "filesource":
                    feeder = ShardedSdriqFeeder(src.file_path, mesh, block)
                    read_block = feeder.block
                elif src.kind == "testsource":
                    tcfg = testsource.TestSourceConfig(
                        sample_rate=src.sample_rate,
                        carrier_freq=src.carrier_freq,
                        modulation=src.modulation,
                        tone_freq=src.tone_freq,
                        amplitude=src.amplitude,
                    )

                    def read_block(b, _block=block, _cfg=tcfg):
                        base = b * _block

                        def cb(index):
                            sl = index[0]
                            start = base + (sl.start or 0)
                            count = (sl.stop if sl.stop is not None
                                     else _block) - (sl.start or 0)
                            c = testsource.generate(_cfg, count, start_sample=start)
                            out = np.empty((count, 2), np.int16)
                            out[:, 0] = np.clip(c.real * 32768.0, -32768, 32767)
                            out[:, 1] = np.clip(c.imag * 32768.0, -32768, 32767)
                            return out

                        return jax.make_array_from_callback(
                            (_block, 2), in_sharding, cb
                        )
                else:
                    raise ValueError(
                        f"sharded device sets support filesource/testsource, "
                        f"not {src.kind!r}"
                    )
                off_axes = (("time", "channel")
                            if cfg.channel_split > n_channel else "channel")
                off_sharding = NamedSharding(mesh, P(off_axes))
                spec_alpha = 1.0 / max(1, int(src.spectrum_averaging_n))
                block_seconds = block / src.sample_rate
                while not self._stop.is_set():
                    if src.run_blocks and pos_blocks >= src.run_blocks:
                        self._stop.set()  # play-once complete
                        return
                    with self._lock:
                        if self._gen != gen:
                            break  # static change → rebuild between blocks
                        raw_offsets = [
                            np.asarray(
                                [self.channels[i].frequency_offset
                                 for i in idxs], np.float32)
                            for idxs in chmap
                        ]
                    t0 = time.perf_counter()
                    row_orders = None
                    if a2a:
                        # placement by grid chunk; traced residuals + local
                        # indices (live retunes within a chunk are free;
                        # cross-chunk moves re-place — demod state follows
                        # the slot, so a retune glitch equals the reference
                        # channel-move behaviour). An UNBALANCEABLE retune
                        # (grid channels no longer split evenly over device
                        # chunks) must not kill the set: fall back to the
                        # all_gather gear live for the rest of this
                        # generation (any placement is legal there).
                        try:
                            orders, local_idx, residuals = shmod.a2a_placement(
                                cfg, raw_offsets)
                        except ValueError as e:
                            with self._lock:
                                self._a2a_fallback_gen = self._gen
                            _log.warning(
                                "a2a placement failed after retune (%s); "
                                "falling back to the all_gather gear", e)
                            break  # rebuild (same generation, a2a off)
                        res_t = tuple(jax.device_put(r, off_sharding)
                                      for r in residuals)
                        idx_t = tuple(jax.device_put(i, off_sharding)
                                      for i in local_idx)
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry, res_t, idx_t)
                        audios = audio if isinstance(audio, tuple) else (audio,)
                        row_orders = orders  # audio row r = channel order[r]
                    elif pfb_m:
                        # grid index + residual, both live-updatable
                        split = [shmod.grid_split(cfg, o) for o in raw_offsets]
                        pfb_idx = tuple(jax.device_put(s[0], off_sharding)
                                        for s in split)
                        offsets = tuple(jax.device_put(s[1], off_sharding)
                                        for s in split)
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry, offsets,
                            pfb_idx)
                        audios = audio if isinstance(audio, tuple) else (audio,)
                    else:
                        offsets = tuple(jax.device_put(o, off_sharding)
                                        for o in raw_offsets)
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry, offsets
                        )
                        audios = audio if isinstance(audio, tuple) else (audio,)
                    self._publish_sharded(audios, chmap, wav_writers, net_sinks,
                                          gen=gen, row_orders=row_orders)
                    if spec is not None:
                        # SpectrumVis tap: in-graph stateless frame, EMA here
                        frame = np.asarray(spec)
                        if src.spectrum_averaging == "moving" and \
                                self.spectrum is not None and \
                                len(self.spectrum) == len(frame):
                            frame = ((1.0 - spec_alpha) * self.spectrum
                                     + spec_alpha * frame)
                        self.spectrum = frame
                        self.waterfall.append(frame)
                        del self.waterfall[: -self.waterfall_keep]
                    dt = time.perf_counter() - t0
                    self.realtime_factor = block_seconds / max(dt, 1e-9)
                    pos_blocks += 1
                    if src.throttle and dt < block_seconds:
                        time.sleep(block_seconds - dt)
        except Exception as e:  # StError state
            self.error = f"{type(e).__name__}: {e}"
        finally:
            for _, w in wav_writers.values():
                try:
                    w.close()
                except Exception:
                    pass
            for _, sinks in net_sinks.values():
                for s in sinks:
                    try:
                        s.close()
                    except Exception:
                        pass

    def _publish_sharded(self, audios, chmap, wav_writers, net_sinks,
                         gen: int | None = None, row_orders=None) -> None:
        """Publish one sharded block: only this process's addressable
        channel rows (audio is sharded over 'channel', replicated over
        'time' — duplicate replicas dedup by row index). `gen` guards
        against a channel layout change since the block was computed
        (see _publish_block). With the a2a gear, audio rows are in grid-
        placement order: `row_orders[g][row]` maps back to the group's
        channel position (a2a_placement)."""
        with self._lock:
            if gen is not None and self._gen != gen:
                return
            for g, audio in enumerate(audios):
                rows: dict[int, np.ndarray] = {}
                for shard in audio.addressable_shards:
                    r0 = shard.index[0].start or 0
                    data = np.asarray(shard.data)
                    for r in range(data.shape[0]):
                        rows.setdefault(r0 + r, data[r])
                for row, a in sorted(rows.items()):
                    pos = int(row_orders[g][row]) if row_orders is not None else row
                    ci = chmap[g][pos]
                    ch = self.channels[ci]
                    # power proxy: post-demod audio RMS (the sharded step
                    # doesn't return per-channel magsq; the single-device
                    # engine's report stays the precise one)
                    ch.channel_power_db = float(
                        10.0 * np.log10(max(float((a * a).mean()), 1e-12))
                    )
                    ch.audio_samples += a.shape[-1]
                    buf = self._audio_buffers[ci]
                    buf.append(a)
                    if len(buf) > self.audio_keep_blocks:
                        buf.pop(0)
                    entry = wav_writers.get(id(ch))
                    if entry is not None:
                        pcm = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
                        entry[1].writeframes(pcm.tobytes())
                    for sink in net_sinks.get(id(ch), ((), ()))[1]:
                        sink.write(a)
            self.blocks_processed += 1

    def _work(self) -> None:
        """Engine thread dispatch: each mode function runs generations until
        stop, error, or the `sharded` flag flips (then re-dispatch)."""
        try:
            while not self._stop.is_set() and not self.error:
                if self.source.sharded:
                    self._work_sharded()
                else:
                    self._work_regular()
        finally:
            self.running = False

    def _work_regular(self) -> None:
        """Engine thread: gotoRunning → block loop → gotoIdle
        (dspdevicesourceengine.cpp:325-408 work loop). The outer loop is a
        settings generation: static config changes break the inner block
        loop, rebuild the pipeline and continue from the same stream
        position; dynamic knobs flow through _live_dyn every block."""
        wav_writers: dict = {}  # id(ch) -> (path, wave writer)
        net_sinks: dict = {}  # id(ch) -> (settings key, [sinks])
        recorder = None  # Rx IQ record (FileRecord role)
        pos = 0  # absolute device-rate sample position (survives rebuilds)
        import jax.numpy as jnp

        try:
            while not self._stop.is_set():
                with self._lock:
                    gen = self._gen
                    if self.source.sharded:
                        return  # mode flipped: _work re-dispatches
                    pipe, reader = self._build_pipeline()
                    self._sync_sinks(wav_writers, net_sinks)
                    rec_cfg = (self.source.record_file,
                               int(self.source.sample_rate),
                               int(self.source.center_frequency))
                if recorder is not None and rec_cfg != recorder[0]:
                    recorder[1].close()
                    recorder = None
                if recorder is None and rec_cfg[0]:
                    recorder = (rec_cfg, sdriq.SdriqWriter(
                        rec_cfg[0], sample_rate=rec_cfg[1],
                        center_frequency=rec_cfg[2],
                        sample_size=24 if pipe.device.input_format == "i24" else 16,
                    ))
                state = pipe.init_state()
                block_seconds = pipe.device_block / pipe.device.sample_rate
                # Packed one-behind publish (the ThreadedBasebandSampleSink
                # FIFO decoupling, re-expressed as async dispatch + ONE
                # device->host fetch per publish burst): each block's whole
                # outs tree leaves the device as a single f32 vector
                # (engine._step_packed) and `publish_every` vectors are
                # concatenated on-device and fetched together, one fetch
                # per burst. Reports are at most publish_every blocks stale
                # (settings still apply every block).
                pub_n = max(1, int(self.source.publish_every))
                pending: list = []  # packed device vectors, oldest first
                burst_t0 = [None]  # wall clock at the burst's first block

                def flush(pend):
                    if not pend:
                        return
                    flat = np.asarray(pend[0] if len(pend) == 1
                                      else pipe._cat(*pend))
                    per = flat.shape[0] // len(pend)
                    for k in range(len(pend)):
                        outs_h = pipe.unpack_outs(flat[k * per:(k + 1) * per])
                        self._publish_block(outs_h, wav_writers, net_sinks,
                                            gen=gen)
                    pend.clear()

                while not self._stop.is_set():
                    if (self.source.run_blocks
                            and self.blocks_processed + len(pending)
                            >= self.source.run_blocks):
                        self._stop.set()  # play-once complete (run_blocks)
                        break
                    with self._lock:
                        if self._gen != gen:
                            break  # static change → rebuild between blocks
                        dyn, need_rebuild = self._live_dyn(pipe)
                        if need_rebuild:
                            self._gen += 1
                            continue
                    t0 = time.perf_counter()
                    if burst_t0[0] is None:
                        burst_t0[0] = t0
                    raw = reader(pos, pipe.device_block)
                    if recorder is not None:
                        rec = np.asarray(raw)  # device fetch if preloaded
                        if rec.dtype != np.int16:
                            # raw 8-bit capture -> .sdriq records at 16-bit
                            from ..dsp.types import INPUT_FORMATS

                            _, off, scale = INPUT_FORMATS[
                                pipe.device.input_format]
                            rec = np.clip(
                                (rec.astype(np.float32) - off)
                                * (32768.0 / scale), -32768, 32767
                            ).astype(np.int16)
                        recorder[1].write(rec)
                    pipe._ensure_layout(state, dyn)
                    state, flat = pipe._step_packed(state, jnp.asarray(raw),
                                                    dyn)
                    pending.append(flat)
                    if len(pending) >= pub_n:
                        # realtime factor over the whole burst: dispatch is
                        # async, so only the flush-to-flush wall clock is an
                        # honest sample-clock comparison
                        n_burst = len(pending)
                        flush(pending)
                        dt_burst = time.perf_counter() - burst_t0[0]
                        self.realtime_factor = (
                            n_burst * block_seconds / max(dt_burst, 1e-9))
                        burst_t0[0] = None
                    dt = time.perf_counter() - t0
                    pos += pipe.device_block
                    if self.source.throttle and dt < block_seconds:
                        time.sleep(block_seconds - dt)
                flush(pending)  # drain before rebuild/stop
        except Exception as e:  # StError state (dspdevicesourceengine.h:28)
            self.error = f"{type(e).__name__}: {e}"
        finally:
            for _, w in wav_writers.values():
                try:
                    w.close()
                except Exception:
                    pass
            for _, sinks in net_sinks.values():
                for s in sinks:
                    try:
                        s.close()
                    except Exception:
                        pass
            for _, sink in self._data_sinks.values():
                try:
                    sink.close()
                except Exception:
                    pass
            self._data_sinks.clear()
            if recorder is not None:
                recorder[1].close()

    def _publish_block(self, outs, wav_writers: dict, net_sinks: dict,
                       gen: int | None = None) -> None:
        """Drain one block's device outputs into reports/buffers/sinks.
        `gen` is the settings generation the block was computed under:
        if a structural change (channel add/remove) landed since, the
        block's channel layout no longer matches self.channels — skip it
        rather than publish to the wrong (or a missing) channel."""
        with self._lock:
            if gen is not None and self._gen != gen:
                return
            self.spectrum = np.asarray(outs["spectrum"])
            self.scope = np.asarray(outs["scope"])
            self.waterfall.append(self.spectrum)
            del self.waterfall[: -self.waterfall_keep]
            if (self.histogram is None
                    or self.histogram.shape[1] != len(self.spectrum)):
                # (re)size with the spectrum tap's fft size
                self.histogram = np.zeros((100, len(self.spectrum)), np.uint8)
                self.waterfall.clear()
            from ..dsp.spectrum import histogram_decay

            self.histogram = histogram_decay(self.histogram, self.spectrum)
            for i, out in enumerate(outs["channels"]):
                power = float(out["power"])
                ch = self.channels[i]
                ch.channel_power_db = float(
                    10.0 * np.log10(max(power, 1e-12))
                )
                if "data" in out:
                    ch.latest_data = {
                        k: np.asarray(v) for k, v in out["data"].items()
                    }
                    ch.data_blocks += 1
                    if ch.uri == "sdrangel.channel.demoddatv":
                        self._datv_host_decode(i, ch)
                    elif ch.uri == "sdrangel.channel.dsddemod":
                        self._dsd_host_sync(ch)
                    entry = self._data_sinks.get(id(ch))
                    if entry is not None:
                        (_, _, fmt), sink = entry
                        d = ch.latest_data
                        if fmt in ("iq16", "iq24"):
                            payload = (d["iq_real"] + 1j * d["iq_imag"]).astype(
                                np.complex64
                            )
                        else:  # mono16 / float32 wire the scalar branch
                            payload = d["scalar"]
                        sink.write(payload)
                        if "squelch" in d:
                            ch.squelch = bool(d["squelch"])
                    continue
                audio = np.asarray(out["audio"])
                if "squelch" in out:
                    # the kernel's actual gate state (nfmdemod.h getters)
                    ch.squelch = bool(out["squelch"])
                else:
                    ch.squelch = bool(np.abs(audio).max() > 1e-4)
                # audio is (T,) mono or (T,2) stereo — count frames
                ch.audio_samples += audio.shape[0]
                buf = self._audio_buffers[i]
                buf.append(audio)
                if len(buf) > self.audio_keep_blocks:
                    buf.pop(0)
                entry = wav_writers.get(id(ch))
                if entry is not None:
                    mono = audio if audio.ndim == 1 else audio[:, 0]
                    pcm = np.clip(mono * 32768.0, -32768, 32767).astype(np.int16)
                    entry[1].writeframes(pcm.tobytes())
                for sink in net_sinks.get(id(ch), ((), ()))[1]:
                    mono = audio if audio.ndim == 1 else audio[:, 0]
                    sink.write(mono)
            self.blocks_processed += 1

    def drain_audio(self, channel: int) -> np.ndarray:
        with self._lock:
            parts = self._audio_buffers[channel]
            self._audio_buffers[channel] = []
        if not parts:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(parts, axis=0)  # frame axis (mono or stereo)

    def _dsd_host_sync(self, ch: ChannelState) -> None:
        """Frame-sync scan over the DSD dibit stream (the first stage DSDcc
        performs for the reference, dsddecoder.h:61-63 getSyncType /
        getFrameTypeText): DMR/YSF/D-Star sync correlation + frame typing,
        published in the channel report."""
        from ..channels import dsdsync

        searcher = getattr(ch, "_dsd_sync", None)
        if searcher is None:
            searcher = dsdsync.SyncSearcher()
            ch._dsd_sync = searcher
            ch._dsd_voice = dsdsync.VoiceExtractor()
            ch._dsd_nxdn = dsdsync.NxdnDpmrDecoder()
            ch._dsd_frames = []
        dibits = ch.latest_data["dibits"].reshape(-1)
        hits = searcher.feed(dibits)
        # AMBE voice-frame slicing (the mbelib/DVSerial hand-off boundary
        # DSDcc performs for the reference; vocoder stays external)
        frames = ch._dsd_voice.feed(dibits, hits)
        if frames:
            ch._dsd_frames = (ch._dsd_frames + frames)[-32:]
        # NXDN LICH/SACCH + dPMR frame typing (dsddemod.cpp:655-682 status)
        ch._dsd_nxdn.feed(dibits, hits)
        report = searcher.report()
        report["ambeFrameCount"] = ch._dsd_voice.total
        report["ambeFrames"] = list(ch._dsd_frames)
        report.update(ch._dsd_nxdn.report())
        ch.host_report = {"dsd": report}

    #: soft bits to buffer before the one-shot DATV host FEC pass
    _DATV_DECODE_BITS = 120_000

    def _datv_host_decode(self, idx: int, ch: ChannelState) -> None:
        """Accumulate a demoddatv channel's soft symbols; once enough are
        buffered run the host FEC chain + TS demux and publish the
        programme map in the channel report (the leansdr graph +
        ffmpeg-demux role of the reference's DATV plugin, datvdemod.cpp).

        Default: one decode pass when the buffer first fills. With the
        channel setting `datvContinuous: true` the decode re-runs over a
        bounded sliding window whenever another buffer's worth arrives
        (scrambler-group alignment is preserved because the window always
        starts at the stream head kept by the symbol buffer)."""
        continuous = bool(ch.settings.get("datvContinuous", False))
        if getattr(ch, "_datv_done", False) and not continuous:
            return
        acc = getattr(ch, "_datv_acc", None)
        if acc is None:
            acc = ([], [])
            ch._datv_acc = acc
        acc[0].append(ch.latest_data["soft_i"].reshape(-1))
        acc[1].append(ch.latest_data["soft_q"].reshape(-1))
        total_bits = 2 * sum(a.shape[-1] for a in acc[0])
        cap = 8 * self._DATV_DECODE_BITS  # bounds each window's decode cost
        if total_bits < cap:
            need = self._DATV_DECODE_BITS * (
                1 + getattr(ch, "_datv_rounds", 0) if continuous else 1
            )
            if total_bits < need:
                return
        ch._datv_done = True
        ch._datv_rounds = getattr(ch, "_datv_rounds", 0) + 1
        from ..channels import demod_datv, tsdemux

        cfg_rate = ch.settings.get("fec_rate", "1/2")
        ts, stats = demod_datv.recover_ts(
            np.concatenate(acc[0]), np.concatenate(acc[1]),
            fec_rate=cfg_rate, max_packets=2048,
        )
        # each window is decoded self-contained (per-window rotation/bit
        # alignment; scrambler groups re-found from the inverted sync byte,
        # recover_ts "headDropped"), so the demux re-parses from scratch
        demux = tsdemux.TsDemux()
        demux.feed(ts)
        ch.host_report = {"datv": {**stats, "rounds": ch._datv_rounds,
                                   "ts": demux.summary()}}
        if not continuous:
            ch._datv_acc = None  # one-shot: free the buffer, keep the report
        elif total_bits >= cap:
            # continuous: start the next window fresh — bounded memory,
            # decodes keep updating (the previous "final pass" froze both)
            ch._datv_acc = ([], [])
            ch._datv_rounds = 0


@dataclasses.dataclass
class SinkSettings:
    """Tx device sink settings (the filesink/DAC role, or the
    sdrdaemonsink network role with kind="daemonsink")."""

    kind: str = "filesink"  # filesink (.sdriq) | daemonsink (UDP superframes)
    file_path: str = "/tmp/sdrangel_tpu_tx.sdriq"
    sample_rate: float = 384000.0
    center_frequency: float = 0.0
    log2_interp: int = 0
    throttle: bool = False  # True = real-time pacing (a DAC-clock stand-in)
    # daemonsink extras (plugins/samplesink/sdrdaemonsink role): stream the
    # modulated IQ as FEC superframes to a remote daemonsource
    daemon_address: str = "127.0.0.1"
    daemon_port: int = 9094
    daemon_fec: int = 4
    daemon_auto_fec: bool = False  # receiver feedback drives nbFECBlocks


class TxDeviceSet:
    """Sink device set: modulator channels -> merged baseband -> .sdriq
    (the DSPDeviceSinkEngine + filesink pairing, driven like an Rx set)."""

    direction = "tx"

    def __init__(self, index: int):
        self.index = index
        self.sink = SinkSettings()
        self.channels: list[ChannelState] = []
        self.running = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.blocks_processed = 0
        self.error: str = ""
        self.realtime_factor = 0.0
        self.spectrum = None

    def add_channel(self, uri: str, settings: dict | None = None) -> int:
        if uri not in _MOD_KINDS:
            raise KeyError(uri)
        settings = dict(settings or {})
        registry.validate_settings(uri, settings)
        offset = float(settings.pop("inputFrequencyOffset", 0.0))
        self.channels.append(ChannelState(uri, offset, settings))
        return len(self.channels) - 1

    def remove_channel(self, index: int) -> None:
        del self.channels[index]

    def update_channel(self, index: int, settings: dict) -> None:
        ch = self.channels[index]
        registry.validate_settings(ch.uri, settings)
        if "inputFrequencyOffset" in settings:
            ch.frequency_offset = float(settings.pop("inputFrequencyOffset"))
        ch.settings.update(settings)

    def update_source(self, settings: dict) -> None:
        """Typed sink-settings update (Tx applies at the next start)."""
        for k, v in coerce_settings(self.sink, settings).items():
            setattr(self.sink, k, v)

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self.error = ""
        # running flips BEFORE the thread starts: a fast-failing worker's
        # finally (running = False) must not be overwritten afterwards,
        # which left dead sets stuck "running" and unrestartable
        self.running = True
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30.0)
        self.running = False

    def _work(self) -> None:
        udp_srcs: dict[int, Any] = {}
        wav_srcs: dict[int, np.ndarray] = {}
        try:
            device = TxDeviceConfig(
                sample_rate=self.sink.sample_rate,
                log2_interp=self.sink.log2_interp,
                center_frequency=self.sink.center_frequency,
            )
            specs = []
            tones = []
            keyers: dict[int, Any] = {}
            for i, ch in enumerate(self.channels):
                settings = dict(ch.settings)
                tones.append(float(settings.pop("toneFrequency", 1000.0)))
                # UDP AF ingest (the reference's udpsink Tx channel,
                # plugins/channeltx/udpsink): mono16 datagrams become the
                # channel's audio source instead of the tone
                addr = settings.pop("afUdp", None)
                if addr:
                    from ..io.udp import UdpSource

                    host, port = addr.rsplit(":", 1)
                    udp_srcs[i] = UdpSource(host, int(port), "mono16", timeout=2.0)
                # WAV file AF source (the audio *input* path: the reference
                # modulators read a sound-card/file input via AudioFifo,
                # e.g. plugins/channeltx/modnfm nfmmod.cpp pull from
                # m_audioFifo; headless equivalent: a 48 kHz WAV looped)
                af_file = settings.pop("afFile", None)
                if af_file:
                    import wave as _wave

                    with _wave.open(af_file, "rb") as w:
                        nch = w.getnchannels()
                        pcm = np.frombuffer(
                            w.readframes(w.getnframes()), dtype=np.int16)
                    mono = pcm.reshape(-1, nch).mean(axis=1) / 32768.0
                    wav_srcs[i] = mono.astype(np.float32)
                # CW keyer AF source (the reference's CWKeyer feeding Tx
                # channels, sdrbase/dsp/cwkeyer.h:141): settings cwText/cwWpm
                # key the channel's tone with the Morse envelope, looping
                text = settings.pop("cwText", None)
                wpm = float(settings.pop("cwWpm", 15.0))
                if text:
                    from ..channels.cwkeyer import CWConfig, CWKeyer

                    keyers[i] = CWKeyer(
                        str(text), CWConfig(wpm=wpm, sample_rate=48000.0),
                        loop=True,
                    )
                # strip the remaining session-level keys (audio egress etc):
                # validate_settings accepts all of registry.SESSION_KEYS, so
                # any of them may be present and none belong in the
                # modulator config constructor
                settings = {k: v for k, v in settings.items()
                            if k not in registry.SESSION_KEYS}
                specs.append(TxChannelSpec(ch.uri, ch.frequency_offset, settings))
            if not specs:
                raise ValueError(
                    "Tx device set has no channels — add a modulator "
                    "channel before starting"
                )
            pipe = TxPipeline(device, specs, block_af=4096)

            def af(b, c, count):
                if c in udp_srcs:
                    try:
                        return udp_srcs[c].read(count).astype(np.float32)
                    except Exception:
                        return np.zeros(count, np.float32)  # underrun -> silence
                if c in wav_srcs:  # looped WAV input
                    src = wav_srcs[c]
                    idx = (b * count + np.arange(count)) % len(src)
                    return src[idx]
                t = (b * count + np.arange(count)) / 48000.0
                tone = np.sin(2 * np.pi * tones[c] * t).astype(np.float32)
                if c in keyers:
                    tone = tone * keyers[c].next_block(count)
                return tone

            block_seconds = pipe.device_block / self.sink.sample_rate
            b = 0
            state = pipe.init_state()
            import jax.numpy as jnp

            # sink back end: continuous filesink (.sdriq, header first then
            # per-block payload) or the sdrdaemonsink role — modulated IQ
            # chunked into FEC superframes over UDP (io/daemon.DaemonSender;
            # plugins/samplesink/sdrdaemonsink in the reference)
            daemon_mode = self.sink.kind == "daemonsink"
            writer = sender = None
            if daemon_mode:
                from ..io.daemon import DaemonSender

                sender = DaemonSender(
                    self.sink.daemon_address, int(self.sink.daemon_port),
                    n_fec=int(self.sink.daemon_fec),
                    center_frequency=int(self.sink.center_frequency),
                    sample_rate=int(self.sink.sample_rate),
                    auto_fec=bool(self.sink.daemon_auto_fec),
                )
                room = sender.payload_room // 4  # IQ samples per superframe
                carry = [np.zeros((0, 2), np.int16)]

                def write_blk(blk):
                    if np.iscomplexobj(blk):
                        blk = np.stack(
                            [np.clip(np.round(blk.real * 32768.0), -32768, 32767),
                             np.clip(np.round(blk.imag * 32768.0), -32768, 32767)],
                            axis=-1).astype(np.int16)
                    buf = np.concatenate([carry[0], blk], axis=0)
                    n_full = buf.shape[0] // room
                    for k in range(n_full):
                        sender.send_iq(buf[k * room:(k + 1) * room])
                    carry[0] = buf[n_full * room:]
            else:
                writer = sdriq.SdriqWriter(
                    self.sink.file_path,
                    sample_rate=int(self.sink.sample_rate),
                    center_frequency=int(self.sink.center_frequency),
                )
                write_blk = writer.write

            # SampleSourceFifo role (samplesourcefifo.h): device blocks flow
            # through a bounded FIFO to a writer thread, so device compute,
            # host fetch, and disk IO pipeline; a slow sink backpressures
            # the producer instead of growing memory
            self.fifo = fifo = BlockFifo(depth=8)

            def _drain():
                while True:
                    blk = fifo.get(timeout=1.0)
                    if blk is None:
                        # None means timeout OR closed+drained; only the
                        # latter ends the writer — a plain timeout (e.g.
                        # the producer stuck in a long first-step compile)
                        # must not kill it, or the producer deadlocks in
                        # put() once the fifo fills
                        if fifo.closed:
                            return
                        continue
                    write_blk(blk)

            drain_thread = threading.Thread(target=_drain, daemon=True)
            drain_thread.start()

            pending = None  # one-behind drain: fetch block b while the
            # device runs block b+1 (the Rx engine's async-dispatch pattern)
            try:
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    afs = [jnp.asarray(af(b, c, 4096)) for c in range(len(specs))]
                    state, out = pipe._step(state, afs)
                    if pending is not None:
                        fifo.put(np.asarray(pending))
                    pending = out
                    for i, ch in enumerate(self.channels):
                        ch.audio_samples += 4096
                    self.blocks_processed += 1
                    dt = time.perf_counter() - t0
                    self.realtime_factor = block_seconds / max(dt, 1e-9)
                    b += 1
                    if self.sink.throttle and dt < block_seconds:
                        time.sleep(block_seconds - dt)
                if pending is not None:
                    fifo.put(np.asarray(pending))
            finally:
                fifo.close()
                drain_thread.join(timeout=30.0)
            if writer is not None:
                writer.close()
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
        finally:
            try:
                if writer is not None:
                    writer.close()
                if sender is not None:
                    sender.close()
            except Exception:
                pass
            for src in udp_srcs.values():
                try:
                    src.close()
                except Exception:
                    pass
            self.running = False


#: available source kinds (the DeviceEnumerator role,
#: sdrbase/device/deviceenumerator.cpp — software sources only: no hardware)
SOURCE_KINDS = {
    "testsource": "synthetic carrier generator (AM/FM/none + impairments)",
    "filesource": ".sdriq capture replay (loops at EOF)",
    "daemonsource": "UDP superframe + FEC network ingest (io/daemon.py)",
}

#: current preset document schema. History:
#:   1 (implicit, no "schema" key) — round-1/2 format
#:   2 — explicit version stamp; device/channel settings are sanitized
#:       against the current dataclass fields on load, so presets written
#:       by older or newer builds (fields added/removed since) still load
PRESET_SCHEMA_VERSION = 2


def _known_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _migrate_v1_to_v2(preset: dict) -> dict:
    """v1 → v2: stamp the version, default missing structure (direction,
    channels' settings dict). Field-level sanitizing happens at load."""
    preset = dict(preset)
    preset["schema"] = 2
    sets = []
    for entry in preset.get("deviceSets", []):
        entry = dict(entry)
        entry.setdefault("direction", "rx")
        entry["channels"] = [
            {"uri": ch["uri"],
             "inputFrequencyOffset": ch.get("inputFrequencyOffset", 0.0),
             "settings": ch.get("settings", {})}
            for ch in entry.get("channels", [])
        ]
        sets.append(entry)
    preset["deviceSets"] = sets
    return preset


#: migration chain: schema N -> function producing schema N+1
PRESET_MIGRATIONS = {1: _migrate_v1_to_v2}


def migrate_preset(preset: dict) -> dict:
    """Bring a preset document to PRESET_SCHEMA_VERSION (no-op when
    current; raises on documents NEWER than this build understands)."""
    version = int(preset.get("schema", 1))
    if version > PRESET_SCHEMA_VERSION:
        raise ValueError(
            f"preset schema {version} is newer than this build's "
            f"{PRESET_SCHEMA_VERSION}; upgrade to load it"
        )
    while version < PRESET_SCHEMA_VERSION:
        preset = PRESET_MIGRATIONS[version](preset)
        version = int(preset["schema"])
    return preset


class Session:
    """MainCore: the device-set collection + presets.

    Presets persist to a JSON file (the reference stores Base64-TLV blobs in
    QSettings, mainsettings.cpp; JSON is the idiomatic equivalent here)."""

    def __init__(self, preset_path: str | None = None,
                 preset_dir: str | None = None):
        import os

        self.device_sets: list[DeviceSet] = []
        self.presets: dict[str, dict] = {}
        self.commands: dict[str, dict] = {}
        self.start_time = time.time()
        self.preset_path = preset_path
        # preset file import/export confinement (see _preset_file_path)
        self.preset_dir = preset_dir or os.environ.get(
            "SDRANGEL_TPU_PRESET_DIR",
            os.path.dirname(os.path.abspath(preset_path)) if preset_path
            else os.path.join(os.path.expanduser("~"), ".sdrangel_tpu", "presets"),
        )
        if preset_path:
            import json

            if os.path.exists(preset_path):
                with open(preset_path) as f:
                    raw = json.load(f)
                # tolerate individual unreadable entries (e.g. one preset
                # saved by a NEWER build): keep them verbatim so they
                # aren't lost on the next persist, surface the error only
                # if that preset is actually loaded
                self.presets = {}
                for k, v in raw.items():
                    try:
                        self.presets[k] = migrate_preset(v)
                    except Exception:
                        self.presets[k] = v

    def _persist_presets(self) -> None:
        if self.preset_path:
            import json

            with open(self.preset_path, "w") as f:
                json.dump(self.presets, f, indent=1)

    def add_device_set(self, direction: str = "rx"):
        cls = TxDeviceSet if direction == "tx" else DeviceSet
        ds = cls(len(self.device_sets))
        self.device_sets.append(ds)
        return ds

    def remove_last_device_set(self) -> None:
        if self.device_sets:
            ds = self.device_sets.pop()
            ds.stop()

    def shutdown(self) -> None:
        """Stop every device set (MainCore::MsgDeleteInstance role,
        sdrsrv/webapi/webapiadaptersrv.cpp:104-115 — the reference tears the
        whole instance down; here the process owner decides whether to exit)."""
        for ds in self.device_sets:
            ds.stop()

    # -- commands (sdrbase/commands/command.h:30-70: user shell commands
    # with API-substituted arguments, run on demand) ----------------------

    def set_command(self, name: str, command: str, args: str = "") -> None:
        self.commands[name] = {"command": command, "args": args}

    def delete_command(self, name: str) -> None:
        del self.commands[name]

    def run_command(self, name: str, api_port: int = 8091) -> dict:
        """Run a stored command; %1 in args substitutes the API address
        (the reference substitutes API address/port the same way)."""
        import subprocess

        entry = self.commands[name]
        args = entry["args"].replace("%1", f"127.0.0.1:{api_port}")
        cmd = f"{entry['command']} {args}".strip()
        proc = subprocess.run(
            cmd, shell=True, capture_output=True, text=True, timeout=30.0
        )
        return {
            "name": name,
            "command": cmd,
            "returncode": proc.returncode,
            "stdout": proc.stdout[-4096:],
            "stderr": proc.stderr[-4096:],
        }

    def summary(self) -> dict:
        """instanceSummary (webapiadaptersrv.cpp:71-103): app/version,
        runtime (jax stands in for Qt), arch/OS, DSP bit widths, PID,
        logging config, device-set list."""
        import logging as _logging
        import platform

        import jax

        import sdrangel_tpu

        root = _logging.getLogger()  # the /sdrangel/logging endpoint's target
        return {
            "appname": "sdrangel_tpu",
            "version": sdrangel_tpu.__version__,
            "jaxVersion": jax.__version__,
            "architecture": platform.machine(),
            "os": f"{platform.system()} {platform.release()}",
            "dspRxBits": 16,
            "dspTxBits": 16,
            "pid": __import__("os").getpid(),
            "uptime_s": round(time.time() - self.start_time, 1),
            "logging": {
                "consoleLevel": _logging.getLevelName(root.level),
                "fileName": next(
                    (h.baseFilename for h in root.handlers
                     if isinstance(h, _logging.FileHandler)), ""),
            },
            "devicesetlist": {
                "devicesetcount": len(self.device_sets),
                "deviceSets": [
                    {
                        "index": ds.index,
                        "state": "error" if ds.error else ("running" if ds.running else "idle"),
                        "error": ds.error,
                        "realtimeFactor": round(ds.realtime_factor, 2),
                        "a2aFallback": bool(getattr(ds, "a2a_fallback", False)),
                        "direction": getattr(ds, "direction", "rx"),
                        "source": dataclasses.asdict(
                            ds.sink if getattr(ds, "direction", "rx") == "tx" else ds.source
                        ),
                        "channelcount": len(ds.channels),
                        "channels": [
                            {
                                "index": i,
                                "uri": ch.uri,
                                "inputFrequencyOffset": ch.frequency_offset,
                            }
                            for i, ch in enumerate(ds.channels)
                        ],
                    }
                    for ds in self.device_sets
                ],
            },
        }

    # -- presets (maincore preset load/save; JSON instead of Base64 TLV).
    # Schema versioning: every preset carries "schema"; loaders migrate
    # older documents forward through PRESET_MIGRATIONS before use (the
    # reference versions each plugin blob through serialize/deserialize
    # version bytes, e.g. nfmdemodsettings.cpp deserialize's version guard;
    # here the whole document is versioned once). --------------------------

    def save_preset(self, group: str, name: str) -> dict:
        key = f"{group}/{name}"
        self.presets[key] = {
            "schema": PRESET_SCHEMA_VERSION,
            "group": group,
            "name": name,
            **self._snapshot(),
        }
        self._persist_presets()
        return self.presets[key]

    def _snapshot(self) -> dict:
        """The instance state as a preset body (no store side effects)."""
        return {
            "deviceSets": [
                {
                    "direction": ds.direction,
                    "source": dataclasses.asdict(
                        ds.sink if ds.direction == "tx" else ds.source
                    ),
                    "channels": [
                        {
                            "uri": ch.uri,
                            "inputFrequencyOffset": ch.frequency_offset,
                            # copy: storing the live dict by reference would
                            # let later PATCHes silently mutate the preset
                            "settings": dict(ch.settings),
                        }
                        for ch in ds.channels
                    ],
                }
                for ds in self.device_sets
            ],
        }

    def load_preset(self, group: str, name: str) -> None:
        preset = migrate_preset(self.presets[f"{group}/{name}"])
        for ds in self.device_sets:
            ds.stop()
        self.device_sets = []
        for entry in preset["deviceSets"]:
            direction = entry.get("direction", "rx")
            ds = self.add_device_set(direction)
            # _known_fields: presets written before a settings field was
            # added (or after one was removed) still load — unknown keys
            # drop, missing ones take the dataclass default
            if direction == "tx":
                ds.sink = SinkSettings(**_known_fields(
                    SinkSettings, entry["source"]))
            else:
                ds.source = SourceSettings(**_known_fields(
                    SourceSettings, entry["source"]))
            for ch in entry["channels"]:
                # sanitize against the current schema: presets from builds
                # where a channel setting has since been renamed/removed
                # load with that key dropped (API PUTs stay strict)
                allowed = (set(registry.settings_schema(ch["uri"]))
                           | registry.SESSION_KEYS)
                settings = {k: v for k, v in ch["settings"].items()
                            if k in allowed}
                ds.add_channel(
                    ch["uri"],
                    {"inputFrequencyOffset": ch["inputFrequencyOffset"], **settings},
                )

    def delete_preset(self, group: str, name: str) -> None:
        """instancePresetDelete (webapiadapterinterface.h preset URL table)."""
        del self.presets[f"{group}/{name}"]
        self._persist_presets()

    def server_file_path(self, path: str, kind: str) -> str:
        """Resolve a REST-supplied server-side path inside the confinement
        directory for `kind` ("logs", "profile", ...) — the same threat
        model as _preset_file_path: on an unauthenticated API an
        unrestricted path is an arbitrary-file-write primitive. Base dir:
        SDRANGEL_TPU_FILES_DIR env or ~/.sdrangel_tpu; relative paths land
        in base/kind/, absolute paths must already be inside the base."""
        import os

        base = os.path.realpath(os.environ.get(
            "SDRANGEL_TPU_FILES_DIR",
            os.path.join(os.path.expanduser("~"), ".sdrangel_tpu")))
        sub = os.path.join(base, kind)
        os.makedirs(sub, exist_ok=True)
        resolved = os.path.realpath(
            path if os.path.isabs(path) else os.path.join(sub, path))
        if resolved != base and not resolved.startswith(base + os.sep):
            raise ValueError(
                f"{kind} path must stay inside {base} (set "
                f"SDRANGEL_TPU_FILES_DIR to relocate)")
        return resolved

    def _preset_file_path(self, path: str) -> str:
        """Resolve a preset file path inside the presets directory.

        The REST API is unauthenticated (like the reference's); unrestricted
        server-side paths would allow JSON read/write anywhere the process
        can touch. Paths are confined to `preset_dir` (default: alongside
        the preset store; override with the SDRANGEL_TPU_PRESET_DIR env or
        Session(preset_dir=...)). Absolute paths inside the dir are allowed.
        """
        import os

        base = os.path.realpath(self.preset_dir)
        os.makedirs(base, exist_ok=True)
        resolved = os.path.realpath(
            path if os.path.isabs(path) else os.path.join(base, path)
        )
        if resolved != base and not resolved.startswith(base + os.sep):
            raise ValueError(
                f"preset file path must stay inside the presets directory {base}"
            )
        return resolved

    def export_preset_file(self, group: str, name: str, path: str,
                           fmt: str = "json") -> None:
        """Server-side preset export (the reference's POST
        /sdrangel/preset/file, webapiadaptersrv.cpp instancePresetFilePost).
        fmt "json" (native) or "reference" (Base64-TLV the reference's own
        SimpleDeserializer reads — runtime/refpreset.to_reference_preset;
        only the four audio demod kinds survive the conversion)."""
        import base64
        import json

        preset = self.presets[f"{group}/{name}"]
        if fmt == "reference":
            from . import refpreset

            blob = refpreset.to_reference_preset(preset)
            with open(self._preset_file_path(path), "w") as f:
                f.write(base64.b64encode(blob).decode())
            return
        if fmt != "json":
            raise ValueError(f"unknown preset export format {fmt!r}")
        with open(self._preset_file_path(path), "w") as f:
            json.dump(preset, f, indent=1)

    def import_preset_file(self, path: str) -> str:
        """Server-side preset import (PUT /sdrangel/preset/file): the file
        holds one preset object as written by export, OR a reference
        Base64-TLV preset blob (settings/preset.cpp serialize format) —
        the interchange surface for migrating reference presets
        (runtime/refpreset.py maps the four audio demods' settings)."""
        import json

        with open(self._preset_file_path(path)) as f:
            raw = f.read()
        try:
            preset = json.loads(raw)
        except json.JSONDecodeError:
            from . import refpreset

            preset = refpreset.to_session_preset(
                refpreset.parse_preset(raw.strip()))
        if not isinstance(preset, dict) or "deviceSets" not in preset:
            raise ValueError("not a preset file (missing deviceSets)")
        key = f"{preset.get('group', 'default')}/{preset.get('name', 'imported')}"
        self.presets[key] = migrate_preset(preset)
        self._persist_presets()
        return key

    # -- instance config (GET/PUT /sdrangel/config: the whole instance state
    # as one document — the reference's instanceConfigGet/Put) ---------------

    def config_get(self) -> dict:
        # pure snapshot — no transient preset-store key, no disk writes
        return {"schema": PRESET_SCHEMA_VERSION, **self._snapshot()}

    def config_put(self, config: dict) -> None:
        if "deviceSets" not in config:
            raise ValueError("config must contain deviceSets")
        self.presets["__config__/incoming"] = {
            "group": "__config__", "name": "incoming", **config
        }
        try:
            self.load_preset("__config__", "incoming")
        finally:
            self.presets.pop("__config__/incoming", None)

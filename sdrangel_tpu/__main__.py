"""CLI — headless pipeline runner (the sdrangelsrv role, file-driven).

Examples:
  # demodulate an NFM channel at +50 kHz from a .sdriq capture to WAV
  python -m sdrangel_tpu demod --in capture.sdriq --log2-decim 2 \
      --channel nfm:50000 --out audio.wav

  # synthetic source end-to-end check (no file needed)
  python -m sdrangel_tpu demod --test-fm 1000 --rate 768000 --log2-decim 4 \
      --channel nfm:0 --out audio.wav

  # inspect a capture
  python -m sdrangel_tpu info --in capture.sdriq
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _parse_channel(spec: str):
    kind, _, rest = spec.partition(":")
    offset = float(rest) if rest else 0.0
    uri = {
        "nfm": "sdrangel.channel.nfmdemod",
        "am": "sdrangel.channel.amdemod",
        "ssb": "sdrangel.channel.ssbdemod",
        "wfm": "sdrangel.channel.wfmdemod",
        "bfm": "sdrangel.channel.bfm",
    }[kind]
    return uri, offset


def cmd_info(args) -> int:
    from .io import sdriq

    info = sdriq.read_header(args.infile)
    print(f"sample_rate:       {info.sample_rate} S/s")
    print(f"center_frequency:  {info.center_frequency} Hz")
    print(f"start_timestamp:   {info.start_timestamp}")
    print(f"sample_size:       {info.sample_size} bit")
    print(f"n_samples:         {info.n_samples} ({info.n_samples/info.sample_rate:.3f} s)")
    return 0


def cmd_demod(args) -> int:
    from .io import sdriq, testsource, wav
    from .runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

    chans = args.channel if isinstance(args.channel, list) else [args.channel]
    parsed = [_parse_channel(c) for c in chans]
    settings = {}
    if args.squelch is not None:
        settings["squelch_db"] = args.squelch

    if args.infile:
        from .io import native

        if native.available():  # C++ loader: memcpy-span wrapped reads
            nf = native.NativeSdriq(args.infile)
            rate = float(nf.sample_rate)
            total = nf.n_samples

            def source(b, count):
                return nf.read_i16(b * count, count)
        else:
            info, mm = sdriq.open_mmap(args.infile)
            rate = float(info.sample_rate)
            total = info.n_samples

            def source(b, count):
                return sdriq.read_block(mm, b * count, count)
    else:
        rate = args.rate
        cfg_src = testsource.TestSourceConfig(
            sample_rate=rate,
            carrier_freq=parsed[0][1],
            modulation="fm" if args.test_fm else ("am" if args.test_am else "none"),
            tone_freq=args.test_fm or args.test_am or 1000.0,
            fm_deviation=5000.0,
            amplitude=0.5,
        )

        def source(b, count):
            c = testsource.generate(cfg_src, count, start_sample=b * count)
            out = np.empty((count, 2), dtype=np.int16)
            out[:, 0] = np.clip(c.real * 32768.0, -32768, 32767)
            out[:, 1] = np.clip(c.imag * 32768.0, -32768, 32767)
            return out

        total = int(args.seconds * rate)

    device = DeviceConfig(
        sample_rate=rate, log2_decim=args.log2_decim, fc_pos=args.fc_pos,
        dc_correction=args.dc_correction, iq_correction=args.iq_correction,
    )
    pipe = RxPipeline(
        device,
        [ChannelSpec(uri, offset, dict(settings)) for uri, offset in parsed],
    )
    n_blocks = max(1, total // pipe.device_block)

    print(
        f"device rate {rate:.0f} S/s /{1 << args.log2_decim} -> baseband "
        f"{device.baseband_rate:.0f} S/s; channel plan: {pipe.plans[0]}",
        file=sys.stderr,
    )
    print(
        f"block {pipe.device_block} device samples, {n_blocks} blocks",
        file=sys.stderr,
    )

    audio_parts = [[] for _ in parsed]
    t0 = time.perf_counter()
    for idx, outs in pipe.run(source, n_blocks):
        for c in range(len(parsed)):
            audio_parts[c].append(outs["channels"][c]["audio"])
    elapsed = time.perf_counter() - t0
    audio = np.concatenate(audio_parts[0], axis=-1)
    wav.write_wav(args.out, audio, int(48000))
    for c in range(1, len(parsed)):  # extra channels: suffixed files
        extra = np.concatenate(audio_parts[c], axis=-1)
        root, ext = args.out.rsplit(".", 1)
        wav.write_wav(f"{root}.ch{c}.{ext}", extra, int(48000))
    processed = n_blocks * pipe.device_block
    print(
        f"processed {processed} samples in {elapsed:.2f}s "
        f"({processed/elapsed/1e6:.1f} MS/s, {processed/rate/elapsed:.1f}x real time); "
        f"wrote {audio.shape[-1]} audio samples to {args.out}",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdrangel_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="inspect a .sdriq capture")
    pi.add_argument("--in", dest="infile", required=True)
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("demod", help="demodulate a channel to WAV")
    pd.add_argument("--in", dest="infile", help=".sdriq input (else synthetic)")
    pd.add_argument("--rate", type=float, default=768000.0, help="synthetic source rate")
    pd.add_argument("--seconds", type=float, default=2.0, help="synthetic duration")
    pd.add_argument("--test-fm", type=float, default=None, metavar="TONE_HZ")
    pd.add_argument("--test-am", type=float, default=None, metavar="TONE_HZ")
    pd.add_argument("--log2-decim", type=int, default=0, choices=range(7))
    pd.add_argument("--fc-pos", default="cen", choices=["cen", "inf", "sup"])
    pd.add_argument("--channel", required=True, action="append",
                    help="kind:offset_hz (nfm|am|ssb|wfm|bfm); repeatable")
    pd.add_argument("--squelch", type=float, default=None, help="squelch dB")
    pd.add_argument("--dc-correction", action="store_true")
    pd.add_argument("--iq-correction", action="store_true")
    pd.add_argument("--out", required=True, help="output WAV path")
    pd.set_defaults(fn=cmd_demod)

    ps = sub.add_parser("server", help="run the REST API server (sdrangelsrv role)")
    ps.add_argument("--api-address", default="127.0.0.1")
    ps.add_argument("--api-port", type=int, default=8091)  # mainparser.cpp default
    ps.add_argument("--api-token", default=None,
                    help="require 'Authorization: Bearer <token>' on every "
                         "request (or set SDRANGEL_TPU_API_TOKEN)")
    ps.set_defaults(fn=cmd_server)

    pt = sub.add_parser("mod", help="modulate to a .sdriq file (Tx slice)")
    pt.add_argument("--channel", required=True, help="kind:offset_hz (nfm|am|ssb|wfm)")
    pt.add_argument("--rate", type=float, default=384000.0, help="DAC sample rate")
    pt.add_argument("--log2-interp", type=int, default=0, choices=range(7))
    pt.add_argument("--tone", type=float, default=1000.0, help="AF tone Hz")
    pt.add_argument("--cw", default=None, metavar="TEXT", help="CW keying text")
    pt.add_argument("--wpm", type=float, default=15.0)
    pt.add_argument("--seconds", type=float, default=2.0)
    pt.add_argument("--out", required=True, help="output .sdriq path")
    pt.set_defaults(fn=cmd_mod)

    args = p.parse_args(argv)
    from . import compile_cache

    compile_cache.configure()
    return args.fn(args)


def cmd_mod(args) -> int:
    from .channels import cwkeyer
    from .io import sdriq
    from .runtime.tx import TxChannelSpec, TxDeviceConfig, TxPipeline

    kind, _, rest = args.channel.partition(":")
    offset = float(rest) if rest else 0.0
    uri = {
        "nfm": "sdrangel.channeltx.modnfm",
        "am": "sdrangel.channeltx.modam",
        "ssb": "sdrangel.channeltx.modssb",
        "wfm": "sdrangel.channeltx.modwfm",
    }[kind]
    device = TxDeviceConfig(sample_rate=args.rate, log2_interp=args.log2_interp)
    pipe = TxPipeline(device, [TxChannelSpec(uri, offset, {})], block_af=4096)

    keyer = None
    if args.cw:
        keyer = cwkeyer.CWKeyer(
            args.cw, cwkeyer.CWConfig(wpm=args.wpm), loop=True
        )

    def af(b, c, count):
        t = (b * count + np.arange(count)) / 48000.0
        tone = np.sin(2 * np.pi * args.tone * t).astype(np.float32)
        if keyer is not None:
            tone = tone * keyer.next_block(count)
        return tone

    n_blocks = max(1, int(args.seconds * 48000.0) // 4096)
    parts = list(pipe.run(af, n_blocks))
    raw = np.concatenate(parts, axis=0)
    sdriq.write(args.out, raw, sample_rate=int(args.rate))
    print(
        f"wrote {len(raw)} samples ({len(raw)/args.rate:.2f}s at {args.rate:.0f} S/s) "
        f"to {args.out}", file=sys.stderr,
    )
    return 0


def cmd_server(args) -> int:
    import logging

    from .api.server import serve_forever

    logging.basicConfig(level=logging.INFO)
    serve_forever(args.api_address, args.api_port, args.api_token)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel-gear benchmark on one GPU.

Workload (BASELINE.md headline): IQ samples/s through the
decimate(÷64) → channelize → NFM-demod chain, one card, 16-channel bank.
Baseline: single-core C++ half-band cascade with the reference's exact
fixed-point arithmetic (native/ref_cpu_bench.cc ≙ sdrangelbench decimateii),
built and measured on the host that runs the bench, cached in the
(gitignored) BASELINE_LOCAL.json.

Prints the card (`nvidia-smi` name and power limit) on stderr and ONE JSON
line on stdout:
  {"metric": ..., "value": N, "unit": "MS/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, ...}
Exits non-zero when JAX finds no GPU.
"""

import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def _cpu_baseline_ksps() -> float:
    cache = os.path.join(REPO, "BASELINE_LOCAL.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["ksps"]
    src = os.path.join(REPO, "native", "ref_cpu_bench.cc")
    exe = os.path.join(REPO, "native", "ref_cpu_bench")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-o", exe, src], check=True, capture_output=True
    )
    best = None
    for _ in range(5):  # best-of-5: the honest single-core capability
        out = subprocess.run(
            [exe, "1048576", "10"], check=True, capture_output=True, text=True
        )
        r = json.loads(out.stdout)
        if best is None or r["ksps"] > best["ksps"]:
            best = r
    result = best
    with open(cache, "w") as f:
        json.dump(result, f)
    return result["ksps"]


def gpu_card() -> str:
    """The card as `nvidia-smi` names it: "<name>, <power limit>"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def require_gpu(platform: str = "gpu"):
    """The JAX devices, which must be of `platform`; raises RuntimeError
    otherwise (a measurement never falls back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != platform:
        raise RuntimeError(
            f"no {platform.upper()}: JAX reports {devices[0].platform} "
            f"devices {devices}")
    return devices


def device_record(devices) -> dict:
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def _measure_and_report(run_pass, block: int, iters: int, metric: str,
                        baseline_ksps: float, devices, compile_s: float,
                        bytes_per_sample: float = 4.0) -> int:
    """Shared measurement policy for every gear: warm up by step count
    (sharded gears re-jit once on their output shardings at the second
    call), then the MEDIAN of 15 passes of `iters` chained steps, each
    pass ending in block_until_ready. Compile + first step is set-up."""
    for _ in range(3):
        run_pass(10)
    rates = []
    for _ in range(15):
        t0 = time.perf_counter()
        run_pass(iters)
        elapsed = time.perf_counter() - t0
        rates.append(block * iters / elapsed / 1e6)
    print("# pass GS/s: " + " ".join(f"{r / 1e3:.1f}" for r in rates),
          file=sys.stderr)
    msps = float(np.median(rates))
    record = {
        "metric": metric,
        "value": round(msps, 1),
        "unit": "MS/s",
        "vs_baseline": round(msps * 1e3 / baseline_ksps, 2),
        "device": device_record(devices),
        "bytes_per_step": int(block * bytes_per_sample),
        "compile_first_step_s": round(compile_s, 1),
    }
    print(json.dumps(record))
    return 0


def _sharded_bench(args, baseline_ksps: float, devices) -> int:
    """-t chainsharded / chain64a2a: the chainpfb / chain64 workloads run
    through parallel/sharded.py's shard_map gears on a 1x1 mesh — the
    multi-device code path (halo ppermute, frame-sharded analysis,
    all_gather / all_to_all) executing on one card with degenerate
    collectives. Reference analog: the per-channel thread fan-out IS the
    reference's scaling mechanism (threadedbasebandsamplesink.h:53-77)."""
    import jax.numpy as jnp

    from sdrangel_tpu.parallel import sharded as shmod

    a2a = args.test == "chain64a2a"
    device_rate = 12_288_000.0
    if a2a:
        log2, pfb_m, n_channels = 0, 256, 64
    else:
        log2, pfb_m, n_channels = 6, 4, 16
    block = args.nb_samples or (
        1 << int(os.environ.get("SDRANGEL_BENCH_LOG2BLOCK", "25")))
    assert (block >> log2) % pfb_m == 0
    cfg = shmod.ShardedPipelineConfig(
        n_time=1, n_channel=1, device_rate=device_rate, log2_decim=log2,
        block=block, pfb_m=pfb_m, pfb_all_to_all=a2a,
        bank=(shmod.BankGroup(shmod.NFM_URI, n_channels,
                              {"squelch_db": -100.0,
                               "squelch_gate_ms": 1.0}),),
    )
    mesh = shmod.make_mesh(1, 1)
    step, init_fn = shmod.build_sharded_step(cfg, mesh)
    assert not getattr(step, "replicated_analysis", False)

    baseband = device_rate / (1 << log2)
    grid = baseband / pfb_m
    if a2a:
        # the chain64 flagship band: 64 x 48 kHz slots around DC with
        # distinct jitters absorbed by the demod NCOs
        slots = np.array([c if c < 32 else c - 64 for c in range(64)])
        offs = slots * grid + np.linspace(-4000.0, 4000.0, 64)
        orders, local_idx, residuals = shmod.a2a_placement(cfg, (offs,))
        res_t = jnp.asarray(residuals[0])
        idx_t = jnp.asarray(local_idx[0])
    else:
        # chainpfb's 16 demods: 4 per grid channel, distinct jitters
        leaf = baseband / 8.0
        jit4 = (-0.18 * leaf, -0.06 * leaf, 0.06 * leaf, 0.18 * leaf)
        offs = np.array([(k % 4 - 1.5) * grid * 2 + jit4[k // 4]
                         for k in range(16)])
        idx, res = shmod.grid_split(cfg, offs)
        res_t = jnp.asarray(res)
        idx_t = jnp.asarray(idx)

    rng = np.random.default_rng(7)
    raw = jnp.asarray(rng.integers(-2048, 2048, size=(block, 2), dtype=np.int16))
    state, carry = init_fn()

    holder = {"state": state, "carry": carry}

    def run_pass(n):
        state, carry = holder["state"], holder["carry"]
        for _ in range(n):
            state, audio, carry = step(state, raw, carry, res_t, idx_t)
        holder["state"], holder["carry"] = state, carry
        audio.block_until_ready()

    t0 = time.perf_counter()
    run_pass(1)
    compile_s = time.perf_counter() - t0
    print(f"# compile+first-step: {compile_s:.1f}s", file=sys.stderr)
    gear = "a2a(all_to_all)" if a2a else "all_gather"
    metric = (f"sharded-{gear} " +
              (f"pfb{pfb_m}-grid+NFM{n_channels}" if log2 == 0 else
               f"decimate{1 << log2}+pfb{pfb_m}+NFM{n_channels}") +
              " input throughput per card (1x1 mesh)")
    return _measure_and_report(run_pass, block, args.repeat, metric,
                               baseline_ksps, devices, compile_s)


class ChainGear(NamedTuple):
    """One single-device kernel gear: a carried-state jitted step."""

    step: Callable  # jitted (casc, cstate, dstate, raw) -> (..., audio)
    init: Callable  # () -> (casc, cstate, dstate) on the default device
    device_rate: float
    float_in: bool  # raw is f32 (block, 2) instead of int16
    #: device-rate frequencies (Hz) of one FM carrier per distinct channel
    #: the bank tunes to — what chip_smoke.py synthesises to check the
    #: gear's audio; None for the decimate-only gears
    carrier_hz: np.ndarray | None
    metric: str


def make_chain_gear(test: str = "chainpfb", block: int = 1 << 25,
                    log2_factor: int = 6) -> ChainGear:
    """Build a single-device gear of bench.py's `-t` menu (see main's help):
    chainpfb (default), chain, chain64 and the decimate* cascades."""
    import jax
    import jax.numpy as jnp

    from sdrangel_tpu.channels import demod_nfm
    from sdrangel_tpu.dsp import channelizer as chanmod
    from sdrangel_tpu.dsp import decimators as dec
    from sdrangel_tpu.dsp import pfb as pfbmod

    n_channels = 16
    log2 = log2_factor
    fc_pos = {"decimateinfii": "inf", "decimatesupii": "sup"}.get(test, "cen")
    decim_only = test not in ("chain", "chainpfb", "chain64")
    use_pfb = test in ("chainpfb", "chain64")
    chain64_mode = os.environ.get("SDRANGEL_CHAIN64", "pfb256")
    assert chain64_mode in ("pfb256", "dec4"), (
        f"SDRANGEL_CHAIN64={chain64_mode!r}: valid values are pfb256|dec4")
    if test == "chain64":
        # flagship wideband bank. Two formulations, A/B via SDRANGEL_CHAIN64:
        #   pfb256 — ONE PFB-256 pass at the device rate: the polyphase
        #            bank IS the decimator (noble identity), critically
        #            sampling the 12.288 MHz span into 256 x 48 kHz grid
        #            channels; the 64 channels of the flagship band
        #            (+-1.536 MHz around DC) feed the batched NFM-64 tail.
        #   dec4   — layout-native flat /4 cascade (decimate_flat_iq: no
        #            transposes, int16 ingest fused into the conv) then a
        #            PFB-64 over the 3.072 MHz baseband keeping ALL 64
        #            channels (no select): the FFT works on a quarter of
        #            the PFB-256 traffic.
        # Channel selectivity in both is the 12-taps/branch prototype
        # (-90 dB adjacent, test_pfb).
        log2 = 2 if chain64_mode == "dec4" else 0
        n_channels = 64
    # validate block AFTER chain64 resolves its effective log2/pfb_m
    assert block % (4 << log2) == 0, (
        f"nb-samples must be a multiple of {4 << log2} (4*2^{log2})")
    float_in = test in ("decimatefi", "decimateff")
    float_out = test in ("decimateif", "decimateff")
    device_rate = 12_288_000.0
    baseband_rate = device_rate / (1 << log2)  # 192 kHz at /64

    # The benched chain IS the labeled chain: after the device cascade,
    # each of the 16 channels runs its own DownChannelizer stage plan
    # (order-48 HB tree, downchannelizer.cpp:250-287) selecting a DISTINCT
    # offset in the baseband, then NFM demod at the channel rate with the
    # residual offset on the NCO.
    # 16 distinct offsets: 4 depth-2 leaf centres (±bb/8, ±3bb/8) × 4
    # in-leaf jitters; a 32 kHz requested band keeps every plan at uniform
    # depth 2 (channel rate bb/4) so the bank stays one vmapped program,
    # while the NCO absorbs the distinct residuals.
    req_band = baseband_rate / 6.0
    leaf = baseband_rate / 8.0
    carrier_hz = None
    pfb_m = 0
    signs = None
    if use_pfb:
        # chainpfb: same 16-demod workload on the M=4 uniform grid — the
        # polyphase DFT bank (dsp/pfb.py) replaces the per-channel HB
        # trees; channel rate (bb/4) and demod cost match `chain`, the
        # NCO absorbs distinct jitters per demod.
        # chain64: M=256 — ONE analysis pass pulls all 256 x 48 kHz grid
        # channels from the 12.288 MHz input, one NFM demod per channel of
        # the flagship band.
        pfb_m = (256 if chain64_mode != "dec4" else 64) \
            if test == "chain64" else 4
        assert (block >> log2) % pfb_m == 0, (
            f"nb-samples must give a baseband multiple of the PFB frame "
            f"(block/{1 << log2} % {pfb_m} != 0)")
        pfb_reps = max(n_channels // pfb_m, 1)  # demods per grid channel
        grid = baseband_rate / pfb_m
        if test == "chain64":
            # the n_channels grid slots of the +-1.536 MHz flagship band
            # (two contiguous runs around DC), distinct small jitters
            # absorbed by each demod's NCO. dec4 keeps every channel of
            # the PFB-64 (the whole grid IS the band, no select needed).
            select_band = pfb_m != n_channels
            residual = np.linspace(-4000.0, 4000.0, n_channels).astype(np.float32)
            slots = np.arange(n_channels) - n_channels // 2
            carrier_hz = slots * grid + residual
        else:  # chainpfb: the chain's 4 distinct jitters per leaf
            select_band = False
            jitters = (-0.18 * leaf, -0.06 * leaf, 0.06 * leaf, 0.18 * leaf)
            residual = np.asarray(
                [jitters[i % pfb_reps] for i in range(n_channels)], np.float32)
            slots = np.arange(pfb_m)
            carrier_hz = np.where(slots < pfb_m // 2, slots,
                                  slots - pfb_m) * grid
        chan_rate = grid
        n_stages = int(np.log2(pfb_m))  # PFB decimation depth (block math)
    else:
        offsets = np.array([
            c + j
            for c in (-3 * leaf, -leaf, leaf, 3 * leaf)
            for j in (-0.18 * leaf, -0.06 * leaf, 0.06 * leaf, 0.18 * leaf)
        ])
        plans = [chanmod.plan_channel(baseband_rate, req_band, o) for o in offsets]
        n_stages = len(plans[0].signs)
        assert all(len(p.signs) == n_stages for p in plans), [p.signs for p in plans]
        signs = np.array([p.signs for p in plans])  # (C, n_stages)
        residual = np.asarray([p.residual_offset for p in plans], np.float32)
        chan_rate = plans[0].channel_rate

    demod_cfg = demod_nfm.NFMConfig(
        channel_rate=chan_rate,
        block_in=(block >> log2) >> n_stages,
        squelch_db=-100.0,
        squelch_gate_ms=1.0,
    )

    # The flat composed-filter polyphase conv (dsp/decimators.py
    # decimate_flat) is the default: one pass over the input at ~3.7× the
    # staged cascade's MACs. SDRANGEL_BENCH_FLAT=0 reverts to the 6-conv
    # staged cascade for A/B.
    flat = bool(int(os.environ.get("SDRANGEL_BENCH_FLAT", "1")))

    chain64_iq = test == "chain64" and chain64_mode == "dec4"

    def step(casc, cstate, dstate, raw):
        if chain64_iq:
            # layout-native path: int16 (T, 2) -> f32 scale fuses into the
            # NWC conv read; complex only materializes at the /4 rate
            xf = raw.astype(jnp.float32) * (1.0 / 32768.0)
            casc, bb_iq = dec.decimate_flat_iq(casc, xf, log2)
            bb = (bb_iq[..., 0] + 1j * bb_iq[..., 1]).astype(jnp.complex64)
        else:
            if float_in:  # decimatefi/ff: float cascade input (mainbench.cpp:140+)
                x = (raw[..., 0] + 1j * raw[..., 1]).astype(jnp.complex64)
            else:
                x = raw.astype(jnp.float32) * (1.0 / 32768.0)
                x = (x[..., 0] + 1j * x[..., 1]).astype(jnp.complex64)
            if log2 == 0:
                bb = x  # chain64/pfb256: the PFB itself is the decimator
            elif flat:
                casc, bb = dec.decimate_flat_any(casc, x, log2, fc_pos)
            else:
                casc, bb = dec.decimate_cascade(casc, x, log2, fc_pos)
        if decim_only:  # decimate* tests: cascade only, like sdrangelbench
            y = jnp.stack([jnp.real(bb), jnp.imag(bb)])
            if not float_out:  # ii/fi emit int16 Samples (decimators.h)
                y = jnp.clip(jnp.round(y * 32768.0), -32768, 32767).astype(jnp.int16)
            return casc, cstate, dstate, y
        if use_pfb:
            cstate, yall = pfbmod.analyze(cstate, bb, pfb_m)  # (F, M)
            if select_band:
                # the ±32-around-DC band is two contiguous runs of the FFT
                # output ([M-32:M] then [0:64-32]) — slice+concat, no gather
                half = n_channels // 2
                y = jnp.concatenate(
                    [yall[..., pfb_m - half:], yall[..., :half]], axis=-1)
                y = jnp.moveaxis(y, -1, 0)
            else:
                y = (jnp.repeat(yall.T, pfb_reps, axis=0)
                     if pfb_reps > 1 else yall.T)  # (n_channels, F)
        else:
            # dedup by stage path: identical sign paths share one cascade
            # run (the reference's per-channel trees share every prefix)
            cstate, y = chanmod.channelize_bank_unique(cstate, bb, signs)
        dstate, audio = demod_nfm.process(dstate, y, demod_cfg, offset_hz=residual)
        return casc, cstate, dstate, audio

    def init():
        casc = (dec.init_flat_iq_state(log2) if chain64_iq
                else (dec.init_flat_state(log2) if flat else dec.init_state(log2)))
        if use_pfb:
            cstate = pfbmod.make_state(pfb_m)
        else:
            cstate = chanmod.init_state(
                n_stages, batch_shape=(chanmod.unique_paths(signs),))
        dstate = demod_nfm.make_state(demod_cfg, batch_shape=(n_channels,))
        return casc, cstate, dstate

    metric = (
        (f"pfb{pfb_m}-grid+NFM{n_channels} input throughput per card"
         if log2 == 0 else
         f"decimate{1 << log2}+pfb{pfb_m}+NFM{n_channels} "
         "input throughput per card")
        if use_pfb else
        f"decimate64+channelizer({n_stages}HBx16ch,distinct offsets)"
        "+NFM16 input throughput per card"
        if not decim_only else
        f"{test} /{1 << log2} input throughput per card"
    )
    return ChainGear(jax.jit(step), jax.jit(init), device_rate, float_in,
                     carrier_hz, metric)


def main() -> int:
    # CLI mirrors the reference's ParserBench flags (sdrbench/parserbench.cpp:
    # 24-113: --test/--nb-samples/--repeat/--log2-factor).
    import argparse

    ap = argparse.ArgumentParser(description="sdrangel_tpu bench (sdrangelbench role)")
    ap.add_argument("-t", "--test", default="chainpfb",
                    choices=["chain", "chainpfb", "chain64", "chainsharded",
                             "chain64a2a", "decimateii",
                             "decimateinfii", "decimatesupii", "decimateif",
                             "decimatefi", "decimateff"],
                    help="chainpfb (default) = decimate + polyphase DFT "
                         "bank + NFM16 at 16 distinct offsets (dsp/pfb.py); "
                         "chain = same workload on the per-channel HB-tree "
                         "channelizer; chain64 = the 64-channel flagship: "
                         "ONE PFB-256 pass at device rate feeding 64 NFM "
                         "demods at 48 kHz each (SDRANGEL_CHAIN64=dec4 for "
                         "the /4-cascade+PFB-64 A/B form); decimate* "
                         "= cascade only: ii/infii/supii are the int16->"
                         "int16 placements, if/fi/ff the float-path dtype "
                         "matrix (mainbench.cpp:112-191); chainsharded / "
                         "chain64a2a = the chainpfb / chain64 workloads "
                         "executed through parallel/sharded.py's "
                         "shard_map gears on a 1x1 mesh")
    ap.add_argument("-n", "--nb-samples", type=int, default=0,
                    help="device samples per step (default: 2^SDRANGEL_BENCH_LOG2BLOCK)")
    ap.add_argument("-r", "--repeat", type=int, default=30, help="steps per pass")
    ap.add_argument("-l", "--log2-factor", type=int, default=6, choices=range(1, 7))
    args = ap.parse_args()

    from sdrangel_tpu import compile_cache

    compile_cache.configure()
    devices = require_gpu()
    print(f"# card: {gpu_card()}", file=sys.stderr)
    baseline_ksps = _cpu_baseline_ksps()

    if args.test in ("chainsharded", "chain64a2a"):
        return _sharded_bench(args, baseline_ksps, devices)

    import jax.numpy as jnp

    # 2^25 device samples per step by default; SDRANGEL_BENCH_LOG2BLOCK
    # overrides for sweeps
    block = args.nb_samples or (
        1 << int(os.environ.get("SDRANGEL_BENCH_LOG2BLOCK", "25")))
    gear = make_chain_gear(args.test, block, args.log2_factor)

    rng = np.random.default_rng(7)
    if gear.float_in:
        raw = jnp.asarray(
            (rng.integers(-2048, 2048, size=(block, 2)) / 32768.0).astype(np.float32)
        )
    else:
        raw = jnp.asarray(rng.integers(-2048, 2048, size=(block, 2), dtype=np.int16))

    holder = {"s": gear.init()}

    def run_pass(n):
        casc, cstate, dstate = holder["s"]
        audio = None
        for _ in range(n):
            casc, cstate, dstate, audio = gear.step(casc, cstate, dstate, raw)
        holder["s"] = (casc, cstate, dstate)
        audio.block_until_ready()

    t0 = time.perf_counter()
    run_pass(1)
    compile_s = time.perf_counter() - t0
    print(f"# compile+first-step: {compile_s:.1f}s", file=sys.stderr)
    return _measure_and_report(
        run_pass, block, args.repeat, gear.metric, baseline_ksps, devices,
        compile_s, bytes_per_sample=8.0 if gear.float_in else 4.0)


if __name__ == "__main__":
    sys.exit(main())

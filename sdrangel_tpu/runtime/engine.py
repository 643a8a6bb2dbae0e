"""Rx pipeline engine — the DSPDeviceSourceEngine equivalent.

Reference architecture (SURVEY.md §3.2): device thread reads the FIFO,
applies corrections, fans out to per-channel threads, each running
channelizer→demod→audio FIFO. Re-architecture: the whole per-block graph
— int16 ingest, DC/IQ corrections, device decimation cascade, the channel
bank (channelizer stages + demods vmap-style), audio conversion — is ONE
jitted step function; the host loop double-buffers blocks from a memory-map
into the device and drains audio asynchronously. Thread+FIFO pipeline
parallelism becomes jax async dispatch: the host enqueues step N+1 while the
device runs step N. Device→host transfers carry float32/int16 only; complex
values leave the device as projections or [re, im] pairs.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..channels.registry import REGISTRY
from ..dsp import channelizer as chan
from ..dsp import decimators as dec
from ..dsp import spectrum as dsp_spectrum
from . import corrections

#: Largest device block (input samples per step) the block solver accepts.
#: A step holds a few float32 copies of its block: the int16 input, the
#: f32 [re, im] lanes of the flat conv (a pure reshape), the corrections'
#: output; the channel bank works at baseband, 2^k times smaller. On an
#: H100 the 10 MS/s ÷64 four-demod session peaked at 0.82 GiB of device
#: memory with a 40,960,000-sample block (about 21 bytes per sample), so
#: 2^28 samples stay near 6 GiB, while the block's f32 planes
#: (2·2^28 elements) stay inside 32-bit indexing. The bound only refuses
#: plans whose rational rate factors blow the block up; it does not set
#: the block, which is the smallest that satisfies every channel.
MAX_DEVICE_BLOCK = 1 << 28


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceConfig:
    """File/synthetic device front end (the filesource/testsource role)."""

    sample_rate: float  # device (pre-decimation) rate
    center_frequency: float = 0.0
    log2_decim: int = 0  # device decimation (decimators.h cascades)
    fc_pos: str = "cen"  # cen | inf | sup (devicesamplesource.cpp:84-110)
    dc_correction: bool = False
    iq_correction: bool = False
    input_format: str = "i16"  # i16 | u8 | i8 | i12 | i24 (ADC width policy)

    @property
    def baseband_rate(self) -> float:
        return self.sample_rate / (1 << self.log2_decim)


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelSpec:
    """One channel attached to the device set."""

    uri: str  # registry key, e.g. "sdrangel.channel.nfmdemod"
    frequency_offset: float  # channel centre relative to baseband centre
    settings: dict  # demod settings overrides (config dataclass fields)
    requested_rate: float = 48000.0  # bandwidth the demod wants from the channelizer


class RxPipeline:
    """Builds and runs the fused per-block step function."""

    def __init__(
        self,
        device: DeviceConfig,
        channels: list[ChannelSpec],
        block_size: int | None = None,
        spectrum_cfg: "dsp_spectrum.SpectrumConfig | None" = None,
    ):
        self.device = device
        self.channel_specs = channels

        # Per-channel frequency plans (downchannelizer.cpp:250-287).
        self.plans = [
            chan.plan_channel(device.baseband_rate, c.requested_rate, c.frequency_offset)
            for c in channels
        ]

        # Demod configs bound to the achieved channel rates/offsets.
        self.kinds = [REGISTRY[c.uri] for c in channels]
        self.base_block = self._solve_block_size(block_size)
        self.demod_cfgs = []
        import dataclasses as _dc

        for spec, plan, kind in zip(channels, self.plans, self.kinds):
            n_stages = len(plan.signs)
            kwargs = dict(
                channel_rate=plan.channel_rate,
                input_offset=plan.residual_offset,
                **spec.settings,
            )
            # data channels without block-coupled resamplers don't take it
            if any(f.name == "block_in" for f in _dc.fields(kind.config_cls)):
                kwargs["block_in"] = self.base_block >> n_stages
            cfg = kind.config_cls(**kwargs)
            self.demod_cfgs.append(cfg)

        # device-level spectrum tap (the SpectrumVis direct-sink role);
        # configurable like SpectrumVis's fft size / averaging mode
        self.spectrum_cfg = spectrum_cfg or dsp_spectrum.SpectrumConfig(
            fft_size=1024, averaging_mode="moving", averaging_n=8
        )
        self._step = jax.jit(self._step_impl)
        self._step_packed = jax.jit(self._step_packed_impl)
        self._cat = jax.jit(lambda *xs: jnp.concatenate(xs))
        self._out_layout = None  # (treedef, [(shape, dtype)]) lazily built

    # -- block-size solving ------------------------------------------------

    def _solve_block_size(self, requested: int | None) -> int:
        """Baseband block length satisfying every stage's divisibility needs:
        ×4 for rotation patterns, ×2^stages for each channel's cascade, the
        resampler's rational numerator, and fftfilt hop sizes."""
        need = 4 << self.device.log2_decim
        for spec, plan, kind in zip(self.channel_specs, self.plans, self.kinds):
            k = len(plan.signs)
            frac = Fraction(plan.channel_rate / 48000.0).limit_denominator(1 << 20)
            p = frac.numerator
            need = math.lcm(need, 4 << k)
            if kind.needs_audio_ratio:
                need = math.lcm(need, p << k)
            if kind.needs_fft_hop:
                # the fftfilt may run at channel rate (WFM) or audio rate
                # (SSB/BFM): constrain the hop (fft_len/2) to divide both
                hop = 512
                need = math.lcm(need, hop << k)
                if kind.needs_audio_ratio:
                    audio_need = p * hop // math.gcd(frac.denominator, hop)
                    need = math.lcm(need, audio_need << k)
            if kind.block_factor is not None:
                need = math.lcm(
                    need, kind.block_factor(plan.channel_rate, spec.settings) << k
                )
        block = need
        target = requested or (1 << 17)
        while block < target:
            block *= 2
        if (block << self.device.log2_decim) > MAX_DEVICE_BLOCK:
            raise ValueError(
                f"block of {block << self.device.log2_decim} device samples "
                f"needed to satisfy rate divisibility — pick rates with "
                f"smaller rational factors vs 48 kHz (plans: {self.plans})"
            )
        return block

    # -- the fused step ----------------------------------------------------

    def init_state(self) -> dict:
        """All carried states, built in one jitted call (one dispatch)."""
        return jax.jit(self._init_state_impl)()

    def _init_state_impl(self) -> dict:
        state: dict[str, Any] = {
            "corr": corrections.make_state(),
            "spectrum": dsp_spectrum.make_state(self.spectrum_cfg),
            "dev_casc": (
                dec.init_flat_state(self.device.log2_decim)
                if self.device.log2_decim
                else dec.init_state(self.device.log2_decim)
            ),
            "chan": [
                chan.init_state(len(plan.signs)) for plan in self.plans
            ],
            "demod": [
                kind.make_state(cfg)
                for kind, cfg in zip(self.kinds, self.demod_cfgs)
            ],
        }
        return state

    def default_dyn(self) -> list[dict]:
        """Per-channel dynamic-parameter dicts initialized from the bound
        configs. The session recomputes these every block from the live
        settings and passes them as traced args, so PATCHing a dynamic knob
        (offset/squelch/volume) takes effect without recompiling — the
        applySettings-on-running-channel semantics (nfmdemod.cpp
        handleMessage → applySettings)."""
        dyn = []
        for kind, cfg in zip(self.kinds, self.demod_cfgs):
            d = {}
            if "offset_hz" in kind.dynamic_fields:
                d["offset_hz"] = float(cfg.input_offset)
            if "squelch_db" in kind.dynamic_fields:
                d["squelch_db"] = float(cfg.squelch_db)
            if "volume" in kind.dynamic_fields:
                d["volume"] = float(cfg.volume)
            dyn.append(d)
        return dyn

    def _step_impl(self, state: dict, raw_iq: jnp.ndarray, dyn=None):
        """raw_iq: (T_dev, 2) raw ADC samples at device rate. dyn: optional
        per-channel dict list of traced overrides (see default_dyn). Returns
        (state', outs) where outs maps channel index -> audio + meters."""
        from ..dsp.types import iq_raw_to_complex64

        x = iq_raw_to_complex64(raw_iq, self.device.input_format)

        corr_state, x = corrections.apply(
            state["corr"], x, self.device.dc_correction, self.device.iq_correction
        )

        if self.device.log2_decim:
            # flat composed-filter form: one pass over the input in device
            # memory; inf/sup fold the per-stage rotations into an input
            # modulation + complex legs (decimate_flat_any)
            dev_state, bb = dec.decimate_flat_any(
                state["dev_casc"], x, self.device.log2_decim, self.device.fc_pos
            )
        else:
            dev_state, bb = dec.decimate_cascade(
                state["dev_casc"], x, self.device.log2_decim, self.device.fc_pos
            )

        chan_states, demod_states, outs = [], [], []
        for i, (plan, kind, cfg) in enumerate(
            zip(self.plans, self.kinds, self.demod_cfgs)
        ):
            cstate, y = chan.channelize(state["chan"][i], bb, plan)
            d = dict(dyn[i]) if dyn is not None else {}
            dstate, result = kind.process(state["demod"][i], y, cfg, **d)
            # channel power meter (the report's channelPowerDB source —
            # magsq average as in nfmdemod.h:153-170 getters)
            power = jnp.mean(jnp.real(y) ** 2 + jnp.imag(y) ** 2)
            chan_states.append(cstate)
            demod_states.append(dstate)
            if kind.output == "audio":
                entry = {"audio": result, "power": power.astype(jnp.float32)}
            else:
                entry = {"data": kind.adapter(result),
                         "power": power.astype(jnp.float32)}
            if kind.meters is not None:
                entry.update(kind.meters(dstate, cfg, d))
            outs.append(entry)

        spec_state, bb_spectrum = dsp_spectrum.power_spectrum(
            state["spectrum"], bb, self.spectrum_cfg
        )
        # scope tap: projected trace of the block head (ScopeVis role;
        # projections computed on device so no complex leaves the chip)
        from ..dsp import scope as dsp_scope

        head = bb[..., :1024]
        scope_traces = jnp.stack([
            dsp_scope.project(head, dsp_scope.Projection.REAL),
            dsp_scope.project(head, dsp_scope.Projection.IMAG),
            dsp_scope.project(head, dsp_scope.Projection.MAG_DB),
        ])

        new_state = {
            "corr": corr_state,
            "dev_casc": dev_state,
            "chan": chan_states,
            "demod": demod_states,
            "spectrum": spec_state,
        }
        return new_state, {
            "channels": outs, "spectrum": bb_spectrum, "scope": scope_traces,
        }

    # -- packed outputs ----------------------------------------------------
    #
    # The per-block publish is ONE device->host fetch, not one per report
    # field: the packed step returns the whole outs tree as a single flat
    # f32 vector; the host splits it back by the static layout. Multiple
    # blocks' vectors can be concatenated on device (self._cat) for one
    # fetch per publish burst. Whether packing pays on the H100 waits on
    # the served-path measurement (ROADMAP Design 4).

    def _step_packed_impl(self, state, raw_iq, dyn=None):
        state, outs = self._step_impl(state, raw_iq, dyn)
        leaves = jax.tree.leaves(outs)
        flat = jnp.concatenate(
            [jnp.ravel(l).astype(jnp.float32) for l in leaves])
        return state, flat

    def _ensure_layout(self, state, dyn):
        if self._out_layout is None:
            _, outs = jax.eval_shape(
                self._step_impl, state,
                jax.ShapeDtypeStruct((self.device_block, 2), jnp.int16), dyn)
            leaves, treedef = jax.tree.flatten(outs)
            self._out_layout = (treedef,
                                [(l.shape, l.dtype) for l in leaves])
        return self._out_layout

    def unpack_outs(self, flat: np.ndarray) -> dict:
        """Rebuild the outs tree from one packed f32 vector (host side)."""
        treedef, specs = self._out_layout
        leaves, pos = [], 0
        for shape, dtype in specs:
            n = int(np.prod(shape)) if shape else 1
            leaf = flat[pos:pos + n].reshape(shape)
            if np.issubdtype(dtype, np.bool_):
                leaf = leaf != 0.0
            elif not np.issubdtype(dtype, np.floating):
                leaf = leaf.astype(dtype)
            pos += n
            leaves.append(leaf)
        return jax.tree.unflatten(treedef, leaves)

    # -- host loop ---------------------------------------------------------

    @property
    def device_block(self) -> int:
        return self.base_block << self.device.log2_decim

    def run(self, iq_source, n_blocks: int, state: dict | None = None):
        """Drive the pipeline.

        iq_source: callable (block_index, count) -> (count, 2) int16 array.
        Yields (block_index, [audio arrays]) with audio as np.float32 —
        jax async dispatch overlaps host reads with device compute.
        """
        state = state or self.init_state()

        def to_host(outs):
            host = []
            for o in outs["channels"]:
                h = {"power": float(o["power"])}
                if "audio" in o:
                    h["audio"] = np.asarray(o["audio"])
                else:
                    h["data"] = {k: np.asarray(v) for k, v in o["data"].items()}
                host.append(h)
            return {
                "channels": host,
                "spectrum": np.asarray(outs["spectrum"]),
                "scope": np.asarray(outs["scope"]),
            }

        pending = []  # (idx, device arrays) — drain one behind for overlap
        for b in range(n_blocks):
            raw = iq_source(b, self.device_block)
            state, outs = self._step(state, jnp.asarray(raw))
            pending.append((b, outs))
            if len(pending) > 1:
                idx, outs_prev = pending.pop(0)
                yield idx, to_host(outs_prev)
        for idx, outs_prev in pending:
            yield idx, to_host(outs_prev)
        self.final_state = state

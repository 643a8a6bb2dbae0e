"""Mesh-sharded pipeline: time-sharded decimation with halo exchange +
channel-sharded demod bank.

This is the mesh replacement for the reference's two concurrency axes
(SURVEY.md §2.6): per-channel threads (threadedbasebandsamplesink.h) become
the mesh "channel" axis; the unbounded sample stream (filter-state streaming,
SURVEY §5 long-context analog) is sharded over the mesh "time" axis with the
filter-history overlap exchanged between neighbor shards via lax.ppermute —
structurally ring-attention's halo exchange.

The demod bank is heterogeneous (the per-channel heterogeneity of
threadedbasebandsamplesink.h:24-77): the bank is a sequence of BankGroups,
each (channel kind × count × settings); every registry audio kind that
threads offset_hz as a traced arg (NFM/AM/SSB/WFM/BFM) can run sharded.
SPMD holds because every device in the channel axis runs the same per-group
programs on its local slice of each group.

Streaming correctness across blocks: the ppermute ring hands each shard the
tail of its left neighbor; the wrap-around tail received by shard 0 is the
block's global tail, which the host feeds back as the carry for the next
block, so the seam between blocks is exact (verified in
tests/test_sharding.py against the single-device pipeline).
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax._src.lax.parallel import all_gather_invariant as _all_gather_inv
from jax.sharding import Mesh, PartitionSpec as P

from ..channels.registry import REGISTRY
from ..dsp import channelizer as chan
from ..dsp import decimators as dec
from ..dsp import pfb as pfbmod
from ..dsp.precision import PRECISION
from ..dsp.hbfilter import DECIMATORS_ORDER

NFM_URI = "sdrangel.channel.nfmdemod"

_log = logging.getLogger(__name__)

# _all_gather_inv is the Varying -> Invariant all_gather: the gathered result
# is identical on every shard of the gathered axis and the VMA system KNOWS
# it, which is what lets check_vma=True verify the all_gather gear's
# replicated per-channel outputs. JAX 0.9.0 keeps it in the private
# parallel module.


def make_mesh(n_time: int, n_channel: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < n_time * n_channel:
        raise ValueError(
            f"need {n_time * n_channel} devices, have {devices.size}"
        )
    grid = devices[: n_time * n_channel].reshape(n_time, n_channel)
    return Mesh(grid, ("time", "channel"))


def halo_samples(log2_decim: int, order: int = DECIMATORS_ORDER) -> int:
    """Input-rate halo H covering the whole cascade's filter history:
    the exact need is (L-1)(2^k - 1) with L = order-1 taps; rounded up to a
    multiple of 4·2^k so rotation patterns and stage strides stay aligned."""
    if log2_decim == 0:
        return 0
    l_taps = order - 1
    need = (l_taps - 1) * ((1 << log2_decim) - 1)
    align = 4 << log2_decim
    return ((need + align - 1) // align + 1) * align


def _cascade_with_halo(x_ext: jnp.ndarray, log2: int, fc_pos: str, halo: int) -> jnp.ndarray:
    """Streaming cascade over the local shard with the halo INJECTED as the
    carried tail (the flat history r·(t_leg−1) ≤ halo): the conv runs on
    the bare power-of-two local length, the shape the single-device gear
    compiles, instead of the halo-extended [halo | local] shape.

    Cross-shard phase correctness of the inf/sup rotation patterns requires
    the local shard length to be a multiple of 4·2^k (the halo is aligned
    by construction), so the fresh state's rotation phase 0 is the correct
    global phase at every shard boundary."""
    if x_ext.shape[-1] % (4 << log2):
        raise ValueError(
            f"local shard length {x_ext.shape[-1] - halo} (+halo {halo}) must "
            f"be a multiple of {4 << log2} (=4·2^log2_decim) for rotation "
            f"phase alignment across shards"
        )
    state = dec.init_flat_state(log2, batch_shape=x_ext.shape[:-1])
    tail_len = state.tail.shape[-1]
    if tail_len > halo:
        raise ValueError(f"halo {halo} shorter than flat tail {tail_len}")
    tail = x_ext[..., halo - tail_len:halo]
    if fc_pos != "cen":
        # the flat inf/sup state stores the tail MODULATED by the rotation
        # pattern (decimators.decimate_flat_any); the injected halo tail
        # sits at global positions [-tail_len, 0) relative to the aligned
        # local block start (pattern phase 0 there)
        _, pattern = dec.flat_rotated(log2, fc_pos)
        period = len(pattern)
        idx = (np.arange(-tail_len, 0)) % period
        tail = tail * jnp.asarray(np.asarray(pattern)[idx])
    state = dec.FlatState(tail)
    _, y = dec.decimate_flat_any(state, x_ext[..., halo:], log2, fc_pos)
    return y


@dataclasses.dataclass(frozen=True, eq=False)
class BankGroup:
    """One homogeneous slice of the sharded demod bank."""

    uri: str
    count: int  # channels of this kind (multiple of the mesh channel axis)
    settings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPipelineConfig:
    """Time×channel sharded demod bank — the flagship multi-chip
    configuration ("64-channel sharded channelizer bank",
    BASELINE.json configs[4]). Default bank: n_channels NFM demods."""

    n_time: int
    n_channel: int
    device_rate: float = 12_288_000.0  # /64 -> 192 kHz baseband (integer ratio to 48k audio)
    log2_decim: int = 6
    fc_pos: str = "cen"
    n_channels: int = 64  # default-bank size (multiple of n_channel)
    chan_stages: int = 0  # extra per-channel ÷2 stages after device cascade
    #: uniform-grid gear: M > 0 runs ONE polyphase DFT filter bank
    #: (dsp/pfb.py) over the gathered baseband instead of per-channel
    #: trees/broadcast; each demod then gathers its grid channel by a
    #: TRACED index (so live offset changes keep working without a
    #: rebuild) and absorbs the residual on its NCO. Channel rate becomes
    #: baseband_rate / pfb_m. Mutually exclusive with chan_stages.
    pfb_m: int = 0
    #: Ulysses-style axis swap (SURVEY §5): instead of all_gathering the
    #: full baseband to every device, every device runs the PFB on its OWN
    #: frame chunk (time-sharded via the ppermute halo ring, then frame-
    #: sliced over the channel axis — the analysis is computed exactly once
    #: across the mesh) and ONE lax.all_to_all over BOTH axes trades frames
    #: for channels — device d receives all frames of grid channels
    #: [d·M/D, (d+1)·M/D), D = n_time·n_channel. Inter-device traffic drops
    #: n_time·n_channel-fold vs the all_gather. Banks may be heterogeneous
    #: (counts divisible by D); each demod's grid channel must live in its
    #: device's chunk (the session places channels grid-sorted and passes
    #: traced local indices — arbitrary within-chunk permutations and
    #: residual offsets retune live without a rebuild).
    pfb_all_to_all: bool = False
    #: PFB prototype taps per branch (dsp/pfb.prototype) for both gears.
    pfb_taps: int = 12
    block: int = 1 << 20  # device-rate samples per step (global)
    bank: tuple[BankGroup, ...] | None = None  # heterogeneous bank override
    #: split the demod bank over BOTH mesh axes (time × channel) instead of
    #: replicating the per-channel work across the time axis after the
    #: baseband all_gather. None = auto: enabled when every group count is
    #: divisible by n_time·n_channel. (r1 ran the same demods on every
    #: time-shard — n_time× redundant compute.)
    time_axis_channels: bool | None = None
    #: optional baseband spectrum tap (SpectrumVis role): a SpectrumConfig
    #: makes step() return a 4th output, the latest block's UNAVERAGED
    #: display frame (averaging is stateless-free here; the session applies
    #: its EMA host-side so no extra sharded state is carried)
    spectrum: object | None = None

    @functools.cached_property
    def channel_split(self) -> int:
        """Devices each channel group is split across (n_channel or
        n_time·n_channel)."""
        full = self.n_time * self.n_channel
        if self.time_axis_channels is None:
            ok = all(g.count % full == 0 for g in self.groups)
            return full if ok else self.n_channel
        if self.time_axis_channels:
            for g in self.groups:
                if g.count % full:
                    raise ValueError(
                        f"time_axis_channels needs group counts divisible by "
                        f"n_time*n_channel={full}; {g.uri} has {g.count}")
            return full
        return self.n_channel

    @property
    def baseband_rate(self) -> float:
        return self.device_rate / (1 << self.log2_decim)

    @functools.cached_property
    def groups(self) -> tuple[BankGroup, ...]:
        if self.bank is not None:
            return tuple(self.bank)
        # bench default: squelch open, minimal attack so short runs
        # produce audio
        return (BankGroup(NFM_URI, self.n_channels,
                          {"squelch_db": -100.0, "squelch_gate_ms": 1.0}),)

    @functools.cached_property
    def demod_cfgs(self) -> tuple:
        """Per-group demod configs bound to the post-channelizer rate."""
        if self.pfb_m:
            if self.chan_stages:
                raise ValueError("pfb_m and chan_stages are mutually exclusive")
            rate = self.baseband_rate / self.pfb_m
            block_in = (self.block >> self.log2_decim) // self.pfb_m
        else:
            rate = self.baseband_rate / (1 << self.chan_stages)
            block_in = (self.block >> self.log2_decim) >> self.chan_stages
        cfgs = []
        for g in self.groups:
            kind = REGISTRY[g.uri]
            kwargs = dict(channel_rate=rate, input_offset=0.0, **g.settings)
            if any(f.name == "block_in"
                   for f in dataclasses.fields(kind.config_cls)):
                kwargs["block_in"] = block_in
            cfgs.append(kind.config_cls(**kwargs))
        return tuple(cfgs)

    @functools.cached_property
    def demod_cfg(self):
        """Single-group convenience accessor (the homogeneous-bank case)."""
        (cfg,) = self.demod_cfgs
        return cfg


def _validate_bank(cfg: ShardedPipelineConfig) -> None:
    if cfg.pfb_all_to_all:
        if not cfg.pfb_m:
            raise ValueError("pfb_all_to_all requires pfb_m")
        full = cfg.n_time * cfg.n_channel
        if cfg.pfb_m % full:
            raise ValueError(
                f"pfb_m={cfg.pfb_m} must divide over the mesh "
                f"(n_time*n_channel={full})")
        for g in cfg.groups:
            if g.count % full:
                raise ValueError(
                    f"pfb_all_to_all group {g.uri} count {g.count} must be "
                    f"a multiple of n_time*n_channel={full}")
        if cfg.channel_split != full:
            raise ValueError("pfb_all_to_all splits channels over BOTH axes")
    for g in cfg.groups:
        kind = REGISTRY.get(g.uri)
        if kind is None:
            raise ValueError(f"unknown channel kind {g.uri!r}")
        if kind.output != "audio":
            raise ValueError(f"sharded bank supports audio kinds; {g.uri} is data")
        if "offset_hz" not in kind.dynamic_fields:
            raise ValueError(
                f"{g.uri} does not thread offset_hz as a traced arg"
            )
        if g.count % cfg.n_channel:
            raise ValueError(
                f"group {g.uri} count {g.count} must be a multiple of the "
                f"channel mesh axis {cfg.n_channel}"
            )


def grid_split(cfg: ShardedPipelineConfig, offsets: np.ndarray):
    """PFB-gear helper: absolute channel offsets (Hz) -> (grid index mod M,
    residual Hz for the demod NCO)."""
    spacing = cfg.baseband_rate / cfg.pfb_m
    idx = np.rint(np.asarray(offsets) / spacing).astype(np.int64)
    residual = (np.asarray(offsets) - idx * spacing).astype(np.float32)
    return (idx % cfg.pfb_m).astype(np.int32), residual


def _pfb_with_halo(bb_ext: jnp.ndarray, m: int, p: int) -> jnp.ndarray:
    """Streaming PFB analysis over the local frame chunk with the (P-1)·M
    halo INJECTED as the carried tail — the analysis runs on the bare
    chunk length (see _cascade_with_halo)."""
    ph = (p - 1) * m
    state = pfbmod.PfbState(bb_ext[..., :ph])
    _, y = pfbmod.analyze(state, bb_ext[..., ph:], m, pfbmod.prototype(m, p))
    return y


def a2a_placement(cfg: ShardedPipelineConfig, offsets_per_group):
    """Host-side channel placement for the pfb_all_to_all gear.

    Each device receives grid channels [d·M/D, (d+1)·M/D) after the axis
    swap, so a demod must be placed on the device owning its grid channel.
    Sorts each group's channels by grid chunk and checks feasibility (every
    device must receive exactly count/D channels of every group).

    Returns (orders, local_idx, residuals): `orders[g]` is the permutation
    applied to group g (audio comes back in this order — invert host-side),
    `local_idx[g]` the per-channel index into the owning device's grid
    chunk (traced; live retunes within the chunk need no rebuild),
    `residuals[g]` the sorted residual offsets.
    """
    d_total = cfg.n_time * cfg.n_channel
    sz = cfg.pfb_m // d_total
    orders, locals_, residuals = [], [], []
    for g, offs in zip(cfg.groups, offsets_per_group):
        idx, res = grid_split(cfg, np.asarray(offs))
        dev = idx // sz
        order = np.argsort(dev, kind="stable").astype(np.int64)
        cg = g.count // d_total
        dev_sorted = dev[order]
        want = np.repeat(np.arange(d_total), cg)
        if not np.array_equal(dev_sorted, want):
            raise ValueError(
                f"group {g.uri}: grid channels {sorted(set(idx.tolist()))} "
                f"cannot be balanced over {d_total} devices "
                f"({cg}/device needed); retune or use the all_gather gear")
        orders.append(order)
        locals_.append((idx[order] % sz).astype(np.int32))
        residuals.append(res[order].astype(np.float32))
    return orders, locals_, residuals


def build_a2a_step(cfg: ShardedPipelineConfig, mesh: Mesh):
    """The pfb_all_to_all gear: time-sharded decimation (ppermute halo) +
    frame-sharded PFB analysis (each device analyzes its own frame chunk —
    the M-channel analysis is computed exactly ONCE across the mesh) + one
    lax.all_to_all over BOTH mesh axes trading frames for channels — the
    Ulysses axis swap. step(state, x, carry, residuals[, local_idx]) ->
    (state', audio, carry'); carry = (cascade tail (2,H), pfb tail (2,(P-1)M)).

    residuals: per-group (count,) Hz, sharded over BOTH mesh axes in
    placement order (see a2a_placement). local_idx: per-group (count,)
    int32 indices into the owning device's grid chunk (traced — live
    retunes within the chunk recompile nothing); None = identity (the
    single-group count==M flagship)."""
    _validate_bank(cfg)
    halo = halo_samples(cfg.log2_decim)
    n_time, n_channel = cfg.n_time, cfg.n_channel
    d_total = n_time * n_channel
    m = cfg.pfb_m
    p_taps = cfg.pfb_taps
    ph = (p_taps - 1) * m  # baseband-rate PFB halo
    kinds = [REGISTRY[g.uri] for g in cfg.groups]
    demod_cfgs = cfg.demod_cfgs
    single = len(cfg.groups) == 1
    sz = m // d_total
    bb_total = cfg.block >> cfg.log2_decim
    if bb_total % (n_time * m * n_channel):
        raise ValueError(
            f"block {cfg.block}: baseband frames ({bb_total}/{m}) must split "
            f"over n_time*n_channel={d_total} for the frame-sharded analysis")
    if cfg.spectrum is not None and (bb_total // n_time) % cfg.spectrum.fft_size:
        raise ValueError(
            f"spectrum tap in the a2a gear: per-shard baseband "
            f"({bb_total}//{n_time}) must be a multiple of the display fft "
            f"size {cfg.spectrum.fft_size} so the global frame grid aligns "
            f"with the shard grid (pick a block multiple of "
            f"{cfg.spectrum.fft_size * n_time << cfg.log2_decim})")

    def local_step(state, x_local, carry, residuals, local_idx):
        casc_carry, pfb_carry = carry
        xc = (x_local.astype(jnp.float32) / 32768.0)
        xc = (xc[..., 0] + 1j * xc[..., 1]).astype(jnp.complex64)

        t_idx = jax.lax.axis_index("time")
        c_idx = jax.lax.axis_index("channel")
        perm = [(i, (i + 1) % n_time) for i in range(n_time)]

        def ring_halo(sig, h, host_carry):
            """ppermute the tail; shard 0 swaps the ring wrap for the
            host-fed carry and the wrap becomes the next block's carry."""
            tail = sig[-h:]
            recv = jax.lax.ppermute(tail, "time", perm)
            carry_c = (host_carry[0] + 1j * host_carry[1]).astype(jnp.complex64)
            left = jnp.where(t_idx == 0, carry_c, recv)
            new_carry_c = jax.lax.psum(
                jnp.where(t_idx == 0, recv, jnp.zeros_like(recv)), "time")
            new_carry = jnp.stack(
                [jnp.real(new_carry_c), jnp.imag(new_carry_c)])
            return jnp.concatenate([left, sig]), new_carry

        if halo:
            ext, new_casc = ring_halo(xc, halo, casc_carry)
            bb_local = _cascade_with_halo(ext, cfg.log2_decim, cfg.fc_pos, halo)
        else:
            bb_local, new_casc = xc, casc_carry

        # baseband spectrum tap (the SpectrumVis role). The display frame grid
        # aligns with the time shards (validated at build), so the
        # single-device tap's "last frame of the block" is exactly the
        # last local frame of the LAST time shard — select it with a psum
        # (replicated + vma-provable over 'time'; bb_local is already
        # channel-invariant). Each device FFTs only its own shard: the
        # tap is frame-sharded, not replicated work.
        spec = None
        if cfg.spectrum is not None:
            from ..dsp import spectrum as dsp_spectrum

            scfg = dataclasses.replace(
                cfg.spectrum, averaging_mode="none", overlap=0)
            _, v = dsp_spectrum.power_spectrum(
                dsp_spectrum.make_state(scfg), bb_local, scfg)
            spec = jax.lax.psum(
                jnp.where(t_idx == n_time - 1, v, jnp.zeros_like(v)), "time")

        # PFB halo ring over the time axis, then slice THIS column's frame
        # sub-chunk — the bb is identical across the channel axis, so the
        # columns split the frames instead of repeating the analysis
        # (r2 computed the full local analysis on every column).
        bb_ext, new_pfb = ring_halo(bb_local, ph, pfb_carry)
        f_col = bb_local.shape[-1] // m // n_channel
        seg = jax.lax.dynamic_slice_in_dim(
            bb_ext, c_idx * (f_col * m), f_col * m + ph, axis=-1)
        y_piece = _pfb_with_halo(seg, m, p_taps)  # (F_col, M)

        # the axis swap: ONE all_to_all over BOTH axes — device d receives
        # all frames of grid channels [d·sz, (d+1)·sz). Frame order is
        # (time, channel)-lexicographic = the global frame order.
        mine = jax.lax.all_to_all(
            y_piece, ("time", "channel"), split_axis=1, concat_axis=0,
            tiled=True)  # (F_total, sz)

        new_states, audios = [], []
        for g, (kind, gcfg) in enumerate(zip(kinds, demod_cfgs)):
            cstate, dstate = state[g]
            if local_idx is None:  # identity: demod i of chunk = channel i
                xb = jnp.moveaxis(mine, -1, 0)  # (sz, F_total)
            else:
                # one-hot (C, sz) @ (F, sz)^T product instead of
                # jnp.take: a compile workaround from an earlier
                # accelerator, A/B on the H100 queued (ROADMAP Design 3).
                # At the policy precision it copies the selected inputs
                # exactly.
                oh = (local_idx[g][:, None]
                      == jnp.arange(mine.shape[-1])).astype(mine.dtype)
                xb = jnp.einsum("cs,fs->cf", oh, mine,
                                precision=PRECISION)
            dstate, audio = kind.process(dstate, xb, gcfg,
                                         offset_hz=residuals[g])
            new_states.append((cstate, dstate))
            audios.append(audio)
        if spec is None:
            return tuple(new_states), tuple(audios), (new_casc, new_pfb)
        return tuple(new_states), tuple(audios), (new_casc, new_pfb), spec

    chan_axes = ("time", "channel")
    state_specs = jax.tree.map(lambda _: P(chan_axes), _group_state_structure(cfg))
    carry_specs = (P(), P())
    group_specs = tuple(P(chan_axes) for _ in cfg.groups)

    def make_jit(with_idx: bool):
        base_specs = (state_specs, P("time"), carry_specs, group_specs)
        if with_idx:
            fn, in_specs = local_step, base_specs + (group_specs,)
        else:
            def fn(st, x, ca, res):
                return local_step(st, x, ca, res, None)
            in_specs = base_specs
        out_specs = (state_specs, group_specs, carry_specs)
        if cfg.spectrum is not None:
            out_specs = out_specs + (P(),)  # replicated display frame
        return jax.jit(
            jax.shard_map(
                fn,
                mesh=mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                # the a2a gear splits everything over both axes; only the
                # host-fed carries are replicated (psum-built, so the VMA
                # checker can verify them) — keep the static check ON here;
                # the all_gather gear below still
                # needs check_vma=False for its replicated outputs.
                check_vma=True,
            )
        )

    jits: dict = {}

    def step(state, x, carry, residuals, local_idx=None):
        if single and not isinstance(residuals, (tuple, list)):
            residuals = (residuals,)
        if single and local_idx is not None and not isinstance(
                local_idx, (tuple, list)):
            local_idx = (local_idx,)
        key = local_idx is not None
        if key not in jits:
            jits[key] = make_jit(key)
        if key:
            out = jits[key](
                state, x, carry, tuple(residuals), tuple(local_idx))
        else:
            out = jits[key](state, x, carry, tuple(residuals))
        state, audio, carry = out[0], out[1], out[2]
        audio = audio[0] if single else audio
        if cfg.spectrum is not None:
            return state, audio, carry, out[3]
        return state, audio, carry

    def init_fn():
        def impl():
            return (_group_state_structure(cfg),
                    (jnp.zeros((2, max(halo, 1)), jnp.float32),
                     jnp.zeros((2, ph), jnp.float32)))
        return jax.jit(impl)()

    return step, init_fn


def build_sharded_step(cfg: ShardedPipelineConfig, mesh: Mesh):
    """Returns (step, init_fn). step(state, x, carry, offsets[, pfb_idx])
    -> (state', audio, new_carry); everything is shard_map'ed over the mesh.

    x: (T, 2) int16 — sharded over 'time'. carry: (2, H) f32 — the previous
    block's tail for shard 0's halo. offsets: per-channel frequency offsets,
    sharded over 'channel'. For a single-group bank, offsets is one (C,)
    array and audio one (C, A) array; for a heterogeneous bank both are
    tuples with one entry per BankGroup.

    With cfg.pfb_m set, pass `pfb_idx` (per-group int32 grid indices,
    sharded like offsets — see grid_split) and give the demods the residual
    offsets; the step runs ONE polyphase DFT bank over the gathered
    baseband and each demod gathers its grid channel by traced index.
    With cfg.pfb_all_to_all, dispatches to build_a2a_step (its step takes
    (state, x, (casc_carry, pfb_carry), residuals)).
    """
    if cfg.pfb_all_to_all:
        return build_a2a_step(cfg, mesh)
    _validate_bank(cfg)
    # With the PFB gear the analysis is frame-sharded across the mesh (each
    # device runs 1/D of the M-channel analysis) whenever the block's frame
    # count divides the device count; otherwise the build DEGRADES to every
    # device running the full analysis (D× redundant flops). Degradation is
    # a static property of (block, log2, M, mesh) — warn loudly at build
    # time and expose it on the returned step so callers (the session
    # report) can surface it. Choose block a multiple of
    # pfb_m · 2^log2 · n_time · n_channel to stay frame-sharded.
    frame_sharded = True
    if cfg.pfb_m:
        f_total = (cfg.block >> cfg.log2_decim) // cfg.pfb_m
        frame_sharded = f_total % (cfg.n_time * cfg.n_channel) == 0
        if not frame_sharded:
            _log.warning(
                "sharded PFB gear DEGRADED to replicated analysis: "
                "%d frames/block do not divide over %d devices (block=%d, "
                "log2_decim=%d, pfb_m=%d); every device repeats the full "
                "analysis. Use a block multiple of %d to frame-shard.",
                f_total, cfg.n_time * cfg.n_channel, cfg.block,
                cfg.log2_decim, cfg.pfb_m,
                (cfg.pfb_m << cfg.log2_decim) * cfg.n_time * cfg.n_channel)
    halo = halo_samples(cfg.log2_decim)
    n_time = cfg.n_time
    kinds = [REGISTRY[g.uri] for g in cfg.groups]
    counts = [g.count for g in cfg.groups]
    demod_cfgs = cfg.demod_cfgs
    single = len(cfg.groups) == 1
    split = cfg.channel_split  # devices per channel group (see channel_split)
    chan_axes = ("time", "channel") if split > cfg.n_channel else "channel"

    def local_step(state, x_local, carry, offsets, pfb_idx=None):
        # x_local: (T/n_time, 2) int16; carry: (2, H) f32;
        # state/offsets: per-group tuples, local channel slices
        if cfg.pfb_m:
            state, pfb_state = state
        xc = (x_local.astype(jnp.float32) / 32768.0)
        xc = (xc[..., 0] + 1j * xc[..., 1]).astype(jnp.complex64)

        if halo:
            tail = xc[-halo:]
            perm = [(i, (i + 1) % n_time) for i in range(n_time)]
            recv = jax.lax.ppermute(tail, "time", perm)
            # shard 0's ring wrap-around is replaced by the host-fed carry;
            # what it received is the global tail = next block's carry.
            t_idx = jax.lax.axis_index("time")
            carry_c = (carry[0] + 1j * carry[1]).astype(jnp.complex64)
            left = jnp.where(t_idx == 0, carry_c, recv)
            new_carry_c = jax.lax.psum(
                jnp.where(t_idx == 0, recv, jnp.zeros_like(recv)), "time"
            )
            ext = jnp.concatenate([left, xc])
            bb_local = _cascade_with_halo(ext, cfg.log2_decim, cfg.fc_pos, halo)
            new_carry = jnp.stack([jnp.real(new_carry_c), jnp.imag(new_carry_c)])
        else:
            bb_local = xc
            new_carry = carry

        # axis swap: gather full baseband time series (small after ÷2^k).
        # all_gather_invariant: the result is the SAME on every time shard
        # and the vma system knows it — this is what lets check_vma stay on
        # with the per-channel outputs declared replicated over 'time'.
        bb = _all_gather_inv(bb_local, "time", tiled=True)  # (T/2^k,)

        spec = None
        if cfg.spectrum is not None:
            # replicated stateless display frame (averaging_mode is forced
            # off in-graph; the caller averages across blocks host-side)
            from ..dsp import spectrum as dsp_spectrum

            scfg = dataclasses.replace(cfg.spectrum, averaging_mode="none")
            _, spec = dsp_spectrum.power_spectrum(
                dsp_spectrum.make_state(scfg), bb, scfg)

        if cfg.pfb_m:
            # frame-sharded analysis over the (replicated) gathered baseband:
            # device d analyzes frame chunk d only, then the chunks are
            # all_gathered back — the M-channel analysis is computed exactly
            # once across the mesh (r2 ran the FULL analysis on every
            # device, n_time·n_channel× redundant flops). The carried conv
            # tail stays replicated: every device rebuilds it from the
            # gathered bb identically.
            m = cfg.pfb_m
            p_taps = cfg.pfb_taps
            ph = (p_taps - 1) * m
            f_total = bb.shape[-1] // m
            d_total = cfg.n_time * cfg.n_channel
            ext = jnp.concatenate([pfb_state.tail, bb], axis=-1)
            if frame_sharded:
                f_dev = f_total // d_total
                d_lin = (jax.lax.axis_index("time") * cfg.n_channel
                         + jax.lax.axis_index("channel"))
                seg = jax.lax.dynamic_slice_in_dim(
                    ext, d_lin * (f_dev * m), f_dev * m + ph, axis=-1)
                y_piece = _pfb_with_halo(seg, m, p_taps)  # (F_dev, M)
                ych = _all_gather_inv(
                    y_piece, ("time", "channel"), axis=0, tiled=True)
            else:  # odd frame counts: replicated analysis (see the loud
                # build-time warning — every device repeats the full
                # M-channel analysis, d_total× redundant flops)
                _, ych = pfbmod.analyze(
                    pfb_state, bb, m, pfbmod.prototype(m, p_taps))
            pfb_state = pfbmod.PfbState(ext[..., bb.shape[-1]:])

        new_states, audios = [], []
        for g, (kind, gcfg) in enumerate(zip(kinds, demod_cfgs)):
            cstate, dstate = state[g]
            cg = counts[g] // split  # local channels of this group
            if cfg.pfb_m:
                # (F, M) -> (cg, F) via traced grid indices: live offset
                # moves re-select without recompiling. One-hot matmul in
                # place of jnp.take, as above.
                oh = (pfb_idx[g][:, None]
                      == jnp.arange(ych.shape[-1])).astype(ych.dtype)
                xb = jnp.einsum("cm,fm->cf", oh, ych,
                                precision=PRECISION)
            else:
                xb = jnp.broadcast_to(bb, (cg, bb.shape[-1]))
                if cfg.chan_stages:
                    signs = np.zeros((cg, cfg.chan_stages), int)
                    cstate, xb = chan.channelize_bank(cstate, xb, signs)
            dstate, audio = kind.process(dstate, xb, gcfg, offset_hz=offsets[g])
            new_states.append((cstate, dstate))
            audios.append(audio)
        out_state = tuple(new_states)
        if cfg.pfb_m:
            out_state = (out_state, pfb_state)
        if spec is None:
            return out_state, tuple(audios), new_carry
        return out_state, tuple(audios), new_carry, spec

    state_specs = jax.tree.map(lambda _: P(chan_axes), _group_state_structure(cfg))
    if cfg.pfb_m:
        # the PFB tail follows the (replicated) gathered baseband
        state_specs = (state_specs,
                       jax.tree.map(lambda _: P(),
                                    pfbmod.make_state(cfg.pfb_m, cfg.pfb_taps)))
    group_specs = tuple(P(chan_axes) for _ in cfg.groups)
    in_specs = (state_specs, P("time"), P(), group_specs)
    if cfg.pfb_m:
        in_specs = in_specs + (group_specs,)  # pfb_idx, sharded like offsets
    out_specs = (state_specs, group_specs, P())
    if cfg.spectrum is not None:
        out_specs = out_specs + (P(),)  # the spectrum frame is replicated
    jit_step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            # with channel_split == n_channel the per-channel outputs are
            # replicated over 'time'; the all_gather/psum collectives carry
            # that through the VMA inference, so the static check stays ON.
            check_vma=True,
        )
    )

    def step(state, x, carry, offsets, pfb_idx=None):
        if single and not isinstance(offsets, (tuple, list)):
            offsets = (offsets,)
        if cfg.pfb_m:
            if pfb_idx is None:
                raise ValueError("pfb_m set: pass pfb_idx (see grid_split)")
            if single and not isinstance(pfb_idx, (tuple, list)):
                pfb_idx = (pfb_idx,)
            out = jit_step(state, x, carry, tuple(offsets), tuple(pfb_idx))
        else:
            out = jit_step(state, x, carry, tuple(offsets))
        state, audio, carry = out[0], out[1], out[2]
        audio = audio[0] if single else audio
        if cfg.spectrum is not None:
            return state, audio, carry, out[3]
        return state, audio, carry

    # static degraded-mode flag (see the build-time warning above)
    step.replicated_analysis = bool(cfg.pfb_m) and not frame_sharded

    def init_fn():
        def impl():
            return _state_structure(cfg), jnp.zeros((2, max(halo, 1)), jnp.float32)
        return jax.jit(impl)()  # eager complex creation unsupported on some runtimes

    return step, init_fn


def _group_state_structure(cfg: ShardedPipelineConfig):
    """Per-group (channelizer state, demod state), global channel dims."""
    out = []
    for g, gcfg in zip(cfg.groups, cfg.demod_cfgs):
        kind = REGISTRY[g.uri]
        cstate = chan.init_state(cfg.chan_stages, batch_shape=(g.count,))
        out.append((cstate, kind.make_state(gcfg, batch_shape=(g.count,))))
    return tuple(out)


def _state_structure(cfg: ShardedPipelineConfig):
    groups = _group_state_structure(cfg)
    if cfg.pfb_m:
        return (groups, pfbmod.make_state(cfg.pfb_m, cfg.pfb_taps))
    return groups

"""RDS symbol/bit/frame layer + parser (host side, 1187.5 baud).

Reference: plugins/channelrx/demodbfm/rdsdemod.cpp (clock recovery + biphase
integrate-and-dump + differential decode), rdsdecoder.cpp (26-bit block sync
via syndrome of the RDS shortened cyclic code, offset words A/B/C/C'/D),
rdsparser.cpp (group types; PI/PTY/TP, PS name 0A/0B, RadioText 2A/2B).

Input: the complex RDS baseband the BFM channel emits at 8 samples/symbol
(coherently downconverted from 57 kHz). At 1187.5 baud this layer costs
microseconds in NumPy — the device does the MS/s part.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import rdstmc

# Generator polynomial g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 (RDS standard).
_POLY = 0x5B9
# Offset words A, B, C, C', D (rdsdecoder.cpp offset_word table).
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}
_OFFSET_ORDER = ["A", "B", "C", "D"]

PTY_NAMES = [
    "None", "News", "Current affairs", "Information", "Sport", "Education",
    "Drama", "Culture", "Science", "Varied", "Pop music", "Rock music",
    "Easy listening", "Light classical", "Serious classical", "Other music",
    "Weather", "Finance", "Children's", "Social affairs", "Religion",
    "Phone-in", "Travel", "Leisure", "Jazz music", "Country music",
    "National music", "Oldies music", "Folk music", "Documentary",
    "Alarm test", "Alarm",
]


def calc_syndrome(block: int, nbits: int) -> int:
    """Remainder of the block by the 11-bit generator (rdsdecoder.cpp
    calc_syndrome): plain polynomial long division."""
    reg = 0
    for i in range(nbits - 1, -1, -1):
        reg = (reg << 1) | ((block >> i) & 1)
        if reg & (1 << 10):
            reg ^= _POLY
    return reg & 0x3FF


#: Expected syndrome per offset (syndrome of a valid codeword is 0, so the
#: received syndrome equals the syndrome of the offset word alone).
SYNDROMES = {name: calc_syndrome(w, 26) for name, w in OFFSET_WORDS.items()}

#: syndrome delta of a single flipped bit i (linearity: syn(x ^ e_i) =
#: syn(x) ^ _BIT_SYNDROMES[i]) — enables 1-bit correction per block
_BIT_SYNDROMES = [calc_syndrome(1 << i, 26) for i in range(26)]


def _burst_tables(max_burst: int) -> list[dict[int, int]]:
    """tables[L-1]: syndrome-delta -> error pattern, for bursts of exact
    span L (first and last bit of the span flipped). The RDS code is a
    shortened cyclic (26,16) burst-correcting code designed for bursts up
    to 5 bits; within that design envelope syndromes of distinct bursts do
    not collide, so the lookup is exact."""
    tables: list[dict[int, int]] = []
    for span in range(1, max_burst + 1):
        tbl: dict[int, int] = {}
        inner = span - 2  # free bits between the fixed first/last of the span
        for pos in range(26 - span + 1):
            base = (1 << (span - 1)) | 1 if span > 1 else 1
            for mid in range(1 << max(inner, 0)):
                pattern = (base | (mid << 1)) << pos
                tbl[calc_syndrome(pattern, 26)] = pattern
        tables.append(tbl)
    return tables


_BURST_TABLES = _burst_tables(5)


def correct_block(block: int, expected_syndrome: int, max_burst: int = 1) -> int | None:
    """Return the corrected 26-bit block if it is clean or its errors form
    a single burst of span <= max_burst; None otherwise.

    The reference decoder (rdsdecoder.cpp) only detects; we exploit the
    code's designed burst-5 correction capability. Shorter bursts are tried
    first so the minimal correction wins (a clean block returns untouched).
    """
    delta = calc_syndrome(block, 26) ^ expected_syndrome
    if delta == 0:
        return block
    for tbl in _BURST_TABLES[:max_burst]:
        pattern = tbl.get(delta)
        if pattern is not None:
            return block ^ pattern
    return None


def crc10(dataword: int) -> int:
    """10-bit checkword of a 16-bit information word (shifted by x^10)."""
    return calc_syndrome(dataword << 10, 26)


def encode_block(dataword: int, offset: str) -> int:
    return (dataword << 10) | (crc10(dataword) ^ OFFSET_WORDS[offset])


def encode_group(blocks: list[int]) -> np.ndarray:
    """4×16-bit info words -> 104 bits with offsets A,B,C,D."""
    bits = []
    for word, off in zip(blocks, _OFFSET_ORDER):
        b = encode_block(word, off)
        bits.extend((b >> i) & 1 for i in range(25, -1, -1))
    return np.asarray(bits, dtype=np.uint8)


def bits_to_waveform(bits: np.ndarray, sps: int = 8) -> np.ndarray:
    """Differential-encode + biphase(Manchester) shape at sps samples/symbol
    (the inverse of the demod below; used by tests/goldens)."""
    diff = np.zeros(len(bits), dtype=np.uint8)
    prev = 0
    for i, b in enumerate(bits):
        prev = prev ^ int(b)
        diff[i] = prev
    half = sps // 2
    sym = np.concatenate([np.ones(half), -np.ones(half)])
    out = np.concatenate([(1.0 if d else -1.0) * sym for d in diff])
    return out.astype(np.float32)


#: RadioText+ content types (subset of the RT+ spec's 64; raw id always kept)
RTPLUS_CONTENT = {
    1: "item.title", 4: "item.artist", 6: "item.band", 10: "item.comment",
    11: "item.composer", 31: "info.news", 39: "info.weather",
    12: "info.date_time", 57: "stationname.long",
}

#: ODA application ids (rdsparser's known AIDs)
AID_RTPLUS = 0x4BD7
AID_TMC = 0xCD46


@dataclasses.dataclass
class RDSStatus:
    pi: int | None = None
    pty: int | None = None
    tp: bool | None = None
    ta: bool | None = None          # traffic announcement (group 0 / 15B)
    music: bool | None = None       # music/speech flag (group 0)
    ps_name: str = "        "
    radiotext: str = " " * 64
    ptyn: str = ""                  # programme type name (group 10A)
    pin: int | None = None          # programme item number (group 1A)
    clock_time: str = ""  # "YYYY-MM-DD HH:MM+TZ" from group 4A
    af_mhz: list = dataclasses.field(default_factory=list)  # alt freqs, MHz
    af_khz: list = dataclasses.field(default_factory=list)  # LF/MF alt freqs
    oda: dict = dataclasses.field(default_factory=dict)     # group -> AID (3A)
    eon: dict = dataclasses.field(default_factory=dict)     # other-net PI -> info dict
    tmc_events: list = dataclasses.field(default_factory=list)  # 8A decodes
    rtplus: dict = dataclasses.field(default_factory=dict)  # tag -> text (RT+)
    groups_ok: int = 0
    blocks_with_errors: int = 0
    blocks_corrected: int = 0

    @property
    def pty_name(self) -> str:
        return PTY_NAMES[self.pty] if self.pty is not None else ""


class RDSDecoder:
    """Streaming symbol→bit→group pipeline with carried state."""

    def __init__(self, sps: int = 8, max_burst: int = 5):
        self.sps = sps
        self.max_burst = max_burst
        self._carry = np.zeros(0, dtype=np.float64)
        self._prev_raw = 0
        self._bit_reg = 0
        self._bits_seen = 0
        self._synced = False
        self._block_idx = 0
        self._group: list[int] = []
        self.status = RDSStatus()
        self._ps = list(" " * 8)
        self._rt = list(" " * 64)
        self._ptyn = list(" " * 8)
        self._eon_ps: dict[int, list[str]] = {}
        self._eon_af: dict[int, set] = {}        # pending AF(ON) sets
        self._eon_mapped: dict[int, set] = {}    # pending mapped FM freqs
        self._eon_mapped_am: dict[int, set] = {} # pending mapped AM freqs
        self._af: set[float] = set()
        self._af_lf: set[float] = set()
        self._tmc = rdstmc.TmcDecoder()

    # -- symbol layer ------------------------------------------------------

    def feed_baseband(self, bb: np.ndarray) -> list[list[int]]:
        """bb: complex RDS baseband at sps×1187.5 Hz. Returns completed,
        CRC-clean groups as lists of 4 info words.

        Symbol timing: the phase is estimated once from the first block's
        matched-filter metric and held (the emitting resampler is rationally
        locked to the symbol rate, so there is no drift to track; a slow
        tracking loop would slot in here for free-running sources).
        """
        x = np.real(np.asarray(bb)).astype(np.float64)
        x = np.concatenate([self._carry, x])
        sps = self.sps
        half = sps // 2
        m = np.concatenate([np.ones(half), -np.ones(half)])

        if not hasattr(self, "_timing_locked"):
            if len(x) < 64 * sps:  # need enough signal to estimate timing
                self._carry = x
                return []
            n_try = len(x) // sps - 1
            best_phase, best_metric = 0, -1.0
            for ph in range(sps):
                seg = x[ph : ph + n_try * sps].reshape(n_try, sps)
                metric = np.abs(seg @ m).mean()
                if metric > best_metric:
                    best_metric, best_phase = metric, ph
            self._timing_locked = True
            x = x[best_phase:]  # symbol-align the stream once

        n_sym = len(x) // sps
        self._carry = x[n_sym * sps :]
        if n_sym == 0:
            return []
        acc = x[: n_sym * sps].reshape(n_sym, sps) @ m
        raw = (acc > 0).astype(np.uint8)
        groups = []
        for rb in raw:
            bit = int(rb) ^ self._prev_raw  # differential decode
            self._prev_raw = int(rb)
            g = self._feed_bit(bit)
            if g is not None:
                groups.append(g)
                self.parse_group(g)
        return groups

    # -- frame layer (rdsdecoder.cpp frameSync semantics) ------------------

    def _feed_bit(self, bit: int):
        self._bit_reg = ((self._bit_reg << 1) | bit) & ((1 << 26) - 1)
        self._bits_seen += 1
        if not self._synced:
            if self._bits_seen >= 26 and calc_syndrome(self._bit_reg, 26) == SYNDROMES["A"]:
                # current register is a clean block-A: start of a group
                self._synced = True
                self._group = [self._bit_reg >> 10]
                self._block_idx = 1  # next expected offset: B
                self._bits_since_block = 0
            return None
        self._bits_since_block += 1
        if self._bits_since_block < 26:
            return None
        self._bits_since_block = 0
        expected = _OFFSET_ORDER[self._block_idx]
        corrected = correct_block(self._bit_reg, SYNDROMES[expected], self.max_burst)
        if corrected is None and expected == "C":
            corrected = correct_block(self._bit_reg, SYNDROMES["C'"], self.max_burst)
        if corrected is None:
            # uncorrectable: drop sync and re-acquire (rdsdecoder.cpp)
            self.status.blocks_with_errors += 1
            self._synced = False
            self._group = []
            self._bits_seen = 0
            return None
        if corrected != self._bit_reg:
            self.status.blocks_corrected += 1
        self._group.append(corrected >> 10)
        self._block_idx += 1
        if self._block_idx == 4:
            g, self._group = self._group, []
            self._block_idx = 0
            self.status.groups_ok += 1
            return g
        return None

    # -- parser (rdsparser.cpp semantics: 0/1A/2/3A/4A/8A/10A/14A/15B) -----

    def _feed_af_code(self, code: int) -> None:
        """One alternate-frequency byte of a 0A block-C pair (rdsparser.cpp
        decode_type0 AF handling)."""
        if getattr(self, "_af_lfmf_next", False):
            self._af_lfmf_next = False
            if 1 <= code <= 15:  # LF: 153..279 kHz in 9 kHz steps
                self._af_lf.add(153.0 + 9.0 * (code - 1))
            elif 16 <= code <= 135:  # MF: 531..1602 kHz
                self._af_lf.add(531.0 + 9.0 * (code - 16))
            return
        if 1 <= code <= 204:  # VHF: 87.6..108.0 MHz in 100 kHz steps
            self._af.add(round(87.5 + 0.1 * code, 1))
        elif code == 250:  # "one LF/MF frequency follows"
            self._af_lfmf_next = True
        # 205 = filler, 224..249 = "N AFs follow" counters, others unused

    def _parse_rtplus(self, g: list[int]) -> None:
        """RadioText+ tags (ODA AID 0x4BD7): two (content-type, start,
        length) tuples referencing substrings of the current RadioText."""
        st = self.status
        ct1 = ((g[1] & 0x7) << 3) | (g[2] >> 13)
        start1 = (g[2] >> 7) & 0x3F
        len1 = (g[2] >> 1) & 0x3F
        ct2 = ((g[2] & 1) << 5) | (g[3] >> 11)
        start2 = (g[3] >> 5) & 0x3F
        len2 = g[3] & 0x1F
        for ct, s0, ln in ((ct1, start1, len1), (ct2, start2, len2)):
            if ct == 0:
                continue
            text = st.radiotext[s0 : s0 + ln + 1].rstrip()
            if text:
                st.rtplus[RTPLUS_CONTENT.get(ct, f"type{ct}")] = text

    def parse_group(self, g: list[int]) -> None:
        st = self.status
        st.pi = g[0]
        gtype = (g[1] >> 12) & 0xF
        version_b = (g[1] >> 11) & 1
        st.tp = bool((g[1] >> 10) & 1)
        st.pty = (g[1] >> 5) & 0x1F
        gkey = f"{gtype}{'B' if version_b else 'A'}"
        if st.oda.get(gkey) == AID_RTPLUS:
            return self._parse_rtplus(g)
        if gtype == 0:
            st.ta = bool((g[1] >> 4) & 1)
            st.music = bool((g[1] >> 3) & 1)
            seg = g[1] & 0x3
            if not version_b:
                self._feed_af_code((g[2] >> 8) & 0xFF)
                self._feed_af_code(g[2] & 0xFF)
                st.af_mhz = sorted(self._af)
                st.af_khz = sorted(self._af_lf)
            chars = g[3]
            self._ps[2 * seg] = chr((chars >> 8) & 0xFF)
            self._ps[2 * seg + 1] = chr(chars & 0xFF)
            st.ps_name = "".join(self._ps)
        elif gtype == 1 and not version_b:
            # programme item number: day(5) hour(5) minute(6)
            st.pin = g[3]
        elif gtype == 3 and not version_b:
            # ODA announcement: block 2 low 5 bits name the carrier group,
            # block 4 is the application id (AID)
            agt = (g[1] >> 1) & 0xF
            aver = "B" if g[1] & 1 else "A"
            st.oda[f"{agt}{aver}"] = g[3]
        elif gtype == 8 and not version_b:
            # TMC (ALERT-C) user messages: single- AND multi-group assembly
            # with free-format field decode (channels/rdstmc.py; reference
            # rdsparser.cpp:858-955 + the rdstmc.cpp event table)
            msg = self._tmc.feed(g)
            if msg is not None:
                st.tmc_events.append({
                    "single_group": msg.single_group,
                    "duration": msg.duration_code,
                    "duration_text": msg.duration_text,
                    "diversion": msg.diversion,
                    "direction": msg.direction,
                    "extent": msg.extent,
                    "event": msg.event,
                    # msg.event_text carries the quantifier substitution
                    # when a multi-group field supplied one
                    "event_text": msg.event_text,
                    "location": msg.location,
                    "fields": msg.fields,
                    "complete": msg.complete,
                })
                del st.tmc_events[:-32]  # bounded history
        elif gtype == 10 and not version_b:
            seg = g[1] & 1
            for i, c in enumerate([(g[2] >> 8) & 0xFF, g[2] & 0xFF,
                                   (g[3] >> 8) & 0xFF, g[3] & 0xFF]):
                self._ptyn[4 * seg + i] = chr(c)
            st.ptyn = "".join(self._ptyn)
        elif gtype == 14:
            # EON — Enhanced Other Networks (rdsparser.cpp decode_type14,
            # :1002-1181). All 14A variants: 0-3 PS(ON) segments, 4 AF(ON),
            # 5-8 mapped FM frequencies, 9 mapped AM frequency, 12 linkage
            # (commits accumulated sets), 13 PTY(ON)/TA(ON), 14 PIN(ON).
            # 14B (ignored by the reference) is the TA(ON) switch signal:
            # block-2 bit 3 announces traffic on the other network.
            on_pi = g[3]
            info = st.eon.setdefault(on_pi, {})
            if version_b:
                info["ta"] = bool((g[1] >> 3) & 1)
            else:
                variant = g[1] & 0xF
                information = g[2]
                if variant <= 3:
                    ps = self._eon_ps.setdefault(on_pi, list(" " * 8))
                    ps[2 * variant] = chr((information >> 8) & 0xFF)
                    ps[2 * variant + 1] = chr(information & 0xFF)
                    info["ps"] = "".join(ps)
                elif variant == 4:
                    # two VHF alternate frequencies, 87.5+code/10 MHz
                    pend = self._eon_af.setdefault(on_pi, set())
                    for code in ((information >> 8) & 0xFF, information & 0xFF):
                        if 1 <= code <= 204:
                            pend.add(round(87.5 + 0.1 * code, 1))
                elif 5 <= variant <= 8:
                    # tuning freq (this network) -> mapped freq (other network)
                    code = information & 0xFF
                    if 1 <= code <= 204:
                        self._eon_mapped.setdefault(on_pi, set()).add(
                            round(87.5 + 0.1 * code, 1))
                elif variant == 9:
                    # mapped AM frequency: 531 + 9*(code-16) kHz
                    code = information & 0xFF
                    if 16 <= code <= 135:
                        self._eon_mapped_am.setdefault(on_pi, set()).add(
                            531.0 + 9.0 * (code - 16))
                elif variant == 12:
                    # linkage information: commit the accumulated AF /
                    # mapped-frequency sets (merge semantics, :1070-1140)
                    info["linkage"] = information
                    if self._eon_af.get(on_pi):
                        info["af_mhz"] = sorted(
                            set(info.get("af_mhz", [])) | self._eon_af.pop(on_pi))
                    if self._eon_mapped.get(on_pi):
                        info["mapped_mhz"] = sorted(
                            set(info.get("mapped_mhz", []))
                            | self._eon_mapped.pop(on_pi))
                    if self._eon_mapped_am.get(on_pi):
                        info["mapped_khz"] = sorted(
                            set(info.get("mapped_khz", []))
                            | self._eon_mapped_am.pop(on_pi))
                elif variant == 13:
                    info["pty"] = (information >> 11) & 0x1F
                    info["ta"] = bool(information & 1)
                elif variant == 14:
                    info["pin"] = information
        elif gtype == 15 and version_b:
            # fast basic tuning: repeats the group-0 flags, no PS/AF payload
            st.ta = bool((g[1] >> 4) & 1)
            st.music = bool((g[1] >> 3) & 1)
        elif gtype == 4 and not version_b:
            # 4A clock-time: Modified Julian Date + hour/minute + offset
            mjd = ((g[1] & 0x3) << 15) | (g[2] >> 1)
            hour = ((g[2] & 1) << 4) | (g[3] >> 12)
            minute = (g[3] >> 6) & 0x3F
            offs_sign = -1 if (g[3] >> 5) & 1 else 1
            offs_half_hours = g[3] & 0x1F
            # MJD -> calendar (standard RDS conversion)
            yp = int((mjd - 15078.2) / 365.25)
            mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
            day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
            k = 1 if mp in (14, 15) else 0
            year = 1900 + yp + k
            month = mp - 1 - k * 12
            tz = offs_sign * offs_half_hours * 0.5
            st.clock_time = (
                f"{year:04d}-{month:02d}-{day:02d} {hour:02d}:{minute:02d}"
                f"{'+' if tz >= 0 else '-'}{abs(tz):g}h"
            )
        elif gtype == 2:
            seg = g[1] & 0xF
            if version_b:
                chars = [(g[3] >> 8) & 0xFF, g[3] & 0xFF]
                base = 2 * seg
            else:
                chars = [
                    (g[2] >> 8) & 0xFF, g[2] & 0xFF,
                    (g[3] >> 8) & 0xFF, g[3] & 0xFF,
                ]
                base = 4 * seg
            for i, c in enumerate(chars):
                if base + i < 64:
                    self._rt[base + i] = chr(c)
            st.radiotext = "".join(self._rt)

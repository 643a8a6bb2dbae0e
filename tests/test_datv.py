"""DATV end-to-end: TS packets -> DVB-S encode -> QPSK waveform at 4 sps ->
device front end (mix, RRC, symbol sync) -> host FEC chain -> TS packets."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.channels import demod_datv, dvbs


def test_datv_qpsk_end_to_end():
    # transmit 8 + 11(pipeline) TS packets
    rng = np.random.default_rng(0)
    n_pk = 8
    n_lead = 6  # lead-in absorbs the symbol-timing acquisition transient
    pk = rng.integers(0, 256, size=(n_pk, dvbs.TS_PACKET), dtype=np.uint8)
    pk[:, 0] = dvbs.SYNC_BYTE
    lead = rng.integers(0, 256, size=(n_lead, dvbs.TS_PACKET), dtype=np.uint8)
    lead[:, 0] = dvbs.SYNC_BYTE
    pad = rng.integers(0, 256, size=(11, dvbs.TS_PACKET), dtype=np.uint8)
    pad[:, 0] = dvbs.SYNC_BYTE
    chan_bits = dvbs.encode_transport(
        np.concatenate([lead, pk, pad]).reshape(-1)
    )
    symbols = demod_datv.bits_to_qpsk(chan_bits)

    # waveform: 4 samples/symbol, RRC pulse shaping via the same filter
    cfg = demod_datv.DATVConfig(channel_rate=1_000_000.0, symbol_rate=250_000.0)
    sps = cfg.sps
    up = np.zeros(len(symbols) * sps, dtype=np.complex64)
    up[::sps] = symbols * sps  # impulse train (energy normalization)
    from sdrangel_tpu.dsp import fftfilt as ff

    st = ff.make_state(cfg.fft_len)
    hop = cfg.fft_len // 2
    n = len(up) // hop * hop
    _, shaped = ff.run_filt(st, jnp.asarray(up[:n]), jnp.asarray(cfg.rrc_filter))
    x = np.asarray(jnp.stack([jnp.real(shaped), jnp.imag(shaped)]))
    x = (x[0] + 1j * x[1]).astype(np.complex64) * 0.4

    # receive through the DATV front end
    state = demod_datv.make_state(cfg)
    block = (len(x) // (hop * sps)) * hop * sps
    block = min(block, len(x) // hop * hop)
    st2 = state
    si, sq = [], []
    import jax

    run = jax.jit(demod_datv.process, static_argnums=2)
    bsize = 16384
    pad_n = (-len(x)) % bsize
    x = np.concatenate([x, np.zeros(pad_n, np.complex64)])
    for b in range(len(x) // bsize):
        st2, outs = run(st2, jnp.asarray(x[b * bsize : (b + 1) * bsize]), cfg)
        si.append(np.asarray(outs.soft_i))
        sq.append(np.asarray(outs.soft_q))
    soft_i = np.concatenate(si)
    soft_q = np.concatenate(sq)

    # resolve the QPSK phase ambiguity, then run the FEC chain
    rot, soft = demod_datv.resolve_rotation(soft_i, soft_q)
    # symbol alignment: the front end delays by carries/filters; search the
    # bit offset where the decode yields sync bytes
    best = None
    for bit_off in range(0, 64, 2):
        out, _ = dvbs.decode_transport(soft[bit_off:], n_lead + n_pk)
        got = out.reshape(-1, dvbs.TS_PACKET)
        if len(got) < n_lead + n_pk:
            continue
        payload = got[n_lead : n_lead + n_pk]
        score = sum(np.array_equal(payload[i], pk[i]) for i in range(n_pk))
        if best is None or score > best[0]:
            best = (score, payload)
        if score == n_pk:
            break
    assert best is not None
    score, got = best
    assert score >= n_pk - 1, f"recovered {score}/{n_pk} packets"


def _dvbs_waveform(ts_packets: np.ndarray, cfg) -> np.ndarray:
    """TS packets -> RRC-shaped QPSK baseband at cfg.channel_rate."""
    import jax
    from sdrangel_tpu.dsp import fftfilt as ff

    chan_bits = dvbs.encode_transport(ts_packets.reshape(-1))
    symbols = demod_datv.bits_to_qpsk(chan_bits)
    sps = cfg.sps
    up = np.zeros(len(symbols) * sps, dtype=np.complex64)
    up[::sps] = symbols * sps
    st = ff.make_state(cfg.fft_len)
    hop = cfg.fft_len // 2
    n = len(up) // hop * hop
    _, shaped = ff.run_filt(st, jnp.asarray(up[:n]), jnp.asarray(cfg.rrc_filter))
    x = np.asarray(jnp.stack([jnp.real(shaped), jnp.imag(shaped)]))
    return (x[0] + 1j * x[1]).astype(np.complex64) * 0.4


@pytest.mark.slow
def test_datv_through_session_rest(tmp_path):
    """Full DATV pipeline through the session + REST: a DVB-S capture file
    is demodulated on the device, FEC-decoded and TS-demuxed on the host,
    and the programme map appears in the channel report."""
    import json
    import threading
    import time
    import urllib.request

    from sdrangel_tpu.api.server import make_server
    from sdrangel_tpu.channels import tsdemux
    from sdrangel_tpu.io import sdriq
    from sdrangel_tpu.runtime.session import Session

    rng = np.random.default_rng(5)

    def _rand_pk(n, seed):
        r = np.random.default_rng(seed)
        pk = r.integers(0, 256, size=(n, dvbs.TS_PACKET), dtype=np.uint8)
        pk[:, 0] = dvbs.SYNC_BYTE
        return pk

    psi = []
    psi += tsdemux._section_packetize(0, tsdemux.make_pat({7: 0x120}), 0)
    psi += tsdemux._section_packetize(
        0x120, tsdemux.make_pmt(7, 0x300, {0x300: 0x1B}), 0)
    psi += tsdemux.make_pes_packets(0x300, bytes(range(200)) * 20, pts=12345)
    psi_arr = np.frombuffer(b"".join(psi), np.uint8).reshape(-1, dvbs.TS_PACKET)
    stream = np.concatenate([
        _rand_pk(6, 1), np.tile(psi_arr, (3, 1)), _rand_pk(12, 2)
    ])

    cfg = demod_datv.DATVConfig(channel_rate=1_000_000.0, symbol_rate=250_000.0)
    x = _dvbs_waveform(stream, cfg)
    path = str(tmp_path / "datv.sdriq")
    sdriq.write(path, x, sample_rate=1_000_000)

    session = Session()
    srv = make_server(session, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def req(p, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(base + p, data=data, method=method)
        if data:
            r.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read())

    req("/sdrangel/devicesets", "POST")
    req("/sdrangel/deviceset/0/device/settings", "PATCH",
        {"kind": "filesource", "file_path": path, "throttle": False})
    code, _ = req("/sdrangel/deviceset/0/channel", "POST",
                  {"channelType": "sdrangel.channel.demoddatv",
                   "symbol_rate": 250_000.0, "datvContinuous": True})
    assert code == 201
    req("/sdrangel/deviceset/0/device/run", "POST")
    rep = None
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            _, rep = req("/sdrangel/deviceset/0/channel/0/report")
            if rep.get("datv"):
                break
            time.sleep(0.5)
    finally:
        req("/sdrangel/deviceset/0/device/run", "DELETE")
        srv.shutdown()
    assert rep and rep.get("datv"), rep
    datv = rep["datv"]
    assert datv["rounds"] >= 1
    assert datv["packets"] > 20 and datv["rsFailed"] <= datv["packets"] // 4, datv
    progs = {p["program"]: p for p in datv["ts"]["programs"]}
    assert 7 in progs, datv["ts"]
    assert progs[7]["streams"][0]["codec"] == "H.264 video"

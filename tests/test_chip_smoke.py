"""chip_smoke.py's phases at tiny sizes on the CPU: the served path over
HTTP (both file readers, the CPU-backend comparison), the kernel gears'
step-2 comparison, and the device phase's refusal of a CPU-only platform.
On the CPU the "device" and the reference backend are the same, so the
comparisons must agree exactly here; on the card they run at real size.
"""

import numpy as np
import pytest

import chip_smoke


def test_device_phase_refuses_cpu():
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.require_gpu()
    assert bench.require_gpu("cpu")[0].platform == "cpu"


def test_served_path_tiny(tmp_path):
    res = chip_smoke.phase_served(rate=768_000.0, log2_decim=2, seconds=0.5,
                                  n_blocks=3, out_dir=str(tmp_path),
                                  timeout_s=300.0)
    for uri, *_ in chip_smoke.SERVED_CHANNELS:
        kind = uri.rsplit(".", 1)[-1]
        assert res[f"{kind}_snr_db"] > chip_smoke.SERVED_TONE_SNR_DB
        assert res[f"{kind}_max_lsb"] == 0  # same backend: bit-exact


@pytest.mark.parametrize("test,rows", [("decimateif", 2), ("chainpfb", 16),
                                       ("chain64", 64)])
def test_gear_tiny(test, rows):
    res = chip_smoke.phase_gear(test, block=1 << 18, timed_steps=1)
    assert res["rows"] == rows
    assert res["max_abs_err"] == 0.0  # same backend: bit-exact


def test_fm_block_is_periodic_on_its_grid():
    """Every synthesised frequency sits on the block's DFT grid, so a
    repeated block is the same stream as one block twice as long."""
    rate, n = 12_288_000.0, 1 << 14  # a 750 Hz grid
    freqs = np.array([0.0, 48_000.0, -96_000.0])
    one = chip_smoke.fm_block(freqs, rate, n, tone_hz=1500.0)
    two = chip_smoke.fm_block(freqs, rate, 2 * n, tone_hz=1500.0)
    assert np.abs(one).max() > 1000  # non-vacuous
    np.testing.assert_allclose(two, np.tile(one, (2, 1)), atol=1)


def test_multi_dryrun_tiny():
    """--multi's path: the three sharded gears on a 2x2 mesh of virtual
    CPU devices, each against its 1x1 oracle, outputs on all 4 devices."""
    import __graft_entry__

    res = __graft_entry__.dryrun_multichip(4)
    assert res["mesh"] == "2x2"
    assert max(res["tree_err"], res["pfb_err"], res["a2a_err"]) < res["err_bound"]
    assert res["tree_devices"] == res["pfb_devices"] == res["a2a_devices"] == 4


def test_main_last_line_is_the_result(monkeypatch, capsys):
    """main's wiring: the card line, one line per phase, then exactly the
    result object as the last line (phases stubbed; tested above)."""
    import json

    import jax

    import bench

    monkeypatch.setattr(bench, "require_gpu", jax.devices)
    monkeypatch.setattr(bench, "gpu_card", lambda: "card, 0 W")
    for name in ("phase_served", "phase_gear", "phase_goldens",
                 "phase_precision"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: {"x": 1})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card, 0 W"
    assert [line.split("]")[0] for line in lines[1:-1]] == [
        "[device", "[served", "[gear decimateif", "[gear chainpfb",
        "[gear chain64", "[goldens", "[precision"]
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 8}}


def test_main_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out

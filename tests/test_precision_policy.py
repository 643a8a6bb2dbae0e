"""Conv-precision policy pinning (sdrangel_tpu/dsp/precision.py).

On the H100 a float32 conv or dot at DEFAULT or HIGH precision may run in
TF32 (10-bit mantissa), below the reference's int16 pipeline; the policy
ships HIGHEST. The CPU backend computes every precision in float32, so on
the CPU the test checks the plumbing: all three settings agree and clear
the int16 bar, and SDRANGEL_TPU_CONV_PRECISION selects the shipped one.
The `gpu` test checks on the card that the shipped default clears the bar.
Each probe runs tools/precision_probe.py in a child process (the policy is
read at import; the child may open the GPU, this process stays on the CPU).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

from conftest import child_env

PROBE = pathlib.Path(__file__).parent.parent / "tools" / "precision_probe.py"

#: int16 quantization SNR for a full-scale sine: 6.02*16 + 1.76 dB
INT16_SNR_DB = 98.1


def _probe(**env) -> dict:
    out = subprocess.run([sys.executable, str(PROBE)], env=child_env(**env),
                         capture_output=True, text=True, check=True,
                         timeout=560)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_precision_policy_cpu():
    snrs = _probe(JAX_PLATFORMS="cpu", SDRANGEL_TPU_CONV_PRECISION="high")
    assert snrs["platform"] == "cpu" and snrs["shipped"] == "high", snrs
    levels = [snrs[p] for p in ("default", "high", "highest")]
    # CPU lowers every precision to f32 — all three must agree and clear
    # the int16 bar (validates the env plumbing + the oracle)
    assert all(s > INT16_SNR_DB for s in levels), snrs
    assert max(levels) - min(levels) < 3.0, snrs


@pytest.mark.slow
@pytest.mark.gpu
def test_precision_policy_gpu():
    snrs = _probe()
    assert snrs["platform"] == "gpu", snrs
    assert snrs[snrs["shipped"]] > INT16_SNR_DB, snrs

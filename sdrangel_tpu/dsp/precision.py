"""Precision of every float32 dot and conv on the device path.

On the H100 a float32 dot or conv at DEFAULT or HIGH precision may run on
the tensor cores in TF32, whose 10-bit mantissa sits below the int16 bar of
the reference's fixed-point pipeline (98.1 dB for a full-scale sine) and
below the reference goldens (AM 109 dB, SSB 118 dB, NFM parity 137 dB).
HIGHEST keeps full float32 arithmetic. Measured on an NVIDIA H100 80GB
HBM3 (400 W power limit) by `chip_smoke.py`'s precision phase, the ÷64
flat cascade against the float64 oracle reads 91.46 dB at DEFAULT and at
HIGH, 120.91 dB at HIGHEST: HIGHEST is the cheapest setting that clears
the int16 bar, and the reference goldens pass under it.

The CPU backend computes every setting in float32, so the CPU suite cannot
tell them apart; the `gpu`-marked test in tests/test_precision_policy.py
checks the shipped default on the card.

SDRANGEL_TPU_CONV_PRECISION (default | high | highest) overrides the
default for A/B runs; it is read once, at import.
"""

from __future__ import annotations

import os

import jax

#: the precision passed to every f32 dot, einsum and conv on the device path
PRECISION = jax.lax.Precision(
    os.environ.get("SDRANGEL_TPU_CONV_PRECISION", "highest"))

#!/usr/bin/env python3
"""Measure the ÷64 flat cascade's SNR vs the float64 NumPy oracle at the
DEFAULT, HIGH and HIGHEST conv precisions, on JAX's default device.

Prints one JSON line {"default": dB, "high": dB, "highest": dB,
"shipped": <the dsp/precision.py policy's name>}. Used by
tests/test_precision_policy.py (in a child process) and for manual A/B:

    python tools/precision_probe.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax

    from chip_smoke import flat_cascade_snr_db
    from sdrangel_tpu.dsp.precision import PRECISION

    snrs = {p: round(flat_cascade_snr_db(jax.lax.Precision(p)), 2)
            for p in ("default", "high", "highest")}
    print(json.dumps({**snrs, "shipped": PRECISION.name.lower(),
                      "platform": jax.devices()[0].platform}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

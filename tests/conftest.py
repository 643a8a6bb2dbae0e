"""Test harness config: force CPU with 8 virtual devices so the sharding
tests run on any machine (the multi-node-without-a-cluster analog of the
reference's localhost SDRdaemon loopback, SURVEY.md §4).

Tests marked `gpu` need an NVIDIA GPU. The suite itself stays on the CPU;
a `gpu` test runs its device work in a child process. Whether a GPU is
there is decided in a fixture, once per session and never at import, so
every pytest-xdist worker collects the same tests.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sdrangel_tpu import compile_cache  # noqa: E402

compile_cache.configure()


def child_env(**extra) -> dict:
    """Environment for a child process that may open the GPU: without the
    suite's CPU pin (JAX_PLATFORMS, the virtual-device flag)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(extra)
    return env


@pytest.fixture(scope="session")
def gpu_platform():
    """The platform of JAX's first device as a child process sees it."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        # the probe must not hold the card's memory while a test runs
        env=child_env(XLA_PYTHON_CLIENT_PREALLOCATE="false"),
        capture_output=True, text=True, timeout=300)
    return out.stdout.strip().splitlines()[-1] if out.returncode == 0 else None


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    if request.node.get_closest_marker("gpu") is not None:
        if request.getfixturevalue("gpu_platform") != "gpu":
            pytest.skip("needs an NVIDIA GPU visible to JAX")

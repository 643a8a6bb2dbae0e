"""Where the persistent JAX compilation cache lives.

One rule for every entry point (the CLI and server, bench.py,
chip_smoke.py, the test suite): when JAX_COMPILATION_CACHE_DIR is set, JAX
reads it itself and nothing is set here; otherwise the cache is
<checkout>/.jax_cache. The path is part of the cache key, so it is fixed.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure() -> str | None:
    """Point JAX at <checkout>/.jax_cache unless JAX_COMPILATION_CACHE_DIR
    is set. Returns the directory it set, or None when it set nothing."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, the benchmarks, ``chip_smoke.py``
and the tests): ``$JAX_COMPILATION_CACHE_DIR`` when it is set, which JAX
reads by itself, and otherwise ``.jax_cache`` at the root of the checkout.
The directory is part of the cache's key, so it is never built from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache lives in under the rule above."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on; call before the first compilation.
    Sets nothing when ``$JAX_COMPILATION_CACHE_DIR`` is set."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

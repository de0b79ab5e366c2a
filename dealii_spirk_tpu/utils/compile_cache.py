"""Where JAX keeps compiled programs between processes.

The entry points (``python -m dealii_spirk_tpu``, ``bench.py``,
``gmg_bench`` and ``chip_smoke.py``) call :func:`enable_compile_cache`
once, before they compile anything.  The cache key includes the
directory, so the default is a fixed path inside the checkout rather
than one made from a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it by itself and
    nothing is set here."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

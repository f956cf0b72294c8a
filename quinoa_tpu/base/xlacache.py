"""Persistent XLA compilation cache.

One helper shared by every entry point (the CLI, the benchmarks,
chip_smoke.py, tests/conftest.py and __graft_entry__.py), so they all
warm the same cache.

Where the cache lives:

- `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself, and no
  directory is set in code;
- otherwise: `.jax_cache/` at the root of the checkout.  The path is
  fixed (no host or time suffix), so the next run from the same
  checkout finds what this one compiled.

`QUINOA_TEST_CACHE=0` disables the cache.
"""

from __future__ import annotations

import os

#: the default cache directory, inside the checkout (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str | None:
    """Turn on JAX's persistent compilation cache.  Returns the
    directory in use, or None when disabled."""
    if os.environ.get("QUINOA_TEST_CACHE") == "0":
        return None
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return cache

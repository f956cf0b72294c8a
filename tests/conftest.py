"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-chip hardware is not available in CI; sharding correctness is tested
on a virtual CPU mesh exactly like the reference tests distributed logic
with multi-chare runs on a single box (SURVEY.md §4.2 asynclogic).

JAX backend *initialization* is lazy, so switching the platform and
forcing the virtual device count here (before any array op runs) is
sufficient even if jax was imported earlier.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache (base/xlacache.py): the tier is
# compile-bound (the heaviest SPMD programs cost 30-50 s each to build);
# warm re-runs then spend seconds, not minutes, in XLA
from quinoa_tpu.base.xlacache import enable_compile_cache  # noqa: E402

enable_compile_cache()

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) >= 8, jax.devices()

"""Base toolkit + reorder tests (tests/unit/Base, tests/unit/LoadBalance
coverage analog)."""

import io
import os

import numpy as np
import pytest

from quinoa_tpu.base import Timer, linear_load_distributor, Progress, Table
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.mesh.reorder import sfc_reorder, remap, shift_to_zero


def test_timer_and_eta():
    t = Timer()
    assert t.sec() >= 0
    w = t.hms()
    assert str(w).count(":") == 2
    eta = t.eta(term=1.0, t=0.5, nstep=10**9, it=5)
    assert eta.hrs >= 0


def test_load_distributor_limits():
    # u=0: one chunk per PE
    cs, n = linear_load_distributor(0.0, 1000, 4)
    assert cs == 250 and n == 4
    # u=1: unit chunks
    cs, n = linear_load_distributor(1.0, 1000, 4)
    assert cs == 1 and n == 1000
    # u=0.5 interpolates
    cs, n = linear_load_distributor(0.5, 1000, 4)
    assert 1 < cs < 250
    with pytest.raises(ValueError):
        linear_load_distributor(1.5, 10, 2)


def test_progress_stream():
    buf = io.StringIO()
    p = Progress("setup", ["part", "reorder"], [2, 1], stream=buf)
    p.inc(0)
    p.inc(0)
    p.inc(1)
    out = buf.getvalue()
    assert "part:2/2" in out and "done" in out


def test_table_interpolation():
    t = Table([0.0, 1.0, 2.0], [0.0, 10.0, 0.0])
    assert float(t(0.5)) == 5.0
    assert float(t(1.5)) == 5.0
    assert float(t(-1.0)) == 0.0  # constant extrapolation
    assert float(t(5.0)) == 0.0


def test_sfc_reorder_preserves_mesh():
    mesh = box_tet_mesh(4, 4, 4)
    new, nperm, eperm = sfc_reorder(mesh)
    assert new.positive_jacobians()
    # same geometry: total volume identical
    from quinoa_tpu.mesh import tet_geometry

    J0, _ = tet_geometry(mesh.coords, mesh.inpoel)
    J1, _ = tet_geometry(new.coords, new.inpoel)
    assert np.isclose(J0.sum(), J1.sum())
    # a nodal field remaps consistently: f(new coords) == remapped f
    f = mesh.coords[:, 0] + 2 * mesh.coords[:, 1]
    fnew = np.empty_like(f)
    fnew[nperm] = f
    assert np.allclose(fnew, new.coords[:, 0] + 2 * new.coords[:, 1])
    # side sets survive
    assert sum(len(v) for v in new.bface.values()) == sum(
        len(v) for v in mesh.bface.values()
    )


def test_remap_shift():
    inp = np.array([[3, 4, 5, 6]])
    shifted, lo = shift_to_zero(inp)
    assert lo == 3 and shifted.min() == 0
    newid = np.arange(10)[::-1]
    assert (remap(np.array([1, 2]), newid) == np.array([8, 7])).all()


def test_phase_profiler():
    """Per-phase wall-clock breakdown (the Main timer-table analog)."""
    import time as _time

    from quinoa_tpu.base.profiler import PhaseProfiler, jax_trace

    prof = PhaseProfiler()
    with prof.phase("a"):
        _time.sleep(0.01)
    with prof.phase("b"):
        _time.sleep(0.02)
    with prof.phase("a"):
        _time.sleep(0.01)
    times = dict((k, (s, n)) for k, s, n in prof.times())
    assert times["a"][1] == 2 and times["b"][1] == 1
    assert times["a"][0] >= 0.02 and times["b"][0] >= 0.02
    tbl = prof.table()
    assert "total" in tbl and "median_ms" in tbl
    # per phase: sec, %, entries, first entry's and median entry's ms
    rows = {ln.split()[0]: ln.split()[1:] for ln in tbl.splitlines()[1:]}
    assert int(rows["a"][2]) == 2 and int(rows["b"][2]) == 1
    assert float(rows["a"][3]) >= 10.0 and float(rows["b"][4]) >= 20.0
    # no-op trace context
    with jax_trace(None):
        pass


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from quinoa_tpu.base.xlacache import enable_compile_cache
d = enable_compile_cache(min_compile_secs=0.0)
jax.jit(lambda x: x * 2.0 + 1.0)(jnp.ones(3)).block_until_ready()
print(repr(d))
print(repr(jax.config.jax_compilation_cache_dir))
"""


def _cache_probe(**env):
    """(directory enable_compile_cache returned, JAX's cache directory)
    in a fresh process with the given environment."""
    import ast
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    e = {k: v for k, v in os.environ.items()
         if k not in ("JAX_COMPILATION_CACHE_DIR", "QUINOA_TEST_CACHE")}
    e.update(JAX_PLATFORMS="cpu", **env)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=root,
                         env=e, capture_output=True, text=True, timeout=300,
                         check=True)
    returned, configured = out.stdout.splitlines()[-2:]
    return ast.literal_eval(returned), ast.literal_eval(configured)


def test_compile_cache_honours_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache lands there and no other
    directory is set in code."""
    cache = str(tmp_path / "jaxcache")
    assert _cache_probe(JAX_COMPILATION_CACHE_DIR=cache) == (cache, cache)
    assert os.listdir(cache)


def test_compile_cache_default_is_fixed_checkout_dir():
    from quinoa_tpu.base.xlacache import DEFAULT_DIR

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_DIR == os.path.join(root, ".jax_cache")
    assert _cache_probe() == (DEFAULT_DIR, DEFAULT_DIR)


def test_compile_cache_disabled():
    assert _cache_probe(QUINOA_TEST_CACHE="0") == (None, None)

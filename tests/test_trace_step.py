"""tools/trace_step.py's reduction from a profiler trace to per-layer
device times, checked on a small program traced on the CPU."""

import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import trace_step  # noqa: E402


def _step(a, b):
    with jax.named_scope("dg_face"):
        x = jnp.einsum("ij,jk->ik", a, b,
                       precision=jax.lax.Precision.HIGHEST)
    with jax.named_scope("limiter"):
        y = jnp.maximum(x, 0.0).sum(axis=0)
    return x + y


def test_op_scopes_and_reduce_trace(tmp_path):
    a, b = jnp.ones((64, 64)), jnp.ones((64, 64))
    step = jax.jit(_step)
    compiled = step.lower(a, b).compile()
    scopes = trace_step.op_scopes(compiled.as_text())
    assert {"dg_face", "limiter"} <= set(scopes.values())
    step(a, b).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(trace_step.NSTEP):
            step(a, b).block_until_ready()
    path = next(os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
                for f in fs if f.endswith(".xplane.pb"))
    out = trace_step.reduce_trace(path, scopes)
    assert out["by_scope_ms"].get("dg_face", 0.0) > 0.0
    assert 0.0 <= out["idle_share"] < 1.0
    assert out["device_busy_ms"] <= out["device_window_ms"]
    assert all(scope in scopes.values() or scope == "other"
               for _, scope, _ in out["top_ops"])

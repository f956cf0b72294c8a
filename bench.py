"""Benchmark: cell-updates/sec/chip on Sedov DG(P1) Euler — the north-star
metric from BASELINE.json.

    python bench.py            # shard_map leg (npes=1), then the headline

Each measurement runs in its own subprocess, one after the other, and
prints one JSON line {"metric", "value", "unit", "ms_per_step",
"compile_s", "vs_baseline", "device"}; the headline line comes last.
value = elements x steps / wall-clock of a window of 10 chained steps
ended by one host readback; ms_per_step is that window over its steps.
Without an accelerator the measurement fails instead of timing the CPU.

Configuration: Sedov blast wave, DG(P1) + HLLC + Superbee limiter, RK3,
CFL time stepping, symmetry walls — the analog of the reference regression
tests/regression/inciter/compflow/Euler/SedovBlastwave (which the reference
runs with dg p1).

vs_baseline: the goal is >=10x updates/sec vs a 64-rank Charm++ CPU run
(BASELINE.md).  The reference publishes no absolute grind times; we anchor
the 64-rank CPU estimate at 2.0e6 cell-updates/sec (~30k updates/s/rank
for a DG(P1) RK3 Euler step; order-of-magnitude from the published
overdecomposition plots), so vs_baseline = value / 2.0e6.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

CPU_REFERENCE_UPDATES_PER_SEC = 2.0e6  # 64-rank Charm++ estimate

#: committed known-good L2(sol) after the bench's 11 steps (1 warmup +
#: 10 timed), from an f64 CPU run of the same configuration — the "at
#: matched L2 error" gate from BASELINE.md: a perf change that breaks
#: physics at bench scale fails the bench loudly instead of shipping a
#: fast wrong number.  rtol covers f32 round-off and operation-order
#: noise; a broken flux/limiter moves these by orders of magnitude more.
L2_KNOWN_GOOD_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tools", "bench_l2_known_good.json")
L2_RTOL = 5e-4


def _l2_gate(system, geom, state):
    """Compute L2(sol) of the final bench state and gate it against the
    committed known-good (derived from an f64 CPU run of the same
    configuration through the same path)."""
    from quinoa_tpu.inciter.dg import DGDiagnostics

    l2sol, _, _ = DGDiagnostics(system, geom).compute(state)
    line = {"metric": "l2_sol_sedov_dgp1_after_11_steps",
            "value": [round(v, 10) for v in l2sol]}
    with open(L2_KNOWN_GOOD_FILE) as f:
        good = json.load(f)["l2sol"]
    ok = np.allclose(l2sol, good, rtol=L2_RTOL, atol=0.0)
    line["gate"] = "ok" if ok else f"FAIL vs {good} (rtol {L2_RTOL})"
    print(json.dumps(line), flush=True)
    if not ok:
        print("bench.py: L2 GATE FAILED — the measured trajectory no "
              "longer matches the committed known-good; a perf change "
              "broke physics at bench scale", file=sys.stderr)
        sys.exit(1)


def _device():
    """The accelerator the measurement runs on; a run without one is
    not a measurement, so it fails instead of timing the CPU."""
    if jax.default_backend() == "cpu":
        raise SystemExit("bench.py: no accelerator found (JAX backend is "
                         "cpu); refusing to time the CPU")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _time_steps(solver, state, nsteps):
    """One warm-up (compiling) step, then a window of nsteps chained
    steps ended by one host readback, so that dispatch overlaps the
    device as in a production run.  Returns (state, compile_s,
    window_s)."""
    t0 = time.perf_counter()
    state = solver.step(state)
    float(jnp.sum(state.u))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = solver.step(state)
    float(jnp.sum(state.u))
    return state, compile_s, time.perf_counter() - t0


def main_spmd(npes: int):
    """The SAME Sedov DG(P1) step through the shard_map/SPMD path
    (SPMDDGSolver) over an npes-device jax.sharding.Mesh — the
    production `--npes` path.  npes must not exceed the local device
    count (at 1 it shows what the distributed program costs against
    the single-device step; the reference's scaling story is
    doc/pages/inciter_performance.dox:7-62)."""
    from jax.sharding import Mesh
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder
    from quinoa_tpu.pde.dg import BC_SYMMETRY
    from quinoa_tpu.pde.dg_compflow import DGCompFlow
    from quinoa_tpu.pde.problems import SedovBlastwave
    from quinoa_tpu.parallel.dg_shard import build_dg_shards
    from quinoa_tpu.parallel.dg_spmd import SPMDDGSolver, AXIS

    device = _device()
    devs = jax.devices()
    if len(devs) < npes:
        raise SystemExit(f"need {npes} devices, have {len(devs)}")

    n = 48
    mesh = box_tet_mesh(n, n, n, hi=(1.0, 1.0, 1.0))
    mesh, _ = hilbert_element_reorder(mesh)
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    sharded = build_dg_shards(mesh, npes, ndof=4, bc_sidesets=bc)
    dmesh = Mesh(np.array(devs[:npes]), (AXIS,))
    system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    solver = SPMDDGSolver(system, sharded, dmesh, cfl=0.5,
                          limiter="superbeep1")
    state = solver.initial_state()

    nsteps = 10
    state, compile_s, window_s = _time_steps(solver, state, nsteps)
    assert np.isfinite(np.asarray(state.u)).all()
    ups = mesh.nelem * nsteps / window_s
    print(json.dumps({
        "metric": "cell_updates_per_sec_sedov_dgp1_spmd",
        "value": ups,
        "unit": f"cell-updates/s ({npes}-device shard_map)",
        "npes": npes,
        "ms_per_step": window_s / nsteps * 1e3,
        "compile_s": compile_s,
        "vs_baseline": ups / CPU_REFERENCE_UPDATES_PER_SEC,
        "device": device,
    }))


def _run_inner(argv, timeout_s):
    """One measurement in a subprocess, so that each gets the card to
    itself (a JAX process reserves most of the card's memory; this
    parent never initializes JAX).  Returns the parsed last JSON line,
    or a failure record {"failed": {"cause", "rc", "stderr_tail"}}."""
    import subprocess

    def _tail(s):
        if isinstance(s, bytes):
            s = s.decode(errors="replace")
        return (s or "")[-500:]

    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *argv],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired as e:
        return {"failed": {"cause": f"timeout>{int(timeout_s)}s",
                           "rc": None, "stderr_tail": _tail(e.stderr)}}
    for ln in out.stdout.splitlines():
        if ln.startswith("{") and "l2_sol" in ln:
            print(ln, flush=True)      # surface the gate line
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-2000:])
        return {"failed": {"cause": "nonzero-exit", "rc": out.returncode,
                           "stderr_tail": _tail(out.stderr)}}
    try:
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("{") and "l2_sol" not in ln][-1]
        return json.loads(line)
    except (IndexError, json.JSONDecodeError):
        return {"failed": {"cause": "no-json-output", "rc": 0,
                           "stderr_tail": _tail(out.stderr)}}


def orchestrate():
    """The shard_map leg (npes=1), then the headline, each in its own
    subprocess, one after the other; the headline line prints last."""
    spmd = _run_inner(("--npes", "1"), 900)
    if "failed" in spmd:
        spmd = {"metric": "cell_updates_per_sec_sedov_dgp1_spmd",
                "value": None, "failure": spmd["failed"]}
    print(json.dumps(spmd), flush=True)
    best = _run_inner(("--inner",), 900)
    if "failed" in best:
        print("bench.py: headline measurement failed: "
              f"{json.dumps(best['failed'])}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(best), flush=True)


def main(pref: bool = False, ndof: int = 4, nolimit: bool = False):
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.pde.dg import build_dggeom, BC_SYMMETRY
    from quinoa_tpu.pde.dg_compflow import DGCompFlow
    from quinoa_tpu.pde.problems import SedovBlastwave
    from quinoa_tpu.inciter.dg import DGSolver

    from quinoa_tpu.base.xlacache import enable_compile_cache

    enable_compile_cache()
    device = _device()
    n = 48 if ndof == 4 else 32  # P2 carries 2.5x the dofs
    mesh = box_tet_mesh(n, n, n, hi=(1.0, 1.0, 1.0))
    # P2 runs UNLIMITED (the reference ships no P2 limiter), so the
    # bench problem must be smooth: TaylorGreen, the reference's own
    # dgp2 regression config (tests/regression/inciter/compflow/Euler/
    # TaylorGreen/taylor_green_dgp2.q).  Sedov at unlimited P2 blows
    # up within 11 steps.
    from quinoa_tpu.pde.problems import TaylorGreen
    problem_cls = SedovBlastwave if ndof == 4 else TaylorGreen
    # Hilbert element order: the production CLI's locality pass
    # (mesh/reorder.py; Sorter/Reorder analog)
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder

    mesh, _ = hilbert_element_reorder(mesh)
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    geom = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
    system = DGCompFlow(problem_cls(), riemann_flux="hllc")
    solver = DGSolver(
        system, geom, cfl=0.5,
        limiter=("superbeep1" if ndof == 4 and not nolimit else None),
        pref=pref)
    nsteps = 10
    state, compile_s, window_s = _time_steps(solver, solver.initial_state(),
                                             nsteps)
    if not nolimit:
        # unlimited timing runs are physically wrong by construction;
        # only their wall-clock is meaningful
        assert np.isfinite(np.asarray(state.u)).all()
    updates_per_sec = mesh.nelem * nsteps / window_s

    if ndof == 4 and not pref and not nolimit:
        # matched-L2 gate (headline config only): exits nonzero on a
        # physics mismatch BEFORE the perf line is emitted
        _l2_gate(system, geom, state)

    result = {
        "metric": ("cell_updates_per_sec_sedov_pdg_hllc_superbee"
                   if pref else
                   "cell_updates_per_sec_taylorgreen_dgp2_hllc"
                   if ndof == 10 else
                   "cell_updates_per_sec_sedov_dgp1_hllc_superbee"),
        "value": updates_per_sec,
        "unit": "cell-updates/s/chip",
        "ms_per_step": window_s / nsteps * 1e3,
        "compile_s": compile_s,
        "vs_baseline": updates_per_sec / CPU_REFERENCE_UPDATES_PER_SEC,
        "device": device,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--npes":
        from quinoa_tpu.base.xlacache import enable_compile_cache

        enable_compile_cache()
        main_spmd(int(sys.argv[2]))
    elif len(sys.argv) > 1 and sys.argv[1] == "--pdg":
        main(pref=True)
    elif len(sys.argv) > 1 and sys.argv[1] == "--dgp2":
        main(ndof=10)
    elif len(sys.argv) > 1 and sys.argv[1] == "--nolimit":
        # timing-only: the headline config minus all limiter work
        main(nolimit=True)
    elif len(sys.argv) > 1 and sys.argv[1] == "--inner":
        main()
    else:
        orchestrate()

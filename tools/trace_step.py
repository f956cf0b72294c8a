"""Device trace of the flagship DG step, reduced to per-layer times.

    python tools/trace_step.py [n] [outdir]

Builds the bench configuration (bench.py: Sedov DG(P1) + HLLC +
Superbee on the Hilbert-ordered n^3 box, default 48), warms it up,
traces three steps with jax.profiler, and prints one JSON object:

- step_ms: median host-clock time of the traced steps (each ended by
  block_until_ready);
- device_busy_ms / idle_share: union of the intervals in which an XLA
  operation ran on the device, within the traced window, and
  1 - busy/window;
- by_scope_ms: device time per traced step of the solver's named
  scopes (dg_face, dg_volume, limiter, dg_dt; "other" is the RK update
  and anything unscoped).  An operation belongs to the scope that most
  of its HLO instructions (a fusion's body included) name in their
  op_name metadata in the compiled step;
- top_ops: the longest device operations, per traced step, with their
  scope.

Command buffers (CUDA graphs) are off in this process, so that every
kernel in the trace names its HLO instruction; step_ms is therefore a
little above the CLI's, which replays each step as graphs.

The trace itself is written under outdir (default .trace/ in the checkout),
with the compiled step's HLO (step.hlo.txt.gz) that the attribution read.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCOPES = ("dg_face", "dg_volume", "limiter", "dg_dt")
NSTEP = 3


def _stats(ev):
    return {str(k): v for k, v in ev.stats}


def _kernel_name(op):
    """GPU kernels are named after their HLO instruction with '.' and
    '-' replaced by '_'."""
    return re.sub(r"[.\-]", "_", op)


def op_scopes(hlo_text):
    """HLO instruction name (and its kernel-name spelling) -> its layer:
    the one of SCOPES (or "other") that the op_name metadata of most of
    its instructions names, counting the instruction itself and every
    instruction it calls (a fusion's body).  A fusion's own metadata is
    only its root's, which for the DG step is often the unscoped RK
    update that XLA fused onto a face-pass gather."""
    inst = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
    meta = re.compile(r"op_name=\"([^\"]*)\"")
    calls = re.compile(r"(?:calls|to_apply)=\{?(%[^},\s]+(?:,\s*%[^},\s]+)*)")
    comps, body, cur = {}, {}, None
    for ln in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", ln)
        if head and not inst.match(ln):
            cur = head.group(1)
            comps[cur] = []
            continue
        m = inst.match(ln)
        if m and cur is not None:
            mm, mc = meta.search(ln), calls.search(ln)
            own = (next((s for s in SCOPES if s in mm.group(1)), "other")
                   if mm else None)
            callees = ([c.strip().lstrip("%") for c in mc.group(1).split(",")]
                       if mc else [])
            comps[cur].append(m.group(1))
            body[m.group(1)] = (own, callees)

    memo = {}

    def counts(name):
        if name not in memo:
            memo[name] = {}
            own, callees = body[name]
            out = {own: 1} if own else {}
            for c in callees:
                for i in comps.get(c, ()):
                    for k, v in counts(i).items():
                        out[k] = out.get(k, 0) + v
            memo[name] = out
        return memo[name]

    order = SCOPES + ("other",)
    out = {}
    for name in body:
        n = counts(name)
        label = max(order, key=lambda k: (n.get(k, 0), -order.index(k)))
        out[name] = out[_kernel_name(name)] = label
    return out


def op_events(pd):
    """(op, start ns, duration ns) of every XLA operation executed: the
    events carrying an hlo_op stat on the device planes (on the CPU
    backend, which has none, on the host threads).  A kernel replayed
    inside a command buffer (CUDA graph) is named by the kernel itself,
    as its hlo_op is the command buffer's."""
    dev = [p for p in pd.planes if p.name.startswith("/device:")]
    for planes in (dev, pd.planes):
        evs = []
        for plane in planes:
            for line in plane.lines:
                for ev in line.events:
                    op = _stats(ev).get("hlo_op")
                    if op == "command_buffer":
                        op = ev.name
                    if op is not None:
                        evs.append((str(op), ev.start_ns, ev.duration_ns))
        if evs:
            return evs
    return []


def reduce_trace(path, scopes, nstep=NSTEP):
    """Per-layer device times from one .xplane.pb (see module doc);
    scopes is op_scopes() of the traced program."""
    from jax.profiler import ProfileData

    evs = op_events(ProfileData.from_file(path))
    if not evs:
        raise SystemExit("no XLA operation events in the trace")
    ops = {}
    by_scope = {}
    for op, _, dur in evs:
        ops[op] = ops.get(op, 0.0) + dur / 1e6
        key = scopes.get(op, "other")
        by_scope[key] = by_scope.get(key, 0.0) + dur / 1e6
    iv = sorted((s, s + d) for _, s, d in evs)
    busy, (cur_s, cur_e) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = iv[-1][1] - iv[0][0]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    return {
        "device_busy_ms": busy / 1e6,
        "device_window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window,
        "by_scope_ms": {k: v / nstep for k, v in by_scope.items()},
        "top_ops": [(k, scopes.get(k, "other"), v / nstep) for k, v in top],
    }


def main():
    import jax
    import numpy as np

    from quinoa_tpu.inciter.dg import DGSolver
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder
    from quinoa_tpu.pde.dg import BC_SYMMETRY, build_dggeom
    from quinoa_tpu.pde.dg_compflow import DGCompFlow
    from quinoa_tpu.pde.problems import SedovBlastwave

    # an executable loaded from the persistent cache carries no HLO
    # metadata, and op_scopes needs it
    jax.config.update("jax_enable_compilation_cache", False)
    # no command buffers (CUDA graphs): each kernel then carries the HLO
    # instruction it runs, library calls (cuBLAS) included
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    outdir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, ".trace")
    mesh, _ = hilbert_element_reorder(box_tet_mesh(n, n, n))
    geom = build_dggeom(mesh, ndof=4,
                        bc_sidesets={i: BC_SYMMETRY for i in range(1, 7)})
    solver = DGSolver(DGCompFlow(SedovBlastwave(), riemann_flux="hllc"),
                      geom, cfl=0.5, limiter="superbeep1")
    state = solver.initial_state()
    for _ in range(2):
        state = solver.step(state)
    jax.block_until_ready(state.u)
    # the warmed-up state's signature is the traced program's (the
    # initial state's scalars may compile a program of their own)
    hlo = solver._step.lower(geom, state).compile().as_text()
    scopes = op_scopes(hlo)
    os.makedirs(outdir, exist_ok=True)
    with gzip.open(os.path.join(outdir, "step.hlo.txt.gz"), "wt") as f:
        f.write(hlo)
    times = []
    with jax.profiler.trace(outdir):
        for i in range(NSTEP):
            with jax.profiler.StepTraceAnnotation("dg_step", step_num=i):
                t0 = time.perf_counter()
                state = solver.step(state)
                jax.block_until_ready(state.u)
                times.append(time.perf_counter() - t0)
    path = sorted(glob.glob(os.path.join(outdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    out = {"device": jax.devices()[0].device_kind, "nelem": mesh.nelem,
           "step_ms": float(np.median(times)) * 1e3}
    out.update(reduce_trace(path, scopes))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

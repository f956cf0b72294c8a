"""Secondary benchmark: DiagCG+FCT node-updates/sec/chip on SlotCyl.

Not consumed by the driver (bench.py is the single JSON line); run
manually to catch CG-path perf regressions:

    python bench_cg.py [n]

Configuration: SlotCyl advection, DiagCG + FCT, CFL stepping, Dirichlet
walls — the analog of tests/regression/inciter/transport/SlotCyl
(slotcyl_diagcg), the reference's machine-precision-parity scheme.
"""

import json
import sys
import time

import jax
import numpy as np


def main():
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu.pde.problems import SlotCyl
    from quinoa_tpu.inciter import DiagCGSolver

    from quinoa_tpu.base.xlacache import enable_compile_cache

    enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    mesh = box_tet_mesh(n, n, n, hi=(1.0, 1.0, 1.0))
    # the CLI's locality pass (mesh/reorder.py)
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder
    mesh, _ = hilbert_element_reorder(mesh)
    solver = DiagCGSolver(
        CGTransport(SlotCyl()), make_cggeom(mesh), cfl=0.8,
        bcnodes=mesh.all_bnodes(),
    )
    state = solver.initial_state()

    nsteps = 10
    state = solver.step(state)
    jax.block_until_ready(state.u)

    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = solver.step(state)
    jax.block_until_ready(state.u)
    dt = time.perf_counter() - t0

    assert np.isfinite(np.asarray(state.u)).all()
    ups = mesh.nnode * nsteps / dt
    print(json.dumps({
        "metric": "node_updates_per_sec_slotcyl_diagcg_fct",
        "value": round(ups, 1),
        "unit": "node-updates/s/chip",
        "nnode": mesh.nnode,
        "ms_per_step": dt / nsteps * 1e3,
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()

"""Secondary benchmark: ALECG node-updates/sec/chip.

Not consumed by the driver (bench.py is the single JSON line); run
manually — the reference's published scaling story is ALECG
(doc/pages/inciter_performance.dox), so this tracks the analog:

    python bench_alecg.py [n]             # SlotCyl transport
    python bench_alecg.py --compflow [n]  # VorticalFlow Euler (the
                                          # reference's ALECG compflow
                                          # regression config)

The two flavors share the edge/assembly chain but not the per-node
physics (Euler flux, EoS and charspeed against a static velocity
field), so each is timed.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    from quinoa_tpu.base.xlacache import enable_compile_cache
    from quinoa_tpu.inciter.alecg import make_alecg
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder

    enable_compile_cache()

    args = [a for a in sys.argv[1:] if a != "--compflow"]
    compflow = "--compflow" in sys.argv[1:]
    n = int(args[0]) if args else 48
    if compflow:
        from quinoa_tpu.pde.cg_compflow import CGCompFlow
        from quinoa_tpu.pde.problems import VorticalFlow

        system = CGCompFlow(VorticalFlow())
        lo, hi, cfl = (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), 0.5
    else:
        from quinoa_tpu.pde.cg import CGTransport
        from quinoa_tpu.pde.problems import SlotCyl

        system = CGTransport(SlotCyl())
        lo, hi, cfl = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.8
    mesh = box_tet_mesh(n, n, n, lo=lo, hi=hi)
    mesh, _ = hilbert_element_reorder(mesh)
    solver = make_alecg(system, mesh, cfl=cfl,
                        bcnodes=mesh.all_bnodes())
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
        "metric": ("node_updates_per_sec_vortical_alecg_compflow"
                   if compflow else
                   "node_updates_per_sec_slotcyl_alecg"),
        "value": round(ups, 1),
        "unit": "node-updates/s/chip",
        "nnode": mesh.nnode,
        "ms_per_step": dt / nsteps * 1e3,
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()

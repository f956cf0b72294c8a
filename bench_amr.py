"""Secondary benchmark: AMR remesh wall-clock (BASELINE.json's second
metric).  Not consumed by the driver; run manually:

    python bench_amr.py [n]

Times one full during-timestep remesh event at bench scale: error
tagging + compatibility closure + 1:8/1:4/1:2 template refinement +
conservative solution transfer + solver-table rebuild — the analog of
the reference's Refiner::refine + Transporter AMR convergence +
Discretization resize (Refiner.cpp:360-414, Transporter.cpp:450-523).
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from quinoa_tpu.base.xlacache import enable_compile_cache

    enable_compile_cache()

    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.amr import refine_mesh, tag_edges_by_error
    from quinoa_tpu.amr.refine import transfer_cg
    from quinoa_tpu.pde.cg import make_cggeom

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    mesh = box_tet_mesh(n, n, n)

    # error field: a sharp spherical front tags a band of edges
    x = mesh.coords
    r = np.sqrt(((x - 0.5) ** 2).sum(axis=1))
    u = np.exp(-((r - 0.3) / 0.05) ** 2)[None, :]

    t0 = time.perf_counter()
    tags = tag_edges_by_error(mesh, u, method="jump", tol=0.2)
    t_tag = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh2, rmap = refine_mesh(mesh, tags)
    t_ref = time.perf_counter() - t0

    t0 = time.perf_counter()
    u2 = transfer_cg(rmap, u)
    t_xfer = time.perf_counter() - t0

    t0 = time.perf_counter()
    geom = make_cggeom(mesh2)
    t_build = time.perf_counter() - t0

    assert u2.shape[1] == mesh2.nnode
    total = t_tag + t_ref + t_xfer + t_build
    print(json.dumps({
        "metric": "amr_remesh_wall_clock",
        "value": round(total, 4),
        "unit": "s",
        "nelem_before": mesh.nelem,
        "nelem_after": mesh2.nelem,
        "tag_s": round(t_tag, 4),
        "refine_s": round(t_ref, 4),
        "transfer_s": round(t_xfer, 4),
        "rebuild_s": round(t_build, 4),
    }))


if __name__ == "__main__":
    main()

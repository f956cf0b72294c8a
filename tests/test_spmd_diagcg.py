"""Sharded (SPMD) DiagCG vs single-shard reference results.

The distributed analog of the reference's asynclogic suite (SURVEY.md §4.2):
run the same problem on 1 shard and on a virtual 8-device mesh and require
agreement to tight tolerances (bitwise equality is not expected because
scatter/psum change floating-point summation order).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.pde.cg import CGTransport, make_cggeom
from quinoa_tpu.pde.problems import SlotCyl
from quinoa_tpu.inciter import DiagCGSolver
from quinoa_tpu.parallel import build_cg_shards, SPMDDiagCGSolver, partition_elements
from quinoa_tpu.parallel.shard import gather_global_field


@pytest.fixture(scope="module")
def problem_setup():
    mesh = box_tet_mesh(8, 8, 4, hi=(1.0, 1.0, 0.5))
    bc = mesh.all_bnodes()
    return mesh, bc


def test_partitioners_balanced(problem_setup):
    mesh, _ = problem_setup
    for algo in ("sfc", "rcb"):
        part = partition_elements(mesh.coords, mesh.inpoel, 8, algo)
        counts = np.bincount(part, minlength=8)
        assert counts.sum() == mesh.nelem
        assert counts.max() - counts.min() <= 1, algo


@pytest.mark.parametrize("nshard", [
    2, pytest.param(8, marks=pytest.mark.slow)])
def test_spmd_matches_single_shard(problem_setup, nshard):
    mesh, bc = problem_setup
    system = CGTransport(SlotCyl())

    # single-shard reference
    solver1 = DiagCGSolver(system, make_cggeom(mesh), cfl=0.5, bcnodes=bc)
    s1 = solver1.initial_state()
    for _ in range(3):
        s1 = solver1.step(s1)

    # sharded
    sharded = build_cg_shards(mesh, nshard, ncomp=1, bcnodes=bc)
    devices = np.array(jax.devices()[:nshard])
    dmesh = Mesh(devices, ("shard",))
    solverN = SPMDDiagCGSolver(system, sharded, dmesh, cfl=0.5)
    sN = solverN.initial_state()
    for _ in range(3):
        sN = solverN.step(sN)

    assert np.isclose(float(np.asarray(sN.t).ravel()[0]), float(np.asarray(s1.t).ravel()[0]), rtol=1e-12)

    uN = gather_global_field(sharded, np.asarray(sN.u))
    u1 = np.asarray(s1.u)  # (C, N)
    err = np.abs(uN - u1).max()
    assert err < 1e-10, f"max |sharded - single| = {err}"


def test_spmd_diagnostics(problem_setup):
    mesh, bc = problem_setup
    system = CGTransport(SlotCyl())
    sharded = build_cg_shards(mesh, 4, ncomp=1, bcnodes=bc)
    dmesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    solver = SPMDDiagCGSolver(system, sharded, dmesh, cfl=0.5)
    s = solver.initial_state()
    s = solver.step(s)
    l2sol, l2err, linferr = solver.diagnostics(s)
    assert np.isfinite(l2sol).all() and l2sol[0] > 0.01
    assert np.isfinite(l2err).all()
    assert linferr[0] < 1.0


def test_neighbor_halo_volume_scales(problem_setup):
    """ppermute halo traffic is O(local boundary): per-device exchange
    width (sum of per-offset slab lengths) stays below the GLOBAL
    interface size the old buffer-psum moved, and does not grow with the
    shard count (SURVEY §5.8; DiagCG.cpp:309-321 per-neighbor comrhs)."""
    from quinoa_tpu.parallel import build_cg_shards

    mesh, _ = problem_setup
    widths, nbs = {}, {}
    for S in (2, 4, 8):
        sh = build_cg_shards(mesh, S, ncomp=1)
        assert sh.nhalo is not None
        widths[S] = sum(sh.nhalo.Ls)
        nbs[S] = sh.nb
    # doubling the shard count must not grow per-device traffic (the
    # buffer-psum cost is ~2*(nb+1) per device and nb GROWS with S)
    assert widths[8] <= 1.05 * widths[4] and widths[4] <= 1.05 * widths[2], \
        widths
    assert widths[8] < 2 * (nbs[8] + 1), (widths, nbs)
    assert nbs[8] > nbs[2]  # the global interface the psum moved does grow


_TRANSPORT = """
inciter
  nstep 2
  scheme {scheme}
  transport
    physics advection problem slot_cyl ncomp 1 depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
end
"""


@pytest.mark.parametrize("scheme", ["diagcg", "alecg", "dgp1"])
def test_spmd_tables_live_on_every_device(scheme):
    """The sharded geometry tables are laid over the device mesh when the
    solver is built.  Left on one device, every step would copy them out
    to the others before it could run."""
    from quinoa_tpu.control.config import build_inciter_spmd, load_inciter

    cfg = load_inciter(_TRANSPORT.format(scheme=scheme))
    solver = build_inciter_spmd(cfg, box_tet_mesh(4, 4, 4), 4)
    devices = set(solver.mesh.devices.flat)
    for leaf in jax.tree_util.tree_leaves(solver.sharded):
        assert leaf.sharding.device_set == devices
        assert not leaf.sharding.is_fully_replicated

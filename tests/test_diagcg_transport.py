"""End-to-end DiagCG + FCT scalar transport tests (the minimum slice).

Mirrors the reference's simplest regression family
(tests/regression/inciter/transport/SlotCyl, GaussHump): conservation,
FCT monotonicity, and analytic-error accuracy after real time stepping.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.pde.cg import CGTransport, make_cggeom
from quinoa_tpu.pde.problems import SlotCyl, GaussHump, CylAdvect
from quinoa_tpu.inciter import DiagCGSolver, Diagnostics


@pytest.fixture(scope="module")
def slotcyl_setup():
    mesh = box_tet_mesh(16, 16, 4, hi=(1.0, 1.0, 0.25))
    geom = make_cggeom(mesh)
    system = CGTransport(SlotCyl())
    bc = mesh.all_bnodes()
    solver = DiagCGSolver(system, geom, cfl=0.8, bcnodes=bc)
    return mesh, geom, system, solver


def test_initial_condition(slotcyl_setup):
    mesh, geom, system, solver = slotcyl_setup
    s = solver.initial_state()
    u = np.asarray(s.u)
    assert u.shape == (1, mesh.nnode)
    assert u.min() >= 0.0 and u.max() <= 0.8
    # cone + hump + slotted cylinder all present
    assert (u > 0.5).any()


def test_dt_positive(slotcyl_setup):
    _, geom, system, solver = slotcyl_setup
    s = solver.initial_state()
    dt = float(solver.compute_dt(s.u))
    assert 0 < dt < 1.0


def test_fct_monotone(slotcyl_setup):
    mesh, geom, system, solver = slotcyl_setup
    s = solver.initial_state()
    u0 = np.asarray(s.u)

    s = solver.nsteps(s, 20)
    u = np.asarray(s.u)
    assert np.isfinite(u).all()

    # FCT keeps the solution within the initial bounds (monotone)
    eps = 1e-10
    assert u.min() >= u0.min() - eps
    assert u.max() <= u0.max() + eps


def test_fct_conservative_without_bc():
    """Without Dirichlet nodes the TG+FCT update conserves sum(u*vol) exactly:
    rhs, mass diffusion, and limited AECs all telescope to zero."""
    mesh = box_tet_mesh(10, 10, 3, hi=(1.0, 1.0, 0.3))
    geom = make_cggeom(mesh)
    solver = DiagCGSolver(CGTransport(SlotCyl()), geom, cfl=0.5, bcnodes=None)
    s = solver.initial_state()
    m0 = float((s.u[0] * geom.vol).sum())
    s = solver.nsteps(s, 10)
    m = float((s.u[0] * geom.vol).sum())
    assert abs(m - m0) / abs(m0) < 1e-12


def test_slotcyl_error_small(slotcyl_setup):
    mesh, geom, system, solver = slotcyl_setup
    s = solver.initial_state()
    diag = Diagnostics(system, geom)
    s = solver.nsteps(s, 40)
    row = diag.compute(s)
    # coarse mesh: just require the L2 error stays small vs the solution norm
    assert row.l2err[0] < 0.7 * row.l2sol[0]
    assert row.l2sol[0] > 0.05


def test_gausshump_accuracy():
    """Smooth-profile transport: verify accuracy against analytic solution."""
    mesh = box_tet_mesh(16, 16, 2, hi=(1.0, 1.0, 0.125))
    geom = make_cggeom(mesh)
    system = CGTransport(GaussHump())
    solver = DiagCGSolver(system, geom, const_dt=0.02,
                          bcnodes=mesh.all_bnodes())
    s = solver.initial_state()
    diag = Diagnostics(system, geom)
    s = solver.nsteps(s, 50)  # t = 1.0, hump center at (0.35, 0.35)
    row = diag.compute(s)
    assert abs(row.t - 1.0) < 1e-12
    assert row.l2sol[0] > 0.02  # hump still present
    assert row.l2err[0] < 0.5 * row.l2sol[0]


def test_no_fct_matches_high_order_update():
    """With fct disabled the update is u + rhs/lhs (plain lumped TG)."""
    mesh = box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.33))
    geom = make_cggeom(mesh)
    system = CGTransport(CylAdvect())
    solver = DiagCGSolver(system, geom, cfl=0.5, fct=False,
                          bcnodes=mesh.all_bnodes())
    s = solver.initial_state()
    s1 = solver.step(s)
    assert np.isfinite(np.asarray(s1.u)).all()
    assert float(s1.t) > 0

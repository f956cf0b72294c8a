"""DG stack tests: basis/quadrature identities, transport, Euler (Sod,
TaylorGreen, VorticalFlow), limiters, p-adaptivity.

Mirrors the reference regression coverage for DG schemes
(tests/regression/inciter/{transport,compflow}/...) at smoke scale.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.quadrature import gauss_tet, gauss_tri
from quinoa_tpu.pde.dg import (
    build_dggeom,
    dg_initialize,
    dg_cell_avg,
    BC_DIRICHLET,
    BC_SYMMETRY,
    BC_EXTRAPOLATE,
)
from quinoa_tpu.pde.dg_compflow import DGCompFlow, DGTransport
from quinoa_tpu.pde.problems import (
    GaussHump,
    SodShocktube,
    TaylorGreen,
    VorticalFlow,
    SedovBlastwave,
)
from quinoa_tpu.inciter.dg import DGSolver, DGDiagnostics


def test_quadrature_exactness():
    """Rules integrate polynomials exactly to their design degree on the
    reference simplex (weights normalized to measure 1)."""
    # tet: f = x^2*y (degree 3) over ref tet; exact = int/V
    def tet_int(f, ng):
        p, w = gauss_tet(ng)
        return (w * f(p[:, 0], p[:, 1], p[:, 2])).sum()

    # exact integral of x^2*y over unit tet = 1/360; V = 1/6 -> mean = 1/60
    exact = 1.0 / 60.0
    for ng in (5, 11, 14):
        assert np.isclose(tet_int(lambda x, y, z: x * x * y, ng), exact), ng

    def tri_int(f, ng):
        p, w = gauss_tri(ng)
        return (w * f(p[:, 0], p[:, 1])).sum()

    # x*y over unit triangle = 1/24; area 1/2 -> mean = 1/12
    for ng in (3, 4, 6):
        assert np.isclose(tri_int(lambda x, y: x * y, ng), 1.0 / 12.0), ng


@pytest.fixture(scope="module")
def small_mesh():
    return box_tet_mesh(4, 4, 4)


def test_dg_projection_exact_for_linear(small_mesh):
    """P1 L2 projection reproduces a linear field exactly; cell average
    equals the field at the centroid."""

    class LinField:
        ncomp = 1

        def solution(self, xyz, t):
            return (1.0 + 2.0 * xyz[0] - 3.0 * xyz[1] + 0.5 * xyz[2])[None]

        def initialize(self, xyz, t):
            return self.solution(xyz, t)

    geom = build_dggeom(small_mesh, ndof=4)
    sys_ = LinField()
    u = dg_initialize(sys_, geom, 0.0)
    # evaluate at centroid = cell avg (feature-major: node0 (3,E), Jmat (3,3,E))
    ctr = np.asarray(geom.node0) + np.asarray(geom.Jmat).sum(axis=1) / 4.0
    expect = 1.0 + 2.0 * ctr[0] - 3.0 * ctr[1] + 0.5 * ctr[2]
    assert np.allclose(np.asarray(dg_cell_avg(u, 1, 4))[0], expect, atol=1e-12)


def test_dg_transport_gausshump_p1(small_mesh):
    mesh = box_tet_mesh(10, 10, 2, hi=(1.0, 1.0, 0.2))
    geom = build_dggeom(mesh, ndof=4,
                        bc_sidesets={i: BC_DIRICHLET for i in range(1, 7)})
    system = DGTransport(GaussHump())
    solver = DGSolver(system, geom, cfl=0.8)
    s = solver.initial_state()
    diag = DGDiagnostics(system, geom)
    s = solver.nsteps(s, 20)
    l2sol, l2err, linferr = diag.compute(s)
    u = np.asarray(s.u)
    assert np.isfinite(u).all()
    assert float(s.t) > 0.05
    assert l2err[0] < 0.5 * l2sol[0]


@pytest.mark.slow
def test_dg_sod_p0_and_p1():
    """Sod tube: P0 (finite volume) and P1+Superbee stay in physical bounds
    and develop the correct wave structure."""
    mesh = box_tet_mesh(48, 2, 2, hi=(1.0, 0.05, 0.05))
    prob = SodShocktube()
    bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          3: BC_SYMMETRY, 4: BC_SYMMETRY, 5: BC_SYMMETRY, 6: BC_SYMMETRY}

    for ndof, lim, steps in [(1, None, 40), (4, "superbeep1", 40)]:
        geom = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
        system = DGCompFlow(prob, riemann_flux="hllc")
        solver = DGSolver(system, geom, cfl=0.8, limiter=lim)
        s = solver.nsteps(solver.initial_state(), steps)
        u = np.asarray(s.u)
        assert np.isfinite(u).all(), (ndof, lim)
        from quinoa_tpu.pde.dg import dg_cell_avg
        avg = np.asarray(dg_cell_avg(jnp.asarray(u), 5, ndof))
        rho = avg[0]
        assert rho.min() > 0.11 and rho.max() < 1.05, (ndof, rho.min(), rho.max())
        p = np.asarray(prob.eos.pressure_cons_cm(jnp.asarray(avg)))
        assert p.min() > 0.0
        # shock moving right: positive x-momentum developed in the middle
        assert avg[1].max() > 0.1
        assert float(s.t) > 0.005


@pytest.mark.slow
def test_dg_taylor_green_p1_accuracy():
    mesh = box_tet_mesh(6, 6, 2, hi=(1.0, 1.0, 0.33))
    geom = build_dggeom(mesh, ndof=4,
                        bc_sidesets={i: BC_DIRICHLET for i in range(1, 7)})
    system = DGCompFlow(TaylorGreen(), riemann_flux="laxfriedrichs")
    solver = DGSolver(system, geom, cfl=0.5)
    s = solver.nsteps(solver.initial_state(), 10)
    diag = DGDiagnostics(system, geom)
    l2sol, l2err, _ = diag.compute(s)
    u = np.asarray(s.u)
    assert np.isfinite(u).all()
    scale = max(l2sol)
    for c in range(5):
        assert l2err[c] / max(l2sol[c], 0.01 * scale) < 0.06, (c, l2err[c])


@pytest.mark.slow
def test_dg_sedov_p1_limited():
    """Sedov blast (the north-star config): DG(P1) + Superbee, corner
    ignition, must stay finite with positive density."""
    mesh = box_tet_mesh(8, 8, 2, hi=(0.4, 0.4, 0.1))
    bc = {i: BC_SYMMETRY for i in range(1, 7)}
    geom = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    solver = DGSolver(system, geom, cfl=0.5, limiter="superbeep1")
    s = solver.nsteps(solver.initial_state(), 20)
    u = np.asarray(s.u)
    assert np.isfinite(u).all()
    from quinoa_tpu.pde.dg import dg_cell_avg
    assert np.asarray(dg_cell_avg(jnp.asarray(u), 5, 4))[0].min() > 0.0
    assert float(s.t) > 0.0


@pytest.mark.slow
def test_dg_p_adaptive_flags_shock():
    """p-adaptive DG drops smooth cells to P0 and keeps P1 at the front."""
    # 25 cells: the x=0.5 jump cuts through cell interiors (with 24 cells
    # it falls exactly on a mesh plane and the projection is slope-free)
    mesh = box_tet_mesh(25, 2, 2, hi=(1.0, 0.1, 0.1))
    bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
          3: BC_SYMMETRY, 4: BC_SYMMETRY, 5: BC_SYMMETRY, 6: BC_SYMMETRY}
    geom = build_dggeom(mesh, ndof=4, bc_sidesets=bc)
    system = DGCompFlow(SodShocktube())
    solver = DGSolver(system, geom, cfl=0.5, limiter="superbeep1",
                      pref=True, tolref=0.2)
    s = solver.nsteps(solver.initial_state(), 5)
    nd = np.asarray(s.ndofel)
    assert set(np.unique(nd)) <= {1, 4}
    assert (nd == 1).any(), "smooth cells should drop to P0"
    assert (nd == 4).any(), "discontinuity cells should stay P1"


@pytest.mark.slow
def test_dg_p2_vortical_flow():
    """DG(P2) runs and is more accurate than P1 on the smooth vortical
    flow."""
    mesh = box_tet_mesh(3, 3, 3, lo=(-0.5, -0.5, -0.5), hi=(0.5, 0.5, 0.5))
    bc = {i: BC_DIRICHLET for i in range(1, 7)}
    errs = {}
    for ndof in (4, 10):
        geom = build_dggeom(mesh, ndof=ndof, bc_sidesets=bc)
        system = DGCompFlow(VorticalFlow(), riemann_flux="laxfriedrichs")
        solver = DGSolver(system, geom, cfl=0.5)
        s = solver.nsteps(solver.initial_state(), 5)
        diag = DGDiagnostics(system, geom)
        _, l2err, _ = diag.compute(s)
        assert np.isfinite(np.asarray(s.u)).all(), ndof
        errs[ndof] = l2err[4]  # energy error
    assert errs[10] < errs[4]

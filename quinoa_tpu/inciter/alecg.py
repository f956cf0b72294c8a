"""ALECG: node-centered RK3 Galerkin scheme with edge-based dissipation.

The reference fork ships ALECG as a communication scaffold whose physics
is stubbed out (src/Inciter/ALECG.cpp:289-311 rhs body and 343-372
`m_du = m_rhs / m_lhs` are commented), with the lumped-mass lhs, dt, and
comm structure in place.  This module supplies the full scheme the
scaffold intends (BASELINE.md's ALECG north star), as array programs:

- lumped-mass P1 Galerkin volume term: for element e the divergence of
  the linearly-interpolated flux is constant, so node a receives
  -(V_e/4) sum_b grad_b . F(u_b) — one gather + one table-assembled sum;
- edge-based Rusanov dissipation over the psup edge graph:
  R_a += sum_edges A_ab lambda_ab (u_b - u_a), with A_ab = 2 m_ab/h_ab
  built from the consistent-mass off-diagonal m_ab = sum_e J_e/120 (the
  dual-face area scale) and lambda_ab the max characteristic speed of the
  two nodes — pairwise antisymmetric, hence conservative;
- SSP-RK3 stages u = rk0 un + rk1 (u + dt R/M_L) (same coefficients as
  the DG solver, DG.cpp:39-40);
- Dirichlet BCs pin nodes to the analytic solution per stage.

State fields are feature-major (C, N) like DiagCG.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.derived import gen_inpoed
from ..ops.assembly import build_nsup, gather_nodes, assemble_add
from ..pde.cg import CGGeom, lumped_mass, make_cggeom
from .diagcg import CGState

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["edges", "A", "ensup", "xyz"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class EdgeTables:
    """Edge graph for the dissipation operator.

    edges : (2, nedge) i32 endpoints
    A     : (nedge,)   dual-face area scale 2*m_ab/h_ab
    ensup : (D, N) i32 edge-slot assembly table (slots: side*nedge+edge)
    xyz   : (2, 3, nedge) static endpoint coordinates (keeps the
            charspeed coordinate lookup out of the per-step program)
    """

    edges: jnp.ndarray
    A: jnp.ndarray
    ensup: jnp.ndarray
    xyz: "jnp.ndarray | None" = None


def edge_arrays_np(coords: np.ndarray, inpoel: np.ndarray, nnode: int):
    """Host-side edge graph arrays for the dissipation operator.

    Returns (edges (nE, 2) int64 lo<hi, A (nE,) f64, ensup (D, nnode)
    int32, D).  A is the per-edge dual-face area scale 2*m_ab/h_ab with
    m_ab summed over the GIVEN elements only — so per-shard calls yield
    partial sums that add up to the global coefficient across shards
    (each element lives on exactly one shard), matching the partial-sum
    halo-combine convention of every other CG assembly.
    """
    from ..mesh.geometry import tet_geometry
    from ..mesh.derived import _TET_EDGES

    edges = gen_inpoed(inpoel).astype(np.int64)  # (nE,2) lo<hi
    nE = len(edges)
    # gen_inpoed's unique() output is lexsorted, so the packed keys are
    # ascending and the edge lookup is a vectorized searchsorted (the
    # dict-LUT scan was ~10 s of host time per build at 64^3)
    key = edges[:, 0] << 32 | edges[:, 1]

    # consistent-mass off-diagonal sums m_ab = sum_e J_e/120 over elements
    # containing edge (a,b)
    J, _ = tet_geometry(coords, inpoel)
    m = np.zeros(nE)
    inp = inpoel.astype(np.int64)
    for le in range(6):
        a = inp[:, _TET_EDGES[le, 0]]
        b = inp[:, _TET_EDGES[le, 1]]
        k = np.minimum(a, b) << 32 | np.maximum(a, b)
        idx = np.searchsorted(key, k)
        np.add.at(m, idx, J / 120.0)

    h = np.linalg.norm(coords[edges[:, 1]] - coords[edges[:, 0]], axis=1)
    A = 2.0 * m / h

    ensup, D = build_nsup(edges.astype(np.int32), nnode)
    return edges, A, ensup, D


def build_edge_tables(mesh, dtype=None) -> EdgeTables:
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    edges, A, ensup, _ = edge_arrays_np(mesh.coords, mesh.inpoel, mesh.nnode)
    xyz = np.stack([mesh.coords[edges[:, 0]].T, mesh.coords[edges[:, 1]].T])
    return EdgeTables(
        edges=jnp.asarray(edges.T, dtype=jnp.int32),
        A=jnp.asarray(A, dtype=dtype),
        ensup=jnp.asarray(ensup),
        xyz=jnp.asarray(xyz, dtype=dtype),
    )


def alecg_flux_rhs(system, geom, u):
    """Galerkin volume rhs: R_a -= (V_e/4) sum_b grad_b . F(u_b)."""
    from ..pde.cg import cg_coords_n

    un = gather_nodes(u, geom.inpoelT)  # (4, C, E)
    cn = cg_coords_n(geom)  # static cache: no per-step coords gather
    divF = None
    for b in range(4):
        fb = system.flux_at_nodes(un[b], cn[b])
        d = sum(geom.grad[b, j] * fb[j] for j in range(3))
        divF = d if divF is None else divF + d
    w = (geom.J * geom.emask) / 24.0  # V/4
    contrib = jnp.broadcast_to((-w * divF)[None], (4,) + divF.shape)
    return assemble_add(contrib, geom.nsup)


def alecg_dissipation(system, geom, edges, A, ensup, u, exyz=None):
    """Edge Rusanov: R_a += A_ab lambda_ab (u_b - u_a); exyz is the
    optional static endpoint-coordinate cache (2, 3, nE)."""
    a, b = edges[0], edges[1]
    ua = u[:, a]
    ub = u[:, b]
    xa = exyz[0] if exyz is not None else geom.coords[:, a]
    xb = exyz[1] if exyz is not None else geom.coords[:, b]
    lam = jnp.maximum(
        system.charspeed(ua, xa),
        system.charspeed(ub, xb),
    )
    d = A * lam * (ub - ua)  # (C, nE)
    contrib = jnp.stack([d, -d])  # slot 0 -> node a, slot 1 -> node b
    return assemble_add(contrib, ensup)


class ALECGSolver:
    """RK3 node-centered solver (static mesh; the ALE mesh-motion hooks of
    the scheme reduce to the Eulerian frame with zero mesh velocity)."""

    def __init__(
        self,
        system,
        geom: CGGeom,
        edget: EdgeTables,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        bcnodes=None,
    ):
        self.system = system
        self.geom = geom
        self.edget = edget
        self.cfl = cfl
        self.const_dt = const_dt
        # time-independent-velocity transport: the dt sweep is a run
        # constant (same cache as DiagCGSolver)
        self._static_dt = None

        ncomp = system.ncomp
        bcmask = jnp.zeros((ncomp, geom.nnode), dtype=geom.vol.dtype)
        if bcnodes is not None and len(bcnodes) > 0:
            bcmask = bcmask.at[:, jnp.asarray(bcnodes, dtype=jnp.int32)].set(1.0)
        self.bcmask = bcmask
        self.lhs = lumped_mass(geom)
        if const_dt is None and getattr(system, "static_dt", None):
            u0 = system.initialize(geom.coords, 0.0).astype(
                geom.vol.dtype)
            self._static_dt = (system.dt(geom, u0)
                               * jnp.asarray(cfl / 3.0, geom.vol.dtype))
        self._step = jax.jit(self._step_impl)

    # -- public API -----------------------------------------------------------

    def initial_state(self, t0: float = 0.0) -> CGState:
        u0 = self.system.initialize(self.geom.coords, t0)
        dtype = self.geom.vol.dtype
        return CGState(
            u=u0.astype(dtype),
            t=jnp.asarray(t0, dtype=dtype),
            it=jnp.asarray(0, dtype=jnp.int32),
            dt=jnp.asarray(0.0, dtype=dtype),
        )

    def step(self, state: CGState) -> CGState:
        return self._step(self.geom, self.edget, self.lhs, self.bcmask,
                          state)

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def _step_impl(self, geom, edget, lhs, bcmask,
                   state: CGState) -> CGState:
        if self.const_dt is not None:
            dt = jnp.asarray(self.const_dt, dtype=geom.vol.dtype)
        elif self._static_dt is not None:
            dt = self._static_dt
        else:
            dt = self.system.dt(geom, state.u) * self.cfl / 3.0  # RK3 CFL

        un = state.u
        u = state.u
        # SSP-RK3 stage times: sources evaluate at the INPUT state's
        # time (t, t+dt, t+dt/2); each stage's OUTPUT represents
        # (t+dt, t+dt/2, t+dt) — the Dirichlet pin uses the latter
        ts = (state.t, state.t + dt, state.t + 0.5 * dt)
        to = (state.t + dt, state.t + 0.5 * dt, state.t + dt)
        for s in range(3):
            r = alecg_flux_rhs(self.system, geom, u) + alecg_dissipation(
                self.system, geom, edget.edges, edget.A, edget.ensup, u,
                exyz=edget.xyz,
            )
            if getattr(self.system.problem, "manufactured", False):
                # nodal-quadrature manufactured source: node i receives
                # V_i s(x_i, t_stage) (lumped-mass consistent)
                r = r + geom.vol[None, :] * self.system.problem.src(
                    geom.coords, ts[s]).astype(u.dtype)
            u = RK0[s] * un + RK1[s] * (u + dt * r / lhs[None, :])
            # Dirichlet: pin to the analytic solution at the stage time
            ubc = self.system.analytic(geom.coords, to[s]).astype(u.dtype)
            u = jnp.where(bcmask > 0, ubc, u)

        return CGState(u=u, t=state.t + dt, it=state.it + 1, dt=dt)


def make_alecg(system, mesh, cfl=0.5, const_dt=None, bcnodes=None):
    """Convenience builder: geometry + edge tables + solver."""
    geom = make_cggeom(mesh)
    edget = build_edge_tables(mesh, dtype=geom.vol.dtype)
    return ALECGSolver(system, geom, edget, cfl=cfl, const_dt=const_dt,
                       bcnodes=bcnodes)

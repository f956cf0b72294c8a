"""DG solver driver: SSP-RK3 stepping with limiting and p-adaptivity
(feature-major layout).

Counterpart of the reference's DG chare array (src/Inciter/DG.cpp): the
per-stage SDAG pipeline (comsol -> lim -> dt -> solve) becomes a pure
jitted step: per stage, limit, (stage 0 only) evaluate p-adaptive dofs and
the global min dt, evaluate the rhs, and apply the RK update

    u = rk0[s]*un + rk1[s]*(u + dt*rhs/M)      (DG.cpp:39-40, 1479-1488)

with the block-diagonal mass matrix diagonal in the orthogonal Dubiner
basis (M_k = vol*mnorm_k).  The modal state is (C*K, E).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..pde.dg import (
    DGGeom, dg_rhs, dg_dt, dg_initialize, uview, _phys_gp,
)
from ..pde.limiter import weno_p1, superbee_p1
from ..ops.basis import eval_basis
from ..ops.quadrature import gauss_tet, ng_diag

RK0 = (0.0, 3.0 / 4.0, 1.0 / 3.0)
RK1 = (1.0, 1.0 / 4.0, 2.0 / 3.0)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["u", "ndofel", "t", "it", "dt"],
    meta_fields=[],
)
@dataclasses.dataclass
class DGState:
    u: jnp.ndarray  # (C*K, E)
    ndofel: jnp.ndarray  # (E,) int32 active dofs (p-adaptive)
    t: jnp.ndarray
    it: jnp.ndarray
    dt: jnp.ndarray


class DGSolver:
    """Cell-centered DG(P0/P1/P2) solver on a single shard.

    limiter : None | 'wenop1' | 'superbeep1'
    pref    : p-adaptive DG (P1 <-> P0 by gradient indicator,
              DG.cpp:1088-1163); tolref is the threshold.
    """

    def __init__(
        self,
        system,
        geom: DGGeom,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        limiter: Optional[str] = None,
        cweight: float = 30.0,
        pref: bool = False,
        tolref: float = 0.1,
        evolve_ndof: Optional[int] = None,
    ):
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.const_dt = const_dt
        if limiter not in (None, "wenop1", "superbeep1"):
            raise ValueError(f"unknown limiter {limiter!r}")
        if limiter is not None and geom.ndof < 4:
            raise ValueError("limiters require ndof >= 4")
        self.limiter = limiter
        self.cweight = cweight
        self.pref = pref
        self.tolref = tolref
        # rDG(PnPm): evolve only the first `evolve_ndof` dofs while faces
        # and limiters see all geom.ndof (rdof) dofs — P0P1 has
        # evolve_ndof=1, rdof=4 (Grammar.hpp:368-385, DG.cpp:1479-1488
        # updates k < ndof only); the CFL scale uses the EVOLVED order
        # (DG.cpp:1404-1418)
        self.evolve_ndof = evolve_ndof or geom.ndof
        p = {1: 0.0, 4: 1.0, 10: 2.0}[self.evolve_ndof]
        self.cflscale = 1.0 / (2.0 * p + 1.0)
        # face Gauss-point coordinates are only needed when the system
        # samples them (transport velocity fields) or a coordinate bc
        # (Dirichlet/inlet) is present on some face
        import numpy as _np

        from ..pde.dg import BC_DIRICHLET, BC_INLET

        bct = _np.asarray(geom.bctype)
        self.needs_face_gp = bool(
            getattr(system, "needs_face_gp", True)
            or _np.isin(bct, [BC_DIRICHLET, BC_INLET]).any()
        )
        # geometry is passed as a jit ARGUMENT (not captured in the closure)
        # so the mesh tables are runtime parameters, not giant HLO constants
        # that would have to be shipped to and folded by the compiler.
        self._step = jax.jit(self._step_impl)

    # -- helpers --------------------------------------------------------------

    def _dofmask(self, ndofel):
        K = self.geom.ndof
        k = jnp.arange(K)[:, None]
        return (k < ndofel[None, :]).astype(self.geom.vol.dtype)

    def _limit(self, geom, u, dofmask):
        C = self.system.ncomp
        if self.limiter == "wenop1":
            return weno_p1(geom, u, dofmask, C, self.cweight)
        if self.limiter == "superbeep1":
            return superbee_p1(geom, u, dofmask, C)
        return u

    def _eval_ndof(self, geom, u, ndofel):
        from ..pde.dg import eval_ndof_sticky

        return eval_ndof_sticky(geom, u, ndofel, self.system.ncomp,
                                self.tolref)

    def _propagate_ndof(self, geom, ndofel):
        from ..pde.dg import propagate_ndof

        return propagate_ndof(geom, ndofel)

    # -- public API -----------------------------------------------------------

    def initial_state(self, t0: float = 0.0) -> DGState:
        u0 = dg_initialize(self.system, self.geom, t0)
        dtype = self.geom.vol.dtype
        ndofel = jnp.full((self.geom.nelem,), self.geom.ndof, dtype=jnp.int32)
        return DGState(
            u=u0.astype(dtype),
            ndofel=ndofel,
            t=jnp.asarray(t0, dtype=dtype),
            it=jnp.asarray(0, dtype=jnp.int32),
            dt=jnp.asarray(0.0, dtype=dtype),
        )

    def step(self, state: DGState) -> DGState:
        return self._step(self.geom, state)

    def nsteps(self, state: DGState, n: int) -> DGState:
        """n steps by repeated dispatch of the compiled step (async
        dispatch pipelines on device; a lax.scan would recompile the whole
        step body as one giant program)."""
        for _ in range(n):
            state = self._step(self.geom, state)
        return state

    # -- implementation -------------------------------------------------------

    def _minv(self, geom, dofmask):
        K = geom.ndof
        mn = jnp.asarray(geom.tables["mnorm"], dtype=geom.vol.dtype)
        inv = 1.0 / (geom.vol[None, :] * mn[:, None])  # (K,E)
        return jnp.tile(inv, (self.system.ncomp, 1))  # (C*K, E)

    def _step_impl(self, geom: DGGeom, state: DGState) -> DGState:
        g = geom
        un = state.u
        u = state.u
        ndofel = state.ndofel
        dt = state.dt

        for s in range(3):
            if s == 0 and self.pref and g.ndof >= 4:
                ndofel = self._eval_ndof(g, u, ndofel)
                ndofel = self._propagate_ndof(g, ndofel)
            # dofmask None = every dof active (non-p-adaptive): saves the
            # per-face mask gathers and full-size multiplies in dg_rhs
            dofmask = self._dofmask(ndofel) if self.pref else None
            with jax.named_scope("limiter"):
                u = self._limit(g, u, dofmask)
            if s == 0 and self.pref and dofmask is not None:
                # coarsened elements' high-order dofs are ZEROED at stage
                # 0 (DG.cpp:1452-1469), not frozen: a later ring promotion
                # restarts them from clean P0 state
                u = u * jnp.tile(dofmask, (self.system.ncomp, 1))
            if s == 0:
                # the RK anchor is the LIMITED stage-0 solution — the
                # reference sets m_un = m_u after lim() (DG.cpp:1471);
                # anchoring the unlimited state re-blends unlimited
                # slopes into stages 1-2 wherever the limiter is active
                un = u
                if self.const_dt is not None:
                    dt = jnp.asarray(self.const_dt, dtype=g.vol.dtype)
                else:
                    with jax.named_scope("dg_dt"):
                        dt = dg_dt(self.system, g, u, dofmask) * (
                            self.cfl * self.cflscale
                        )
            r = dg_rhs(self.system, g, u, dofmask, state.t,
                       face_gp=self.needs_face_gp)
            minv = self._minv(g, dofmask)
            unew = RK0[s] * un + RK1[s] * (u + dt * r * minv)
            if self.evolve_ndof < g.ndof:
                # rDG: only the evolved dofs advance; reconstructed dofs
                # keep their current (initial-projection + limiter) values
                kk = jnp.tile(jnp.arange(g.ndof), self.system.ncomp)
                unew = jnp.where(
                    (kk < self.evolve_ndof)[:, None], unew, u
                )
            u = unew
            if dofmask is not None:
                dmflat = jnp.tile(dofmask, (self.system.ncomp, 1))
                u = jnp.where(dmflat > 0, u, un)

        return DGState(u=u, ndofel=ndofel, t=state.t + dt, it=state.it + 1,
                       dt=dt)


class DGDiagnostics:
    """Element diagnostics: L2 norms via NGdiag-point quadrature
    (ElemDiagnostics.cpp)."""

    def __init__(self, system, geom: DGGeom):
        self.system = system
        self.geom = geom
        pts, w = gauss_tet(ng_diag(geom.ndof))
        dtype = geom.vol.dtype
        self.pts = np.asarray(pts)
        self.w = np.asarray(w)
        self.B = np.asarray(eval_basis(geom.ndof, jnp.asarray(pts)))  # (G,K)
        self.total_vol = float((geom.vol * geom.emask).sum())

    def compute(self, state: DGState):
        g = self.geom
        C, K = self.system.ncomp, g.ndof
        Uv = uview(state.u, C, K)
        # evaluate with the per-element active dofs only: P0-dropped
        # elements carry stale high-order dofs that the reference never
        # reads (ElemDiagnostics.cpp:171-196 uses ndofel[e]); and their
        # ERROR is integrated at the single NGdiag(1) centroid point
        # (Quadrature.hpp:45-50).  Both only arise for p-adaptive runs:
        # K==1 schemes already use the 1-point rule, and p0p1/dgp2 keep
        # ndofel == K everywhere.
        mixed = K > 1 and bool((np.asarray(state.ndofel) == 1).any())
        if mixed:
            kmask = (jnp.arange(K)[None, :, None]
                     < state.ndofel[None, None, :]).astype(state.u.dtype)
            Uv = Uv * kmask
        p0 = ((state.ndofel == 1) & (g.emask > 0)) if mixed else None
        ve = g.vol * g.emask
        s2 = jnp.zeros((C,), dtype=state.u.dtype)
        e2 = jnp.zeros((C,), dtype=state.u.dtype)
        einf = jnp.zeros((C,), dtype=state.u.dtype)
        for gi in range(len(self.w)):
            B = jnp.asarray(self.B[gi], dtype=state.u.dtype)[:, None]
            sgp = (Uv * B).sum(axis=1)  # (C,E)
            gp = _phys_gp(
                g.node0, g.Jmat,
                jnp.asarray(self.pts[gi], dtype=state.u.dtype)[:, None],
            )
            a = self.system.analytic(gp, state.t).astype(state.u.dtype)
            w = float(self.w[gi]) * ve
            s2 = s2 + (w * sgp**2).sum(axis=1)
            err = (sgp - a) * (g.emask > 0)
            if p0 is not None:
                err = err * (~p0)  # P0 error comes from the coarse rule
            e2 = e2 + (w * err**2).sum(axis=1)
            einf = jnp.maximum(einf, jnp.abs(err).max(axis=1))
        if p0 is not None:
            mean = Uv[:, 0, :]  # (C,E) — P0 value is the cell mean
            ctr = jnp.full((3, 1), 0.25, dtype=state.u.dtype)
            gp = _phys_gp(g.node0, g.Jmat, ctr)
            a = self.system.analytic(gp, state.t).astype(state.u.dtype)
            errc = (mean - a) * p0
            e2 = e2 + (ve * errc**2).sum(axis=1)
            einf = jnp.maximum(einf, jnp.abs(errc).max(axis=1))
        l2sol = jnp.sqrt(s2 / self.total_vol)
        l2err = jnp.sqrt(e2 / self.total_vol)
        return (
            [float(v) for v in l2sol],
            [float(v) for v in l2err],
            [float(v) for v in einf],
        )

"""SPMD DG solver: RK3 + limiting + ghost exchange over a device mesh.

Distributed counterpart of quinoa_tpu.inciter.DGSolver, replacing the
reference DG chare's per-stage comsol/comlim ghost messages
(src/Inciter/DG.cpp:1010-1086) with ONE interface-buffer collective per
stage:

    push: owners gather their interface elements' modal state into the
          global buffer (zero elsewhere) -> psum over the shard axis
    pull: ghost holders read their slots back

dt is a pmin over owned elements; diagnostics are owned-masked psums.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..inciter.dg import DGState, RK0, RK1
from ..pde.dg import dg_rhs, dg_dt, dg_initialize
from ..pde.limiter import weno_p1, superbee_p1
from .dg_shard import ShardedDG
from .spmd import AXIS, _local, place


class SPMDDGSolver:
    """DG(P0/P1/P2) over a 1-D device mesh via shard_map."""

    def __init__(
        self,
        system,
        sharded: ShardedDG,
        mesh: Mesh,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        limiter: Optional[str] = None,
        cweight: float = 30.0,
        evolve_ndof: Optional[int] = None,
        pref: bool = False,
        tolref: float = 0.1,
    ):
        if mesh.shape[AXIS] != sharded.nshard:
            raise ValueError("device mesh size != shard count")
        self.system = system
        self.sharded = place(sharded, mesh)
        self.mesh = mesh
        self.cfl = cfl
        self.const_dt = const_dt
        self.limiter = limiter
        self.cweight = cweight
        self.pref = pref
        self.tolref = tolref
        K = sharded.geom.ndof
        self.evolve_ndof = evolve_ndof or K
        p = {1: 0.0, 4: 1.0, 10: 2.0}[self.evolve_ndof]
        self.cflscale = 1.0 / (2.0 * p + 1.0)

        from ..pde.dg import BC_DIRICHLET, BC_INLET

        bct = np.asarray(sharded.geom.bctype)
        self.needs_face_gp = bool(
            getattr(system, "needs_face_gp", True)
            or np.isin(bct, [BC_DIRICHLET, BC_INLET]).any()
        )

        # diagnostics quadrature tables precomputed host-side (constants)
        from ..ops.basis import eval_basis
        from ..ops.quadrature import gauss_tet, ng_diag
        import jax.numpy as _jnp

        pts, w = gauss_tet(ng_diag(K))
        self._diag_pts = np.asarray(pts)
        self._diag_w = np.asarray(w)
        self._diag_B = np.asarray(eval_basis(K, _jnp.asarray(pts)))

        # scalars ride the shard axis as (S,) pieces (see spmd.py)
        spec_state = DGState(u=P(AXIS), ndofel=P(AXIS), t=P(AXIS),
                             it=P(AXIS), dt=P(AXIS))
        step = jax.shard_map(
            self._step_local,
            mesh=self.mesh,
            in_specs=(P(AXIS), spec_state),
            out_specs=spec_state,
        )
        self._step = jax.jit(step)

        diag = jax.shard_map(
            self._diag_local,
            mesh=self.mesh,
            in_specs=(P(AXIS), spec_state),
            out_specs=(P(), P(), P()),
        )
        self._diag = jax.jit(diag)

    # -- ghost exchange -------------------------------------------------------

    def _exchange(self, sh: ShardedDG, U):
        """Ghost refresh: owners send their interface elements to the
        holders, one lax.ppermute per occurring shard-id offset (the
        comsol analog, DG.cpp:1019-1036) — per-device volume O(local
        ghost layer), independent of the device count."""
        if self.sharded.nslots == 0:
            return U
        if sh.ghalo is None:
            # global-buffer fallback
            CK, El = U.shape
            zcol = jnp.zeros((CK, 1), dtype=U.dtype)
            Upad = jnp.concatenate([U, zcol], axis=1)
            buf = Upad[:, sh.grev]  # (CK, nslots+1); zeros if not owner
            buf = jax.lax.psum(buf, AXIS)
            pulled = buf[:, sh.gslot]  # (CK, El)
            is_ghost = (sh.owned <= 0) & (sh.gslot < self.sharded.nslots)
            return jnp.where(is_ghost[None, :], pulled, U)
        h = sh.ghalo
        CK = U.shape[0]
        Up = jnp.concatenate(
            [U, jnp.zeros((CK, 1), dtype=U.dtype)], axis=1
        )
        out = U
        S = self.sharded.nshard
        for d, send, rpos, L in zip(h.offsets, h.send, h.rpos, h.Ls):
            perm = [(s, s + d) for s in range(S) if 0 <= s + d < S]
            slab = Up[:, send]
            rec = jax.lax.ppermute(slab, AXIS, perm)
            rec = jnp.concatenate(
                [rec, jnp.zeros((CK, 1), dtype=U.dtype)], axis=1
            )
            out = jnp.where((rpos < L)[None, :], rec[:, rpos], out)
        return out

    # -- per-shard bodies -------------------------------------------------------

    def _eval_ndof(self, geom, u, ndofel):
        """Shared indicator (pde.dg.eval_ndof_sticky); the caller
        exchanges the decisions so ghost entries carry the owner's
        sticky history (the comsol ndof piggyback)."""
        from ..pde.dg import eval_ndof_sticky

        return eval_ndof_sticky(geom, u, ndofel, self.system.ncomp,
                                self.tolref)

    def _propagate_ndof(self, geom, ndofel):
        from ..pde.dg import propagate_ndof

        return propagate_ndof(geom, ndofel)

    def _limit(self, geom, u, dofmask):
        C = self.system.ncomp
        if self.limiter == "wenop1":
            return weno_p1(geom, u, dofmask, C, self.cweight)
        if self.limiter == "superbeep1":
            return superbee_p1(geom, u, dofmask, C)
        return u

    def _step_local(self, sharded, state: DGState) -> DGState:
        sh: ShardedDG = _local(sharded)
        g = sh.geom
        K = g.ndof
        C = self.system.ncomp
        un = state.u[0]
        u = un
        ndofel = state.ndofel[0]
        t = state.t[0]
        dt = state.dt[0]

        mn = jnp.asarray(g.tables["mnorm"], dtype=g.vol.dtype)
        minv = jnp.tile(1.0 / (g.vol[None, :] * mn[:, None]), (C, 1))

        for s in range(3):
            # two exchanges per stage, like the reference's comsol + comlim
            # (DG.cpp:1010-1360): ghosts limited with incomplete neighbor
            # sets must be overwritten by the owner's limited values.
            u = self._exchange(sh, u)
            if s == 0 and self.pref and K >= 4:
                ndofel = self._eval_ndof(g, u, ndofel)
                # the reference piggybacks ndof on comsol and propagates
                # after the merge (DG.cpp:1245, 1249): exchange the eval
                # decisions (a ghost's sticky history lives with its
                # owner), propagate one ring locally (every face of an
                # owned element is in this shard's tables), then exchange
                # again so ghost dofmasks match the owner's promotion
                nd = self._exchange(sh, ndofel[None].astype(g.vol.dtype))
                ndofel = jnp.round(nd[0]).astype(jnp.int32)
                ndofel = self._propagate_ndof(g, ndofel)
                nd = self._exchange(sh, ndofel[None].astype(g.vol.dtype))
                ndofel = jnp.round(nd[0]).astype(jnp.int32)
            # dofmask None when every dof is active, as in the
            # single-device solver
            kk = jnp.arange(K)[:, None]
            dofmask = ((kk < ndofel[None, :]).astype(g.vol.dtype)
                       if self.pref else None)
            u = self._limit(g, u, dofmask)
            if self.limiter is not None:
                u = self._exchange(sh, u)
            if s == 0 and self.pref and dofmask is not None:
                # coarsened elements' high-order dofs zeroed at stage 0
                # (DG.cpp:1452-1469), as in the single-shard solver
                u = u * jnp.tile(dofmask, (C, 1))
            if s == 0:
                # RK anchor = limited stage-0 solution (DG.cpp:1471),
                # matching the single-shard solver
                un = u
                if self.const_dt is not None:
                    dt = jnp.asarray(self.const_dt, dtype=g.vol.dtype)
                else:
                    dt = jax.lax.pmin(
                        dg_dt(self.system, g, u, dofmask)
                        * (self.cfl * self.cflscale),
                        AXIS,
                    )
            r = dg_rhs(self.system, g, u, dofmask, t,
                       face_gp=self.needs_face_gp)
            unew = RK0[s] * un + RK1[s] * (u + dt * r * minv)
            if self.evolve_ndof < K:
                # rDG (P0P1): reconstructed dofs keep their values
                kk = jnp.tile(jnp.arange(K), C)
                unew = jnp.where(
                    (kk < self.evolve_ndof)[:, None], unew, u
                )
            if dofmask is not None:
                # inactive dofs hold the RK anchor (DG.cpp:1479-1488)
                dmflat = jnp.tile(dofmask, (C, 1))
                unew = jnp.where(dmflat > 0, unew, un)
            # only owned elements advance; ghosts refresh via exchange
            u = jnp.where(sh.owned[None, :] > 0, unew, u)

        return DGState(
            u=u[None],
            ndofel=ndofel[None],
            t=(t + dt)[None],
            it=(state.it[0] + 1)[None],
            dt=dt[None],
        )

    def _diag_local(self, sharded, state):
        sh: ShardedDG = _local(sharded)
        g = sh.geom
        C, K = self.system.ncomp, g.ndof
        u = state.u[0]
        Uv = u.reshape(C, K, -1)
        # p-adaptive: only the active dofs enter the norms, and P0
        # elements' error is integrated at the single centroid point —
        # same as the single-shard DGDiagnostics (ElemDiagnostics.cpp
        # uses ndofel[e] + NGdiag(ndofel[e]))
        ndofel = state.ndofel[0]
        kmask = (jnp.arange(K)[None, :, None]
                 < ndofel[None, None, :]).astype(u.dtype)
        Uv = Uv * kmask
        p0 = (ndofel == 1) & (sh.owned > 0) if self.pref else None
        pts, w = self._diag_pts, self._diag_w
        ve = g.vol * sh.owned
        vol_tot = jax.lax.psum(ve.sum(), AXIS)
        s2 = jnp.zeros((C,), dtype=u.dtype)
        e2 = jnp.zeros((C,), dtype=u.dtype)
        einf = jnp.zeros((C,), dtype=u.dtype)
        for gi in range(len(w)):
            B = jnp.asarray(self._diag_B[gi], dtype=u.dtype)[:, None]
            sgp = (Uv * B).sum(axis=1)
            gp = jnp.stack(
                [
                    g.node0[i]
                    + g.Jmat[i, 0] * pts[gi][0]
                    + g.Jmat[i, 1] * pts[gi][1]
                    + g.Jmat[i, 2] * pts[gi][2]
                    for i in range(3)
                ]
            )
            a = self.system.analytic(gp, state.t[0]).astype(u.dtype)
            wv = float(w[gi]) * ve
            s2 = s2 + (wv * sgp**2).sum(axis=1)
            err = (sgp - a) * (sh.owned > 0)
            if p0 is not None:
                err = err * (~p0)  # P0 error comes from the coarse rule
            e2 = e2 + (wv * err**2).sum(axis=1)
            einf = jnp.maximum(einf, jnp.abs(err).max(axis=1))
        if p0 is not None:
            mean = Uv[:, 0, :]
            gp = jnp.stack(
                [g.node0[i] + 0.25 * (g.Jmat[i, 0] + g.Jmat[i, 1]
                                      + g.Jmat[i, 2]) for i in range(3)]
            )
            a = self.system.analytic(gp, state.t[0]).astype(u.dtype)
            errc = (mean - a) * p0
            e2 = e2 + (ve * errc**2).sum(axis=1)
            einf = jnp.maximum(einf, jnp.abs(errc).max(axis=1))
        l2sol = jnp.sqrt(jax.lax.psum(s2, AXIS) / vol_tot)
        l2err = jnp.sqrt(jax.lax.psum(e2, AXIS) / vol_tot)
        linferr = jax.lax.pmax(einf, AXIS)
        return l2sol, l2err, linferr

    # -- public API -------------------------------------------------------------

    def initial_state(self, t0: float = 0.0) -> DGState:
        sh = self.sharded
        dtype = sh.geom.vol.dtype

        def per_shard(geom_s):
            return dg_initialize(self.system, geom_s, t0)

        u0 = jax.vmap(per_shard)(sh.geom)
        u0 = jax.device_put(
            u0.astype(dtype), jax.sharding.NamedSharding(self.mesh, P(AXIS))
        )
        El = sh.geom.vol.shape[1]
        ndofel = jnp.full((sh.nshard, El), sh.geom.ndof, dtype=jnp.int32)
        shard = jax.sharding.NamedSharding(self.mesh, P(AXIS))
        S = sh.nshard
        return DGState(
            u=u0,
            ndofel=jax.device_put(ndofel, shard),
            t=jax.device_put(jnp.full((S,), t0, dtype=dtype), shard),
            it=jax.device_put(jnp.zeros((S,), dtype=jnp.int32), shard),
            dt=jax.device_put(jnp.zeros((S,), dtype=dtype), shard),
        )

    def step(self, state: DGState) -> DGState:
        return self._step(self.sharded, state)

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def diagnostics(self, state):
        l2sol, l2err, linferr = self._diag(self.sharded, state)
        return np.asarray(l2sol), np.asarray(l2err), np.asarray(linferr)

    def gather_global(self, state) -> np.ndarray:
        """Reassemble the global (C*K, E) modal field from owned copies."""
        u = np.asarray(state.u)
        eg = np.asarray(self.sharded.eglobal)
        owned = np.asarray(self.sharded.owned) > 0
        out = np.zeros((u.shape[1], self.sharded.nelem_global), dtype=u.dtype)
        for s in range(self.sharded.nshard):
            m = owned[s]
            out[:, eg[s][m]] = u[s][:, m]
        return out


class SPMDMultiMatSolver(SPMDDGSolver):
    """Multi-material DG(P0/P1) over a device mesh: the DG
    ghost/exchange machinery with the multimat rhs (AUSM+up +
    non-conservative terms, pde/multimat.py) — the distributed
    counterpart of MultiMatSolver.  P1 adds consistent
    material-fraction Superbee limiting and the per-stage alpha
    closure, both identical to the single-device solver."""

    def __init__(self, system, sharded: ShardedDG, mesh: Mesh,
                 cfl: float = 0.5, const_dt=None, limiter=None):
        import numpy as _np

        from ..pde.dg import BC_DIRICHLET as _BCD

        K = sharded.geom.ndof
        if K not in (1, 4):
            raise ValueError("multimat supports DG(P0) and DG(P1) only")
        if limiter not in (None, "superbeep1"):
            raise ValueError(
                f"unknown multimat limiter {limiter!r} (superbeep1 only)")
        # Dirichlet samples problem.solution at the face Gauss points
        self._has_dirichlet = bool(_np.isin(
            _np.asarray(sharded.geom.bctype), [_BCD]).any())
        super().__init__(system, sharded, mesh, cfl=cfl,
                         const_dt=const_dt, limiter=limiter)

    def _step_local(self, sharded, state):
        from ..pde.multimat import clean_alpha_closure, mm_consistent_limit

        sh: ShardedDG = _local(sharded)
        g = sh.geom
        K = g.ndof
        C = self.system.ncomp
        un = state.u[0]
        u = un
        t = state.t[0]
        dt = state.dt[0]
        minv = (1.0 / g.vol) if K == 1 else jnp.tile(
            1.0 / (g.vol[None, :]
                   * jnp.asarray(g.tables["mnorm"],
                                 dtype=g.vol.dtype)[:, None]), (C, 1))
        for s in range(3):
            # comsol + (with a limiter) comlim exchanges, as in the
            # compflow SPMD solver
            u = self._exchange(sh, u)
            if self.limiter is not None:
                u = mm_consistent_limit(self.system, g, u)
                u = self._exchange(sh, u)
            if s == 0:
                # dt AFTER the ghost refresh (and limiting): a face
                # against a ghost must see the owner's current value,
                # as it does single-device
                un = u
                if self.const_dt is not None:
                    dt = jnp.asarray(self.const_dt, dtype=g.vol.dtype)
                else:
                    # emask marks OWNED elements, so the local min spans
                    # exactly the single-device element set
                    dt = jax.lax.pmin(
                        self.system.dt(g, u) * self.cfl * self.cflscale,
                        AXIS)
            r = self.system.rhs(g, u, t, face_gp=self._has_dirichlet)
            unew = RK0[s] * un + RK1[s] * (u + dt * r * minv)
            if K > 1:
                unew = clean_alpha_closure(unew, C, K, self.system.nmat)
            u = jnp.where(sh.owned[None, :] > 0, unew, u)
        return DGState(u=u[None], ndofel=state.ndofel,
                       t=(t + dt)[None], it=(state.it[0] + 1)[None],
                       dt=dt[None])

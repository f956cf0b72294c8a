"""DiagCG: node-centered, diagonally-lumped Taylor-Galerkin + FCT solver.

Re-design of the reference's DiagCG chare array
(src/Inciter/DiagCG.cpp: dt 229-286, rhs 288-357, solve 359-414, update
472-500) and its DistFCT companion: one time step is a single pure jitted
function whose internal structure is

    dt (global min) -> rhs + mass-diffusion -> low/high solve ->
    FCT aec -> alw -> lim -> u' = ul + A

Solution fields are feature-major (C, N).  The single-shard version has
no communication; the sharded version (quinoa_tpu.parallel.spmd) wraps
the same kernels in shard_map and combines node buffers on shard
boundaries at exactly the points where DistFCT exchanged messages.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..fct.fct import FCT
from ..pde.cg import CGGeom, lumped_mass


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["u", "t", "it", "dt"],
    meta_fields=[],
)
@dataclasses.dataclass
class CGState:
    """Time-marching state for node-centered schemes; u is (C, nnode)."""

    u: jnp.ndarray
    t: jnp.ndarray
    it: jnp.ndarray
    dt: jnp.ndarray


def _identity_combine(x):
    return x


def diagcg_advance(
    system,
    fct,
    use_fct: bool,
    geom,
    lhs,
    bcmask,
    u,
    t,
    dt,
    combine_sum=_identity_combine,
    combine_max=_identity_combine,
    combine_min=_identity_combine,
    bc_n=None,
    vol_n=None,
):
    """One DiagCG(+FCT) update given the time step size.

    The three combine hooks act on (C, N) node buffers exactly where the
    reference's DistFCT/DiagCG exchanged chare-boundary messages: rhs+dif
    (comrhs), P and Q (comaec/comalw), A (comlim).  On a single shard they
    are the identity; the SPMD driver injects boundary-buffer
    psum/pmax/pmin reductions.

    bc_n/vol_n: optional precomputed (static) gathers of bcmask and
    nodal volumes to element nodes — the solver caches them so the
    per-step program carries no static gathers.
    """
    from ..ops.assembly import assemble_add, assemble_add_max, gather_nodes

    C = u.shape[0]
    # ONE shared nodal gather feeds the PDE rhs, the mass diffusion, and
    # the AEC (the bench showed every (C, N) gather costs ~30 ms at 663k
    # tets — each op re-gathering was the dominant step cost); the rhs
    # and diff element contributions then ride a single stacked assembly
    # and a single stacked halo exchange.
    un = gather_nodes(u, geom.inpoelT)                      # (4, C, E)
    rc = system.rhs_contrib(t, dt, geom, u, un)
    dc = fct.diff_contrib(geom, un)
    rd = assemble_add(jnp.concatenate([rc, dc], axis=1), geom.nsup)
    rd = combine_sum(rd)                                    # (2C, N)
    r, dif = rd[:C], rd[C:]

    # Dirichlet BCs: lhs=1, rhs=bc increment, dif=0 at BC nodes
    # (DiagCG::solve, src/Inciter/DiagCG.cpp:359-414)
    binc = system.solinc(geom.coords, t, dt).astype(u.dtype)
    lhs_eff = jnp.where(bcmask > 0, 1.0, lhs[None, :])
    r = jnp.where(bcmask > 0, binc, r)
    dif = jnp.where(bcmask > 0, 0.0, dif)

    dul = (r + dif) / lhs_eff
    ul = u + dul
    du = r / lhs_eff

    if not use_fct:
        return u + du

    aec = fct.aec_contrib(geom, du, u, bcmask, un=un, bc_n=bc_n,
                          vol_n=vol_n)
    # gather(max(Ul,Un)) == max(gather(Ul), un) elementwise, so alw
    # rides a C-row Ul gather instead of its own 2C-row one
    uln = gather_nodes(ul, geom.inpoelT)
    s_el = fct.alw_contrib(geom, u, ul, un=un, uln=uln)     # (2C, E)
    pq = jnp.concatenate(
        [jnp.maximum(aec, 0.0), jnp.minimum(aec, 0.0)], axis=1)
    s4 = jnp.broadcast_to(s_el[None], (4,) + s_el.shape)
    # the P sum-assembly and Q max-assembly share one pass of nsup
    # gathers
    P2, Q2 = assemble_add_max(pq, s4, geom.nsup)
    # one stacked sum exchange for P, one stacked max exchange for Q
    # (min folds in by negation); Q2 rows are [qmax | -qmin]
    P2 = combine_sum(P2)
    P = jnp.stack([P2[:C], P2[C:]])
    Q2 = combine_max(Q2)
    Q = jnp.stack([Q2[:C], -Q2[C:]])
    A = combine_sum(fct.lim(geom, aec, P, Q, ul))
    return ul + A


class DiagCGSolver:
    """Single-shard DiagCG driver.

    Parameters
    ----------
    system : CGPDE operator (CGTransport / CGCompFlow)
    geom   : CGGeom static geometry
    cfl    : Courant number scaling the min element dt
    const_dt : use a constant dt instead of CFL if given
    ctau   : FCT mass-diffusion coefficient
    fct    : enable flux-corrected transport (else plain lumped-mass TG)
    bcnodes : (nbc,) int32 node ids with Dirichlet BCs (all components)
    """

    def __init__(
        self,
        system,
        geom: CGGeom,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        ctau: float = 1.0,
        fct: bool = True,
        bcnodes=None,
    ):
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.const_dt = const_dt
        self.fct = FCT(ctau=ctau)
        self.use_fct = fct

        ncomp = system.ncomp
        bcmask = jnp.zeros((ncomp, geom.nnode), dtype=geom.vol.dtype)
        if bcnodes is not None and len(bcnodes) > 0:
            bcmask = bcmask.at[:, jnp.asarray(bcnodes, dtype=jnp.int32)].set(1.0)
        self.bcmask = bcmask

        # assembled lumped-mass lhs (DiagCG::lhs + lhsmerge)
        self.lhs = lumped_mass(geom)

        # static per-run gathers cached once (eager, outside the step):
        # bcmask and nodal volumes at element nodes (FCT::aec inputs)
        self.bc_n = jnp.stack(
            [bcmask[:, geom.inpoelT[a]] for a in range(4)])
        self.vol_n = jnp.stack(
            [geom.vol[geom.inpoelT[a]] for a in range(4)])

        # CGTransport's dt law reads only the (static) velocity field —
        # the per-step sweep collapses to a constant when the velocity
        # is time-independent (CGTransport.dt ignores U beyond dtype)
        self._static_dt = None
        if const_dt is None and getattr(system, "static_dt", None):
            u0 = system.initialize(geom.coords, 0.0).astype(
                geom.vol.dtype)
            self._static_dt = (system.dt(geom, u0)
                               * jnp.asarray(cfl, geom.vol.dtype))

        # geometry/lhs/bcmask are jit ARGUMENTS, not closure constants
        self._step = jax.jit(self._step_impl)

    # -- public API ---------------------------------------------------------

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
        return self._step(self.geom, self.lhs, self.bcmask,
                          self.bc_n, self.vol_n, state)

    def nsteps(self, state: CGState, n: int) -> CGState:
        """n steps by repeated dispatch of the compiled step."""
        for _ in range(n):
            state = self._step(self.geom, self.lhs, self.bcmask,
                               self.bc_n, self.vol_n, state)
        return state

    # -- implementation -------------------------------------------------------

    def compute_dt(self, u):
        if self.const_dt is not None:
            return jnp.asarray(self.const_dt, dtype=self.geom.vol.dtype)
        if self._static_dt is not None:
            return self._static_dt
        return self.system.dt(self.geom, u) * self.cfl

    def _step_impl(self, geom, lhs, bcmask, bc_n, vol_n,
                   state: CGState) -> CGState:
        if self.const_dt is not None:
            dt = jnp.asarray(self.const_dt, dtype=geom.vol.dtype)
        elif self._static_dt is not None:
            dt = self._static_dt
        else:
            dt = self.system.dt(geom, state.u) * self.cfl
        unew = diagcg_advance(
            self.system,
            self.fct,
            self.use_fct,
            geom,
            lhs,
            bcmask,
            state.u,
            state.t,
            dt,
            bc_n=bc_n,
            vol_n=vol_n,
        )
        return CGState(u=unew, t=state.t + dt, it=state.it + 1, dt=dt)

"""Flux-corrected transport (FEM-FCT), feature-major layout.

Re-design of the reference's FluxCorrector/DistFCT pair
(src/Inciter/FluxCorrector.cpp: aec:30, lump:238, diff:281, alw:339,
lim:389; src/Inciter/DistFCT.hpp:100-226) after

  Löhner, Morgan, Peraire, Vahdati (1987): Finite element flux-corrected
  transport (FEM-FCT) for the Euler and Navier-Stokes equations.
  Int. J. Numer. Meth. Fluids 7:1093-1109.

All node fields are (C, N), element slabs (4, C, E); assembly is
gather-based.  In the sharded solver the P/Q/A buffers are combined across
shards by the halo layer between passes (sum for P and A, max/min for Q),
replacing DistFCT's comaec/comalw/comlim messages.

The low/high-order pair is the diagonally-lumped Taylor-Galerkin of
DiagCG: high order = lumped-mass TG (dUh enters the AEC as zero), low
order = high order + mass diffusion c_tau*(M_c-M_L)Un.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.assembly import (
    gather_nodes,
    assemble_add,
    assemble_max,
    assemble_min,
)
from ..pde.cg import CGGeom


class FCT:
    """FEM-FCT limiter for the diagonally-lumped Taylor-Galerkin scheme."""

    def __init__(self, ctau: float = 1.0):
        #: mass-diffusion coefficient; 1.0 guarantees monotonicity
        self.ctau = ctau

    # (M_L - M_c) of a tet: diag 3J/120, off-diag -J/120; applied as
    # y_a = (J/120)(4 x_a - sum_b x_b)  (FluxCorrector.cpp aec/diff).

    def _mass_lumped_minus_consistent(self, geom: CGGeom, X):
        """(M_Le - M_ce) @ X per element: X (4, C, E) -> (4, C, E)."""
        j = (geom.J * geom.emask) / 120.0
        s = X.sum(axis=0)
        return j * (4.0 * X - s)

    def diff_contrib(self, geom: CGGeom, un):
        """Mass-diffusion element contributions (4, C, E) from the
        shared nodal gather (the driver batches this assembly with the
        PDE rhs one).  D_a = -c_tau (M_Le - M_ce) Un
        (FluxCorrector::diff:281-338)."""
        return -self.ctau * self._mass_lumped_minus_consistent(geom, un)

    def diff(self, geom: CGGeom, Un):
        """Mass-diffusion rhs of the low-order system: (C, N) partials."""
        un = gather_nodes(Un, geom.inpoelT)
        return assemble_add(self.diff_contrib(geom, un), geom.nsup)

    def aec(self, geom: CGGeom, dUh, Un, bcmask, un=None, bc_n=None,
            vol_n=None):
        """Antidiffusive element contributions + nodal P sums.

        AEC = M_L^{-1} (M_Le - M_ce)(ctau*Un + dUh); dUh enters as zero for
        the lumped-mass high-order scheme (FluxCorrector::aec:30-170).
        AECs at Dirichlet-BC nodes are zeroed.

        bcmask : (C, N) 1.0 where a Dirichlet BC is set.
        un, bc_n, vol_n : optional precomputed gathers of Un, bcmask and
        nodal volumes (bc_n and vol_n are static per run — the solver
        caches them to keep these gathers out of the per-step program).
        Returns (aec (4, C, E), P (2, C, N)).
        """
        aec = self.aec_contrib(geom, dUh, Un, bcmask, un=un, bc_n=bc_n,
                               vol_n=vol_n)
        # one assembly pass over the stacked [pos | neg] rows (each
        # extra row rides the same D gathers)
        C = aec.shape[1]
        pn = assemble_add(
            jnp.concatenate(
                [jnp.maximum(aec, 0.0), jnp.minimum(aec, 0.0)], axis=1
            ),
            geom.nsup,
        )
        return aec, jnp.stack([pn[:C], pn[C:]])

    def aec_contrib(self, geom: CGGeom, dUh, Un, bcmask, un=None,
                    bc_n=None, vol_n=None):
        """Antidiffusive element contributions (4, C, E) only — the
        driver may fuse their P assembly with the Q one
        (ops.assembly.assemble_add_max)."""
        if un is None:
            un = gather_nodes(Un, geom.inpoelT)
        me = self._mass_lumped_minus_consistent(geom, self.ctau * un)
        if vol_n is None:
            vol_n = jnp.stack(
                [geom.vol[geom.inpoelT[a]] for a in range(4)]
            )  # (4, E)
        aec = me / vol_n[:, None, :]

        if bc_n is None:
            bc_n = gather_nodes(bcmask, geom.inpoelT)  # (4, C, E)
        return jnp.where(bc_n > 0, 0.0, aec)

    def alw(self, geom: CGGeom, Un, Ul):
        """Allowed max/min around nodes: Q (2, C, N) partials.

        S_el = extrema over the element's nodes of max/min(Ul,Un); Q_i is
        the extremum of S_el over elements around i (alw:339-388).
        min folds into the max pass by negation, so the whole alw is one
        stacked gather + one stacked extreme-assembly.
        """
        C = Un.shape[0]
        s_el = self.alw_contrib(geom, Un, Ul)
        q = assemble_max(
            jnp.broadcast_to(s_el[None], (4,) + s_el.shape), geom.nsup
        )  # (2C, N): [qmax | -qmin]
        return jnp.stack([q[:C], -q[C:]])

    def alw_contrib(self, geom: CGGeom, Un, Ul, un=None, uln=None):
        """Element extrema slab (2C, E) = [max_el | -min_el] feeding the
        Q max-assembly.  When the step already holds un = gather(Un),
        pass it plus uln = gather(Ul): gather(max(Ul,Un)) ==
        max(gather(Ul), gather(Un)) elementwise, so the 2C-row gather
        shrinks to the C-row Ul one.
        """
        big = jnp.asarray(jnp.finfo(Un.dtype).max, dtype=Un.dtype)
        if un is not None and uln is not None:
            smax = jnp.maximum(uln, un).max(axis=0)       # (C, E)
            smin = jnp.minimum(uln, un).min(axis=0)
            s_el = jnp.concatenate([smax, -smin], axis=0)  # (2C, E)
        else:
            s = gather_nodes(
                jnp.concatenate(
                    [jnp.maximum(Ul, Un), -jnp.minimum(Ul, Un)], axis=0
                ),
                geom.inpoelT,
            )  # (4, 2C, E): [max | -min]
            s_el = s.max(axis=0)
        return jnp.where(geom.emask <= 0, -big, s_el)

    def lim(self, geom: CGGeom, aec, P, Q, Ul):
        """Limited antidiffusive contributions assembled to nodes: (C, N).

        Monotonicity ratios R^{+,-}, element coefficient C_el = min over
        the element's nodes, applied to the AECs (lim:389-470).
        """
        eps = jnp.asarray(jnp.finfo(Ul.dtype).eps, dtype=Ul.dtype)
        big = jnp.asarray(jnp.finfo(Ul.dtype).max, dtype=Ul.dtype)
        C = Ul.shape[0]

        Qp = Q[0] - Ul
        Qm = Q[1] - Ul

        Rp = jnp.where(
            P[0] > 0.0,
            jnp.minimum(1.0, Qp / jnp.where(P[0] > 0.0, P[0], 1.0)),
            0.0,
        )
        Rm = jnp.where(
            P[1] < 0.0,
            jnp.minimum(1.0, Qm / jnp.where(P[1] < 0.0, P[1], 1.0)),
            0.0,
        )

        rpm = gather_nodes(
            jnp.concatenate([Rp, Rm], axis=0), geom.inpoelT
        )  # (4, 2C, E)
        rp, rm = rpm[:, :C], rpm[:, C:]
        r = jnp.where(jnp.abs(aec) < eps, big, jnp.where(aec > 0.0, rp, rm))
        Cel = jnp.minimum(r.min(axis=0), 1.0)  # (C, E)

        return assemble_add(Cel[None] * aec, geom.nsup)

"""Multi-material Euler (velocity equilibrium) for cell-centered DG(P0).

Counterpart of the reference's DGMultiMat + AUSM + MultiMatTerms
(src/PDE/MultiMat/DGMultiMat.hpp, src/PDE/Integrate/Riemann/AUSM.hpp:
32-250, src/PDE/Integrate/MultiMatTerms.cpp; model of Pelanti & Shyue
2019): nmat materials with volume fractions alpha_k, partial densities
alpha_k rho_k, a single (equilibrium) velocity, and material energies.

Unknown layout per element (MultiMatIndexing.hpp):
    [ alpha_k (nmat) | alpha_k rho_k (nmat) | rho u_i (3) |
      alpha_k rho_k E_k (nmat) ]              => ncomp = 3*nmat + 3

The AUSM+up flux additionally returns the Riemann-advected partial
pressures and the Riemann velocity, which feed the *non-conservative*
volume terms (alpha_k div(u) for the fraction equations, the
y_k grad(alpha p) work terms for the energies) — the per-cell
riemannDeriv face sums of the reference (Surface.cpp:282-289,
DGMultiMat.hpp:196-206) accumulated here through the faces-of-element
gather table.

This first version implements DG(P0) (finite volume), the discretization
the reference's multimat regression decks use with `scheme dg`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dg import DGGeom, BC_DIRICHLET, BC_SYMMETRY, BC_INTERIOR, HI
from .eos import StiffenedGas


def volfrac_idx(nmat, k):
    return k


def density_idx(nmat, k):
    return nmat + k


def momentum_idx(nmat, i):
    return 2 * nmat + i


def energy_idx(nmat, k):
    return 2 * nmat + 3 + k


def _split_mach(mach):
    """AUSM+ split Mach/pressure polynomials (AUSM.hpp:200-250), f_a=1."""
    m1p = 0.5 * (mach + jnp.abs(mach))
    m1m = 0.5 * (mach - jnp.abs(mach))
    m2p = 0.25 * (mach + 1.0) ** 2
    m2m = -0.25 * (mach - 1.0) ** 2
    alph = 3.0 / 16.0  # (3/16)(-4+5 f_a^2), f_a = 1

    sup = jnp.abs(mach) >= 1.0
    msp = jnp.where(sup, m1p, m2p * (1.0 - 2.0 * m2m))
    msm = jnp.where(sup, m1m, m2m * (1.0 + 2.0 * m2p))
    psp = jnp.where(
        sup, m1p / jnp.where(mach == 0, 1.0, mach),
        m2p * ((2.0 - mach) - 16.0 * alph * mach * m2m),
    )
    psm = jnp.where(
        sup, m1m / jnp.where(mach == 0, 1.0, mach),
        m2m * ((-2.0 - mach) + 16.0 * alph * mach * m2p),
    )
    return msp, msm, psp, psm


class MultiMatSystem:
    """DG(P0) multi-material Euler with AUSM+up and non-conservative terms."""

    def __init__(self, problem, intsharp=False, thinc_beta=2.5):
        self.problem = problem
        self.nmat = problem.nmat
        self.eos: List[StiffenedGas] = list(problem.eos)
        self.ncomp = 3 * self.nmat + 3
        # THINC interface sharpening at P1+ (upstream Quinoa's intsharp
        # / intsharp_param keywords; the fork never reconstructs — its
        # DGMultiMat asserts ndof==1).  beta=2.5 measured best against
        # the consistent-Superbee baseline: 48 vs 80 interface cells
        # after 10 cells of planar advection (beta 1.8, the upstream
        # default against its more-diffusive vertex limiter, is no
        # sharper than Superbee alone here)
        self.intsharp = bool(intsharp)
        self.thinc_beta = float(thinc_beta)

    # -- state helpers --------------------------------------------------------

    def _prim(self, u):
        """Bulk rho, velocity, material pressures/enthalpies/soundspeeds.

        Trace-material guards: at P1+ the face-evaluated fraction of a
        trace material (mean ~1e-12 plus O(1) slope cancellation) can
        round to <= 0 — f32 round-off is ~1e-7 — so alpha and the
        derived material density are floored at a dtype-scaled epsilon
        before dividing (the same clipping upstream Quinoa applies
        throughout its multimat EOS calls); the floors only engage on
        states that are zero to machine precision."""
        nmat = self.nmat
        floor = 50.0 * jnp.finfo(u.dtype).eps
        rho = sum(u[density_idx(nmat, k)] for k in range(nmat))
        vel = [u[momentum_idx(nmat, i)] / rho for i in range(3)]
        al, pm, hm, am = [], [], [], []
        for k in range(nmat):
            a = jnp.maximum(u[volfrac_idx(nmat, k)], floor)
            rk = jnp.maximum(u[density_idx(nmat, k)] / a, floor)
            ek = u[energy_idx(nmat, k)] / a
            p = self.eos[k].pressure(rk, vel[0], vel[1], vel[2], ek)
            al.append(a)
            pm.append(p)
            hm.append(u[energy_idx(nmat, k)] + a * p)
            am.append(self.eos[k].soundspeed(rk, jnp.maximum(p, 1e-30)))
        return rho, vel, al, pm, hm, am

    def ausm(self, fn, uL, uR):
        """AUSM+up flux: returns (flux (C,n), ap_star (nmat,n), vriem (n,))."""
        nmat = self.nmat
        rhol, vell, all_, pml, hml, aml = self._prim(uL)
        rhor, velr, alr, pmr, hmr, amr = self._prim(uR)

        pl = sum(all_[k] * pml[k] for k in range(nmat))
        pr = sum(alr[k] * pmr[k] for k in range(nmat))

        # mixture speed of sound from averaged material states
        rho12 = 0.5 * (rhol + rhor)
        ac2 = 0.0
        for k in range(nmat):
            al12 = 0.5 * (all_[k] + alr[k])
            rm12 = 0.5 * (
                uL[density_idx(nmat, k)] / all_[k]
                + uR[density_idx(nmat, k)] / alr[k]
            )
            am12 = 0.5 * (aml[k] + amr[k])
            ac2 = ac2 + al12 * rm12 * am12 * am12
        ac12 = jnp.sqrt(ac2 / rho12)

        vnl = sum(vell[i] * fn[i] for i in range(3))
        vnr = sum(velr[i] * fn[i] for i in range(3))
        ml, mr = vnl / ac12, vnr / ac12
        mspl, msml, pspl, psml_ = _split_mach(ml)
        mspr, msmr, pspr, psmr = _split_mach(mr)

        m12 = mspl + msmr  # k_p = 0 (AUSM.hpp:127: k_u = k_p = 0)
        vriem = ac12 * m12
        p12 = pspl * pl + psmr * pr  # k_u = 0

        lp = 0.5 * (vriem + jnp.abs(vriem))
        lm = 0.5 * (vriem - jnp.abs(vriem))

        flx = [None] * self.ncomp
        for k in range(nmat):
            flx[volfrac_idx(nmat, k)] = lp * all_[k] + lm * alr[k]
            flx[density_idx(nmat, k)] = (
                lp * uL[density_idx(nmat, k)] + lm * uR[density_idx(nmat, k)]
            )
            flx[energy_idx(nmat, k)] = lp * hml[k] + lm * hmr[k]
        for i in range(3):
            flx[momentum_idx(nmat, i)] = (
                lp * uL[momentum_idx(nmat, i)]
                + lm * uR[momentum_idx(nmat, i)]
                + p12 * fn[i]
            )

        # Riemann-advected partial pressures: upwinded by the sign of vriem
        lpn = lp / (jnp.abs(vriem) + 1e-16)
        lmn = lm / (jnp.abs(vriem) + 1e-16)
        ap = []
        for k in range(nmat):
            apl = all_[k] * pml[k]
            apr = alr[k] * pmr[k]
            ap.append(
                jnp.where(
                    jnp.abs(lpn) > 1e-10,
                    apl,
                    jnp.where(jnp.abs(lmn) > 1e-10, apr, 0.5 * (apl + apr)),
                )
            )
        return jnp.stack(flx), jnp.stack(ap), vriem

    def bc_state(self, bctype, sL, fn):
        """Dirichlet handled by caller; Symmetry reflects velocity;
        Extrapolate copies (DGMultiMat.hpp BC state fns)."""
        nmat = self.nmat
        rho = sum(sL[density_idx(nmat, k)] for k in range(nmat))
        vel = jnp.stack(
            [sL[momentum_idx(nmat, i)] / rho for i in range(3)]
        )
        vn = (vel * fn).sum(0)
        velr = vel - 2.0 * vn * fn
        # momentum rows are contiguous (2*nmat..2*nmat+2)
        m0 = momentum_idx(nmat, 0)
        sym = jnp.concatenate([sL[:m0], rho[None] * velr, sL[m0 + 3:]],
                              axis=0)
        return jnp.where(bctype == BC_SYMMETRY, sym, sL)

    def charvel(self, u, fn):
        nmat = self.nmat
        rho, vel, al, pm, hm, am = self._prim(u)
        ac = jnp.sqrt(
            sum(al[k] * (u[density_idx(nmat, k)] / al[k]) * am[k] ** 2
                for k in range(nmat)) / rho
        )
        vn = sum(vel[i] * fn[i] for i in range(3))
        return jnp.abs(vn) + ac

    def flux_cols(self, state, gp, t):
        """Conservative flux columns F_j (list of 3, each (C, ...)) for
        the DG volume integral at P1+.  The velocity-equilibrium system's
        conservative part (the fork never evaluates it — DGMultiMat.hpp
        asserts ndof==1 — so this path is beyond-parity; the split
        matches the P0 face flux: alpha advects as alpha*u with the
        +alpha*div(u) balance in the non-conservative term)."""
        nmat, C = self.nmat, self.ncomp
        rho, vel, al, pm, hm, am = self._prim(state)
        pb = sum(al[k] * pm[k] for k in range(nmat))
        cols = []
        for j in range(3):
            f = [None] * C
            for k in range(nmat):
                f[volfrac_idx(nmat, k)] = al[k] * vel[j]
                f[density_idx(nmat, k)] = state[density_idx(nmat, k)] * vel[j]
                # material total enthalpy flux: u_j ((arE)_k + a_k p_k)
                f[energy_idx(nmat, k)] = hm[k] * vel[j]
            for i in range(3):
                mom = state[momentum_idx(nmat, i)] * vel[j]
                f[momentum_idx(nmat, i)] = mom + pb if i == j else mom
            cols.append(jnp.stack(f))
        return cols

    def thinc_carriers(self, geom: DGGeom, Uv):
        """THINC carrier components (3*nmat, K, E) for interface
        sharpening at P1 (Xiao-style algebraic interface capturing, the
        analog of upstream Quinoa's THINCReco; no counterpart in the
        /root/reference fork, which asserts ndof==1):

        rows 3k   : q_k(xi) — the cell's normalized coordinate along the
                    interface normal n_k = grad(alpha_k)/|grad(alpha_k)|,
                    0 at the most-upwind vertex, 1 at the most-downwind.
                    q is AFFINE in the reference coordinates, so its P1
                    Dubiner modal representation is exact — the carriers
                    ride the generic face machinery and every face
                    Gauss point receives its own cell's q exactly;
        rows 3k+1 : q0_k — interface position from the closed-form
                    slab-mean inversion of the tanh profile (cell const);
        rows 3k+2 : flag_k — 1.0 where THINC replaces the linear
                    reconstruction (interface cell: delta < mean alpha
                    < 1-delta and a resolvable gradient);
        rows 3k+3 : rho_k — cell-MEAN material density (alpha rho)/alpha
                    (cell constant; the face-linear ratio is 0/0-ill-
                    conditioned where the linear alpha crosses zero
                    inside a flagged cell);
        rows 3k+4 : rhoE_k — cell-mean material energy density.
        Returns (5*nmat, K, E).
        """
        nmat, K = self.nmat, geom.ndof
        beta = self.thinc_beta
        delta = 1.0e-4
        dt_ = Uv.dtype
        rows = []
        for k in range(nmat):
            a = Uv[volfrac_idx(nmat, k)]                 # (K,E)
            u1, u2, u3 = a[1], a[2], a[3]
            dxi = (2.0 * u1, u1 + 3.0 * u2, u1 + u2 + 4.0 * u3)
            g = [sum(dxi[m] * geom.jacInv[m, j] for m in range(3))
                 for j in range(3)]
            gn = jnp.sqrt(g[0] ** 2 + g[1] ** 2 + g[2] ** 2)
            abar = a[0]
            flag = ((abar > delta) & (abar < 1.0 - delta)
                    & (gn > 1.0e-8)).astype(dt_)
            gsafe = jnp.maximum(gn, 1.0e-30)
            n = [g[j] / gsafe for j in range(3)]
            # vertex projections along n: node0 at 0, the three edge
            # vectors J[:, i]
            pj = [sum(n[m] * geom.Jmat[m, i] for m in range(3))
                  for i in range(3)]
            pmin = jnp.minimum(jnp.minimum(pj[0], pj[1]),
                               jnp.minimum(pj[2], 0.0))
            pmax = jnp.maximum(jnp.maximum(pj[0], pj[1]),
                               jnp.maximum(pj[2], 0.0))
            L = jnp.maximum(pmax - pmin, 1.0e-30)
            # q(xi) = (sum_i pj_i xi_i - pmin)/L, affine -> exact P1
            # modal coefficients in the Dubiner basis (B1=2x+e+z-1,
            # B2=3e+z-1, B3=4z-1)
            c0 = -pmin / L
            c1, c2, c3 = pj[0] / L, pj[1] / L, pj[2] / L
            m1 = c1 / 2.0
            m2 = (c2 - m1) / 3.0
            m3 = (c3 - m1 - m2) / 4.0
            m0 = c0 + m1 + m2 + m3
            qrow = jnp.stack([m0, m1, m2, m3])           # (K,E), K==4
            # interface position from the slab-mean inversion:
            # mean = 1/2 + (1/2b) ln[(e^b + z e^-b)/(1+z)], z = e^{2 b q0}
            ab = jnp.clip(abar, delta, 1.0 - delta)
            Em = jnp.exp(beta * (2.0 * ab - 1.0))
            z = (jnp.exp(beta) - Em) / (Em - jnp.exp(-beta))
            q0 = jnp.log(z) / (2.0 * beta)
            zK = jnp.zeros_like(a)
            asafe = jnp.maximum(abar, delta)
            rhok = Uv[density_idx(nmat, k)][0] / asafe
            rek = Uv[energy_idx(nmat, k)][0] / asafe
            rows += [qrow, zK.at[0].set(q0), zK.at[0].set(flag),
                     zK.at[0].set(rhok), zK.at[0].set(rek)]
        return jnp.stack(rows)

    # -- P0 rhs ----------------------------------------------------------------

    def rhs_p0(self, geom: DGGeom, U, t):
        """Finite-volume rhs (C, E) including non-conservative terms."""
        nmat, C = self.nmat, self.ncomp
        uL = U[:, geom.el]
        uR0 = U[:, geom.er]
        interior = geom.bctype == BC_INTERIOR

        # boundary ghost states
        gp = geom.node0[:, geom.el]  # P0: cell anchor is fine for Dirichlet
        dirich = self.problem.solution(gp, t)
        uR = jnp.where(
            interior,
            uR0,
            jnp.where(
                geom.bctype == BC_DIRICHLET, dirich,
                self.bc_state(geom.bctype, uL, geom.fn),
            ),
        )

        flx, ap, vriem = self.ausm(geom.fn, uL, uR)
        wt = geom.farea * geom.fmask  # single-point face rule for P0

        contribL = -wt * flx
        contribR = wt * flx
        # riemannDeriv contributions: dap[3k+i] += wt ap_k fn_i ; div u term
        dapL = jnp.stack([wt * ap[k] * geom.fn[i] for k in range(nmat)
                          for i in range(3)])
        divL = wt * vriem

        zc = jnp.zeros((C, 1), dtype=U.dtype)
        padL = jnp.concatenate([contribL, zc], axis=1)
        padR = jnp.concatenate([contribR, zc], axis=1)
        zd = jnp.zeros((3 * nmat, 1), dtype=U.dtype)
        dpad = jnp.concatenate([dapL, zd], axis=1)
        vpad = jnp.concatenate([divL, jnp.zeros((1,), U.dtype)])

        R = jnp.zeros((C, geom.nelem), dtype=U.dtype)
        dap = jnp.zeros((3 * nmat, geom.nelem), dtype=U.dtype)
        divu = jnp.zeros((geom.nelem,), dtype=U.dtype)
        for i in range(4):
            f = geom.fose[i]
            side = geom.fsideR[i]
            sgn = 1.0 - 2.0 * side  # +1 left side, -1 right side
            R = R + jnp.where(side > 0, padR[:, f], padL[:, f])
            dap = dap + sgn * dpad[:, f]
            divu = divu + sgn * vpad[f]

        R = R + self._nonconservative(geom, U, dap, divu)
        return R * geom.emask

    def rhs(self, geom: DGGeom, U, t, face_gp=False):
        """Order-dispatching rhs: P0 keeps the finite-volume path;
        P1 (ndof==4) runs the generic DG machinery (pde/dg.py dg_rhs)
        through the facade — the riemannDeriv rows (partial-pressure
        gradients and velocity divergence, Surface.cpp:282-289) ride the
        k=0 accumulation rows of 3*nmat+1 zero-state components, and the
        non-conservative volume terms are then integrated against the
        basis at the volume Gauss points.  Returns (C*K, E)."""
        K = geom.ndof
        if K == 1:
            return self.rhs_p0(geom, U, t)
        from .dg import dg_rhs

        nmat, C = self.nmat, self.ncomp
        E = U.shape[-1]
        nx = 3 * nmat + 1
        thinc = self.intsharp
        facade = _MMFacade(self, thinc=thinc)
        Uv = U.reshape(C, K, E)
        parts = [Uv, jnp.zeros((nx, K, E), U.dtype)]
        if thinc:
            parts.append(self.thinc_carriers(geom, Uv).astype(U.dtype))
        Up = jnp.concatenate(parts, axis=0).reshape(facade.ncomp * K, E)
        acc = dg_rhs(facade, geom, Up, None, t, face_gp=face_gp)
        accv = acc.reshape(facade.ncomp, K, E)
        dap = accv[C:C + 3 * nmat, 0, :]
        divu = accv[C + 3 * nmat, 0, :]
        R = accv[:C] + self._nonconservative_ho(geom, Uv, dap, divu)
        return (R * geom.emask).reshape(C * K, E)

    def _nonconservative_ho(self, geom: DGGeom, Uv, dap, divu):
        """High-order non-conservative volume integral: the face-summed
        riemannDeriv surrogates for grad(alpha_k p_k) and div(u) are
        cell-constant (divided by vol), the state is evaluated at the
        volume Gauss points, and the product is integrated against every
        basis function (MultiMatTerms.cpp nonConservativeInt at P0 is the
        1-point special case).  Uv (C, K, E); returns (C, K, E)."""
        nmat, C = self.nmat, self.ncomp
        K, E = Uv.shape[1], Uv.shape[2]
        tb = geom.tables
        dt_ = Uv.dtype
        V = geom.vol * geom.emask + (1.0 - geom.emask)
        dapv = dap / V                                   # (3*nmat, E)
        divuv = divu / V                                 # (E,)
        B_vol = jnp.asarray(tb["B_vol"], dtype=dt_)      # (G,K)
        wB = jnp.asarray(tb["w_vol"][:, None] * tb["B_vol"], dtype=dt_)
        s = jnp.einsum("gk,cke->cge", B_vol, Uv, precision=HI)  # (C,G,E)
        rho = sum(s[density_idx(nmat, k)] for k in range(nmat))
        vel = [s[momentum_idx(nmat, i)] / rho for i in range(3)]
        dap_tot = [sum(dapv[3 * k + i] for k in range(nmat))
                   for i in range(3)]
        ncf = [jnp.zeros_like(s[0]) for _ in range(C)]
        for k in range(nmat):
            ncf[volfrac_idx(nmat, k)] = s[volfrac_idx(nmat, k)] * divuv
            y_k = s[density_idx(nmat, k)] / rho
            e = jnp.zeros_like(s[0])
            for i in range(3):
                e = e - vel[i] * (y_k * dap_tot[i] - dapv[3 * k + i])
            ncf[energy_idx(nmat, k)] = e
        Rnc = jnp.einsum("gk,cge->cke", wB, jnp.stack(ncf), precision=HI)
        return Rnc * (geom.vol * geom.emask)

    def _nonconservative(self, geom: DGGeom, U, dap, divu):
        """Non-conservative volume terms from the accumulated face sums
        (MultiMatTerms.cpp:140-170): alpha_k div(u) and the velocity-
        dotted pressure-gradient exchange in the material energies."""
        nmat, C = self.nmat, self.ncomp
        V = geom.vol * geom.emask + (1.0 - geom.emask)
        dap = dap / V
        divu = divu / V
        rho = sum(U[density_idx(nmat, k)] for k in range(nmat))
        vel = [U[momentum_idx(nmat, i)] / rho for i in range(3)]
        dap_tot = [
            sum(dap[3 * k + i] for k in range(nmat)) for i in range(3)
        ]
        ncf = [jnp.zeros_like(divu) for _ in range(C)]
        for k in range(nmat):
            ncf[volfrac_idx(nmat, k)] = U[volfrac_idx(nmat, k)] * divu
            y_k = U[density_idx(nmat, k)] / rho
            e = jnp.zeros_like(divu)
            for i in range(3):
                e = e - vel[i] * (y_k * dap_tot[i] - dap[3 * k + i])
            ncf[energy_idx(nmat, k)] = e
        return geom.vol * geom.emask * jnp.stack(ncf)

    def dt(self, geom: DGGeom, U):
        """Order-dispatching max-charvel time step: P0 keeps the
        finite-volume sweep; P1 runs the generic dg_dt through the
        facade over the zero-padded state."""
        if geom.ndof == 1:
            return self.dt_p0(geom, U)
        from .dg import dg_dt

        C, K = self.ncomp, geom.ndof
        E = U.shape[-1]
        nx = 3 * self.nmat + 1
        facade = _MMFacade(self)
        Up = jnp.concatenate(
            [U.reshape(C, K, E), jnp.zeros((nx, K, E), U.dtype)], axis=0
        ).reshape((C + nx) * K, E)
        return dg_dt(facade, geom, Up, None)

    def dt_p0(self, geom: DGGeom, U):
        uL = U[:, geom.el]
        uR = U[:, geom.er]
        wt = geom.farea * geom.fmask
        interior = geom.bctype == BC_INTERIOR
        dl = wt * self.charvel(uL, geom.fn)
        dr = wt * self.charvel(uR, geom.fn)
        mx = jnp.where(interior, jnp.maximum(dl, dr), dl)
        delt = sum(mx[geom.fose[i]] for i in range(4))
        big = jnp.asarray(jnp.finfo(U.dtype).max, dtype=U.dtype)
        elemdt = geom.vol / jnp.maximum(delt, 1e-300)
        return jnp.where(geom.emask > 0, elemdt, big).min()

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)



def clean_alpha_closure(u, C, K, nmat):
    """Enforce the sum_k alpha_k == 1 closure on ALL dof rows: the
    majority material's fraction dofs are replaced by
    (1,0,0,0) - sum of the others (the alpha part of upstream
    Quinoa's cleanTraceMultiMat; without it the truncation-level
    total-alpha slope content feeds back through the face states
    and drifts the means ~1e-3 per 10 steps through shocks).  P1+
    only — at P0 the scheme preserves the sum to round-off."""
    E = u.shape[-1]
    Uv = u.reshape(C, K, E)
    al = Uv[:nmat]                                   # (nmat,K,E)
    kmax = jnp.argmax(al[:, 0, :], axis=0)           # (E,)
    unit0 = jnp.zeros((K, E), u.dtype).at[0].set(1.0)
    total = al.sum(axis=0)                           # (K,E)
    fix = unit0[None] - (total[None] - al)           # (nmat,K,E)
    onehot = jnp.arange(nmat)[:, None, None] == kmax[None, None, :]
    al_new = jnp.where(onehot, fix, al)
    return Uv.at[:nmat].set(al_new).reshape(C * K, E)


def mm_consistent_limit(system, geom, u):
    """Consistent material-fraction Superbee limiting for multimat
    DG(P1): the Superbee phi with the common-alpha adjustment
    (pde/limiter.py consistent_mm_phi), shared by the single-device
    and SPMD solvers."""
    from .limiter import superbee_phi, consistent_mm_phi

    C, K = system.ncomp, geom.ndof
    E = u.shape[-1]
    phi = superbee_phi(geom, u, None, C)
    phi = consistent_mm_phi(phi, system.nmat)
    Uv = u.reshape(C, K, E)
    return Uv.at[:, 1:4, :].multiply(phi[:, None, :]).reshape(C * K, E)


class _MMFacade:
    """Adapter presenting AUSM+up flux + riemannDeriv + velocity
    divergence as one (C + 3*nmat + 1)-row 'flux', so the generic DG
    face pass (pde/dg.py dg_rhs) accumulates multimat's conservative
    AND non-conservative face sums in a single pass (DGMultiMat.hpp rhs
    + Surface.cpp:282-289 riemannDeriv).  The state rows beyond C are
    zero padding; signs are chosen so dg_rhs's (-L, +R) convention
    reproduces rhs_p0's (+dap at L, -dap at R) accumulation.
    """

    has_src = False
    needs_face_gp = False

    def __init__(self, mm: "MultiMatSystem", thinc=False):
        self.mm = mm
        self.thinc = bool(thinc)
        self.ncomp = mm.ncomp + 3 * mm.nmat + 1
        if self.thinc:
            self.ncomp += 5 * mm.nmat

    def _thinc_faces(self, s):
        """Replace the face-evaluated volume fractions of flagged
        interface cells by the THINC tanh profile, renormalize the
        fractions to sum to 1, and re-derive the conserved rows from
        the linearly-reconstructed material primitives (density,
        energy density, velocity) so the material state stays
        continuous through the sharpened fraction."""
        mm = self.mm
        C, nmat = mm.ncomp, mm.nmat
        base = C + 3 * nmat + 1
        beta = mm.thinc_beta
        floor = 50.0 * jnp.finfo(s.dtype).eps
        a_lin = [s[volfrac_idx(nmat, k)] for k in range(nmat)]
        a_new, flags = [], []
        for k in range(nmat):
            q = s[base + 5 * k]
            q0 = s[base + 5 * k + 1]
            flag = s[base + 5 * k + 2]
            ath = 0.5 * (1.0 + jnp.tanh(beta * (q - q0)))
            flags.append(flag > 0.5)
            a_new.append(jnp.where(flags[k], ath, a_lin[k]))
        ssum = sum(a_new)
        a_new = [a / jnp.maximum(ssum, floor) for a in a_new]
        rho_new = jnp.zeros_like(s[0])
        rho_lin = jnp.zeros_like(s[0])
        rows = [s[r] for r in range(s.shape[0])]
        for k in range(nmat):
            # flagged cells re-derive the conserved rows from the
            # cell-MEAN material primitives (well-conditioned: the mean
            # fraction is >= delta there); unflagged rows pass through
            rhok = s[base + 5 * k + 3]
            rek = s[base + 5 * k + 4]
            dk = jnp.where(flags[k], a_new[k] * rhok,
                           s[density_idx(nmat, k)])
            ek = jnp.where(flags[k], a_new[k] * rek,
                           s[energy_idx(nmat, k)])
            rows[volfrac_idx(nmat, k)] = a_new[k]
            rows[density_idx(nmat, k)] = dk
            rows[energy_idx(nmat, k)] = ek
            rho_new = rho_new + dk
            rho_lin = rho_lin + s[density_idx(nmat, k)]
        for i in range(3):
            vi = s[momentum_idx(nmat, i)] / rho_lin
            rows[momentum_idx(nmat, i)] = rho_new * vi
        return jnp.stack(rows)

    def bc_state(self, bctype, sL, fn, gp, t):
        C = self.mm.ncomp
        core = self.mm.bc_state(bctype, sL[:C], fn)
        if gp is not None:
            # coordinate BC (Dirichlet): the caller passes the face
            # Gauss coordinates only when a Dirichlet face exists
            dirich = self.mm.problem.solution(gp, t).astype(sL.dtype)
            core = jnp.where(bctype == BC_DIRICHLET, dirich, core)
        return jnp.concatenate([core, sL[C:]], axis=0)

    def flux_cols(self, state, gp, t):
        """Conservative volume-flux columns; the riemannDeriv carrier
        rows have no volume flux (they only accumulate face sums)."""
        C = self.mm.ncomp
        cols = self.mm.flux_cols(state[:C], gp, t)
        z = jnp.zeros_like(state[C:])
        return [jnp.concatenate([c, z], axis=0) for c in cols]

    def riemann(self, fn, sL, sR, gp, t):
        mm = self.mm
        C, nmat = mm.ncomp, mm.nmat
        if self.thinc:
            sL = self._thinc_faces(sL)
            sR = self._thinc_faces(sR)
        flx, ap, vriem = mm.ausm(fn, sL[:C], sR[:C])
        dap = jnp.stack([ap[k] * fn[i] for k in range(nmat)
                         for i in range(3)])
        rows = [flx, -dap, -vriem[None]]
        if self.thinc:
            # THINC carriers have no flux: nothing accumulates
            rows.append(jnp.zeros_like(sL[C + 3 * nmat + 1:]))
        return jnp.concatenate(rows, axis=0)

    def charvel(self, s, fn, gp=None):
        return self.mm.charvel(s[:self.mm.ncomp], fn)


class MultiMatSolver:
    """SSP-RK3 DG(P0/P1) driver for the multi-material system.

    P0 is the reference fork's parity surface (DGMultiMat.hpp:154
    asserts ndof==1); P1 (ndof=4) is beyond-parity: the generic DG
    volume/surface machinery through the facade plus consistent
    material-fraction Superbee limiting (pde/limiter.py
    consistent_mm_phi)."""

    def __init__(self, system: MultiMatSystem, geom: DGGeom, cfl=0.5,
                 const_dt=None, limiter=None):
        if geom.ndof not in (1, 4):
            raise ValueError("multimat supports DG(P0) and DG(P1) only")
        if limiter not in (None, "superbeep1"):
            raise ValueError(
                f"unknown multimat limiter {limiter!r} (superbeep1 only: "
                "consistent fraction limiting needs the phi factors)")
        if limiter is not None and geom.ndof < 4:
            raise ValueError("limiters require ndof >= 4")
        self.system = system
        self.geom = geom
        self.cfl = cfl
        self.const_dt = const_dt
        self.limiter = limiter
        # CFL order scale (DG.cpp:1404-1418)
        p = {1: 0.0, 4: 1.0}[geom.ndof]
        self.cflscale = 1.0 / (2.0 * p + 1.0)
        # Dirichlet samples problem.solution at the face Gauss points,
        # which the face pass computes only when asked to
        self._has_dirichlet = bool(
            np.isin(np.asarray(geom.bctype), [BC_DIRICHLET]).any())
        self._step = jax.jit(self._step_impl)

    def _limit(self, geom, u):
        if self.limiter is None:
            return u
        return mm_consistent_limit(self.system, geom, u)

    def initial_state(self, t0=0.0):
        from ..inciter.dg import DGState

        g = self.geom
        # L2 projection onto the modal basis (P0: centroid average)
        from .dg import dg_initialize

        u0 = dg_initialize(self.system, g, t0)
        dtype = g.vol.dtype
        return DGState(
            u=u0.astype(dtype),
            ndofel=jnp.full((g.nelem,), g.ndof, dtype=jnp.int32),
            t=jnp.asarray(t0, dtype=dtype),
            it=jnp.asarray(0, dtype=jnp.int32),
            dt=jnp.asarray(0.0, dtype=dtype),
        )

    def step(self, state):
        return self._step(self.geom, state)

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def _minv(self, geom):
        if geom.ndof == 1:
            return 1.0 / geom.vol
        mn = jnp.asarray(geom.tables["mnorm"], dtype=geom.vol.dtype)
        inv = 1.0 / (geom.vol[None, :] * mn[:, None])    # (K,E)
        return jnp.tile(inv, (self.system.ncomp, 1))     # (C*K,E)

    def _clean_alpha(self, geom, u):
        return clean_alpha_closure(u, self.system.ncomp, geom.ndof,
                                   self.system.nmat)

    def _step_impl(self, geom, state):
        from ..inciter.dg import DGState, RK0, RK1

        un = state.u
        u = un
        if self.const_dt is not None:
            dt = jnp.asarray(self.const_dt, dtype=geom.vol.dtype)
        minv = self._minv(geom)
        for s in range(3):
            u = self._limit(geom, u)
            if s == 0:
                # RK anchor is the LIMITED stage-0 solution (DG.cpp:1471)
                un = u
                # dt on the LIMITED state: the raw P1 projection of a
                # discontinuous alpha can be negative at face points
                if self.const_dt is None:
                    dt = (self.system.dt(geom, u)
                          * self.cfl * self.cflscale)
            r = self.system.rhs(geom, u, state.t,
                                face_gp=self._has_dirichlet)
            u = RK0[s] * un + RK1[s] * (u + dt * r * minv)
            if geom.ndof > 1:
                u = self._clean_alpha(geom, u)
        return DGState(u=u, ndofel=state.ndofel, t=state.t + dt,
                       it=state.it + 1, dt=dt)

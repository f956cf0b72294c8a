"""Slope limiters for DG(P1): WENO and Superbee (feature-major layout).

Vectorized re-implementations of the reference's limiters
(src/PDE/Limiter.cpp: WENO_P1:29-152, Superbee_P1:154-317): the per-element
neighbor-stencil loops become gathers over the esuelT table with -1
neighbors masked.  U is (C*K, E).
"""

from __future__ import annotations

import jax.numpy as jnp

from .dg import uview


def weno_p1(geom, U, dofmask, C, cweight: float = 30.0):
    """WENO limiter on the three P1 dofs of every component."""
    K = geom.ndof
    E = U.shape[-1]
    Uv = uview(U, C, K)
    valid = (geom.esuelT >= 0).astype(U.dtype)  # (4,E)
    nbr = jnp.where(geom.esuelT < 0, 0, geom.esuelT)

    g0 = Uv[:, 1:4, :]  # (C,3,E) primary stencil
    stencils = [g0]
    wts = [jnp.full((E,), cweight, dtype=U.dtype)]
    for i in range(4):
        stencils.append(g0[:, :, nbr[i]] * valid[i])
        wts.append(valid[i])

    osc = [jnp.sqrt((s**2).sum(axis=1)) for s in stencils]  # each (C,E)
    w = [wt * (1.0e-8 + o) ** -2 for wt, o in zip(wts, osc)]
    wtot = sum(w)
    lim = sum(wi[:, None, :] * s for wi, s in zip(w, stencils)) / wtot[:, None, :]

    Unew = Uv.at[:, 1:4, :].set(lim)
    if dofmask is None:
        return Unew.reshape(C * K, E)
    active = dofmask[1] > 0  # (E,)
    return jnp.where(active, Unew.reshape(C * K, E), U)


def superbee_p1(geom, U, dofmask, C, beta_lim: float = 2.0):
    """Superbee TVD limiter: scale P1 dofs by a per-element, per-component
    coefficient from min/max bounds over face neighbors evaluated at all
    face quadrature points (Limiter.cpp:154-317)."""
    K = geom.ndof
    E = U.shape[-1]
    Uv = uview(U, C, K)
    phi = superbee_phi(geom, U, dofmask, C, beta_lim)
    Unew = Uv.at[:, 1:4, :].multiply(phi[:, None, :])
    if dofmask is None:
        return Unew.reshape(C * K, E)
    active = dofmask[1] > 0
    return jnp.where(active, Unew.reshape(C * K, E), U)


def neighbor_bounds(geom, u0):
    """Min/max of each element's own and face-neighbors' cell means:
    u0 (C, E) -> (umin, umax), each (C, E), over the esuelT table
    (-1 boundary neighbors are skipped)."""
    valid = geom.esuelT >= 0
    nbr = jnp.where(geom.esuelT < 0, 0, geom.esuelT)
    big = jnp.asarray(jnp.finfo(u0.dtype).max, dtype=u0.dtype)
    umax, umin = u0, u0
    for i in range(4):
        un = u0[:, nbr[i]]
        umax = jnp.maximum(umax, jnp.where(valid[i], un, -big))
        umin = jnp.minimum(umin, jnp.where(valid[i], un, big))
    return umin, umax


def superbee_phi(geom, U, dofmask, C, beta_lim: float = 2.0):
    """The Superbee limiter's per-(component, element) slope coefficient
    phi (C, E) without applying it — callers that post-process phi
    (consistent multi-material limiting) scale the P1 dofs themselves."""
    K = geom.ndof
    Uv = uview(U, C, K)
    Um = Uv if dofmask is None else Uv * dofmask[None]

    u0 = Uv[:, 0, :]  # (C,E)
    umin, umax = neighbor_bounds(geom, u0)

    B = geom.tables["B_selfface"]  # (4, G, K) numpy
    eps = 1.0e-14
    phi = jnp.ones_like(u0)
    for lf in range(4):
        for g in range(B.shape[1]):
            state = u0 * 0.0
            for k in range(K):
                state = state + float(B[lf, g, k]) * Um[:, k, :]
            uNeg = state - u0
            up = jnp.minimum(
                1.0, (umax - u0) / (2.0 * jnp.where(uNeg > eps, uNeg, 1.0))
            )
            dn = jnp.minimum(
                1.0, (umin - u0) / (2.0 * jnp.where(uNeg < -eps, uNeg, 1.0))
            )
            phi_gp = jnp.where(uNeg > eps, up, jnp.where(uNeg < -eps, dn, 1.0))
            phi_gp = jnp.maximum(
                0.0,
                jnp.maximum(
                    jnp.minimum(beta_lim * phi_gp, 1.0),
                    jnp.minimum(phi_gp, beta_lim),
                ),
            )
            phi = jnp.minimum(phi, phi_gp)

    return phi


def consistent_mm_phi(phi, nmat):
    """Consistent material-fraction limiting for multi-material DG(P1).

    The TVD analog of upstream Quinoa's consistentMultiMatLimiting_P1
    (the /root/reference fork never limits multimat — its DGMultiMat
    asserts ndof==1, DGMultiMat.hpp:154 — so this path is beyond-parity):

    - every volume-fraction slope scales by the SAME coefficient: since
      sum_k alpha_k == 1 element-wise the total alpha slope is zero, and
      only a uniform scaling keeps it zero at every quadrature point;
    - material density and energy slopes are cut at least as hard as the
      common fraction coefficient, so the derived material state
      rho_k = (alpha rho)_k / alpha_k stays bounded through interfaces.

    Momentum rows keep their own coefficients (the bulk velocity is
    already TVD-limited component-wise).  phi is (C, E) with the
    MultiMatIndexing layout; returns the adjusted (C, E)."""
    C = phi.shape[0]
    phi_al = phi[:nmat].min(axis=0)                      # (E,)
    phi = phi.at[:nmat].set(jnp.broadcast_to(phi_al, (nmat,) + phi_al.shape))
    phi = phi.at[nmat:2 * nmat].set(
        jnp.minimum(phi[nmat:2 * nmat], phi_al))
    phi = phi.at[2 * nmat + 3:C].set(
        jnp.minimum(phi[2 * nmat + 3:C], phi_al))
    return phi

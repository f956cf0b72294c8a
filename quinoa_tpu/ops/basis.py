"""Dubiner (orthogonal tetrahedral) basis functions.

Same polynomials as the reference (src/PDE/Integrate/Basis.cpp
eval_basis:268-307): Legendre-type orthogonal polynomials on the reference
tetrahedron, up to P2 (10 dofs).  Reference-space derivatives dB/dxi come
from forward-mode autodiff of the basis evaluation instead of the
hand-written tables (eval_dBdx_p1/p2) — identical values, no transcription.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def eval_basis(ndof: int, xi: jnp.ndarray) -> jnp.ndarray:
    """Dubiner basis at reference coordinates.

    xi : (..., 3) reference coordinates (xi, eta, zeta)
    Returns (..., ndof).
    """
    x, e, z = xi[..., 0], xi[..., 1], xi[..., 2]
    one = jnp.ones_like(x)
    B = [one]
    if ndof > 1:
        B += [
            2.0 * x + e + z - 1.0,
            3.0 * e + z - 1.0,
            4.0 * z - 1.0,
        ]
    if ndof > 4:
        B += [
            6 * x * x + e * e + z * z + 6 * x * e + 6 * x * z + 2 * e * z
            - 6 * x - 2 * e - 2 * z + 1,
            5 * e * e + z * z + 10 * x * e + 2 * x * z + 6 * e * z
            - 2 * x - 6 * e - 2 * z + 1,
            6 * z * z + 12 * x * z + 6 * e * z - 2 * x - e - 7 * z + 1,
            10 * e * e + z * z + 8 * e * z - 8 * e - 2 * z + 1,
            6 * z * z + 18 * e * z - 3 * e - 7 * z + 1,
            15 * z * z - 10 * z + 1,
        ]
    return jnp.stack(B, axis=-1)


def eval_basis_cm(ndof: int, xi: jnp.ndarray) -> jnp.ndarray:
    """Component-major Dubiner basis: xi (3, ...) -> (ndof, ...).

    Same polynomials as eval_basis, laid out for the feature-major
    convention (the long point axis stays last).
    """
    x, e, z = xi[0], xi[1], xi[2]
    one = jnp.ones_like(x)
    B = [one]
    if ndof > 1:
        B += [
            2.0 * x + e + z - 1.0,
            3.0 * e + z - 1.0,
            4.0 * z - 1.0,
        ]
    if ndof > 4:
        B += [
            6 * x * x + e * e + z * z + 6 * x * e + 6 * x * z + 2 * e * z
            - 6 * x - 2 * e - 2 * z + 1,
            5 * e * e + z * z + 10 * x * e + 2 * x * z + 6 * e * z
            - 2 * x - 6 * e - 2 * z + 1,
            6 * z * z + 12 * x * z + 6 * e * z - 2 * x - e - 7 * z + 1,
            10 * e * e + z * z + 8 * e * z - 8 * e - 2 * z + 1,
            6 * z * z + 18 * e * z - 3 * e - 7 * z + 1,
            15 * z * z - 10 * z + 1,
        ]
    return jnp.stack(B)


def eval_dbdxi(ndof: int, xi: jnp.ndarray) -> jnp.ndarray:
    """dB/dxi at reference coordinates: (..., ndof, 3), via autodiff."""
    flat = xi.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(lambda p: eval_basis(ndof, p)))(flat)
    return J.reshape(xi.shape[:-1] + (ndof, 3))


def mass_diag(ndof: int) -> np.ndarray:
    """Normalized diagonal mass entries m_k = (1/V)*int B_k^2 dV on the
    reference tet, so the DG mass matrix is M = vol * m_k
    (cf. tk::mass, src/PDE/Integrate/Mass.cpp: 1, 1/10, 3/10, 3/5, ...).

    Computed with the degree-5-exact 14-point rule (B_k^2 is degree <= 4).
    """
    from .quadrature import gauss_tet

    pts, w = gauss_tet(14)
    B = np.asarray(eval_basis(ndof, jnp.asarray(pts)))  # (14, ndof)
    return (w[:, None] * B * B).sum(axis=0)

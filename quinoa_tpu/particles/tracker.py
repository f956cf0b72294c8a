"""Passive particle tracking through the flow field.

Counterpart of the reference's Particles subsystem
(src/Particles/Tracker.hpp:36 — dead code in the reference fork, alive
here): seed massless tracers inside the mesh, advect them with the
flow velocity each time step, and write H5Part trajectories
(io/h5part.py, the H5PartWriter analog).

Array-program design: everything is feature-major with the particle axis
LAST — positions are (3, P), element ids (P,).  Point location is a
FIXED-HOP neighbor walk (tets are located by barycentric sign checks
against the esuel adjacency; data-dependent while loops don't compile
to static-shape programs, and a particle crosses at most CFL≈1 cells a
step, so K hops with K small is exact in practice and clamps safely at
boundaries).  The barycentric coordinates come from the P1 shape
functions: N_a(x) = 1/4 + grad_a . (x - centroid_e), with grad the
per-element constant gradients the CG geometry already carries.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.derived import gen_esuel
from ..mesh.geometry import tet_geometry


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["grad", "cent", "esuel", "inpoelT", "coords"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TrackerGeom:
    """Static per-mesh tables for particle location/interpolation.

    grad   : (4, 3, E)  P1 shape-function gradients
    cent   : (3, E)     element centroids
    esuel  : (4, E)     face-neighbor element ids (-1 = boundary)
    inpoelT: (4, E)     connectivity
    coords : (3, N)     node coordinates
    """

    grad: jnp.ndarray
    cent: jnp.ndarray
    esuel: jnp.ndarray
    inpoelT: jnp.ndarray
    coords: jnp.ndarray


def make_tracker_geom(mesh, dtype=None) -> TrackerGeom:
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    J, grad = tet_geometry(mesh.coords, mesh.inpoel)   # grad (E,4,3)
    cent = mesh.coords[mesh.inpoel].mean(axis=1)       # (E,3)
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)         # (E,4)
    return TrackerGeom(
        grad=jnp.asarray(np.transpose(grad, (1, 2, 0)), dtype=dtype),
        cent=jnp.asarray(cent.T, dtype=dtype),
        esuel=jnp.asarray(esuel.T.astype(np.int32)),
        inpoelT=jnp.asarray(mesh.inpoel.T.astype(np.int32)),
        coords=jnp.asarray(mesh.coords.T, dtype=dtype),
    )


def seed_particles(mesh, npar: int, seed: int = 0):
    """Volume-weighted element sampling + uniform barycentric draws:
    every particle starts strictly inside the mesh (the reference's
    Tracker::genpar analog).  Returns (xp (3, npar), ep (npar,))."""
    rng = np.random.default_rng(seed)
    J, _ = tet_geometry(mesh.coords, mesh.inpoel)
    p = J / J.sum()
    ep = rng.choice(mesh.nelem, size=npar, p=p)
    # uniform barycentric via sorted-uniform spacings
    u = np.sort(rng.random((npar, 3)), axis=1)
    lam = np.stack([u[:, 0], u[:, 1] - u[:, 0], u[:, 2] - u[:, 1],
                    1.0 - u[:, 2]], axis=1)            # (npar, 4)
    xp = np.einsum("pa,pad->dp", lam, mesh.coords[mesh.inpoel[ep]])
    return xp, ep.astype(np.int32)


def barycentric(geom: TrackerGeom, xp, ep):
    """N_a(x) for each particle in its element: (4, P)."""
    d = xp - geom.cent[:, ep]                          # (3, P)
    g = geom.grad[:, :, ep]                            # (4, 3, P)
    return 0.25 + (g * d[None]).sum(axis=1)            # (4, P)


def locate(geom: TrackerGeom, xp, ep, hops: int = 4):
    """Neighbor-walk relocation: hop across the most-violated face up
    to `hops` times; boundary faces clamp (particle stays in the last
    interior element, the reference's wall behavior for tracers)."""
    for _ in range(hops):
        lam = barycentric(geom, xp, ep)                # (4, P)
        worst = jnp.argmin(lam, axis=0)                # (P,)
        inside = lam.min(axis=0) >= -1e-12
        # face a of the reference tet is OPPOSITE node a: leaving
        # through negative N_a means crossing into esuel[a]
        nbr = geom.esuel[worst, ep]
        ep = jnp.where(inside | (nbr < 0), ep, nbr)
    return ep


def interp_nodal(geom: TrackerGeom, ep, lam, vals):
    """Interpolate nodal fields at particles: vals (C, N) -> (C, P)."""
    nd = geom.inpoelT[:, ep]                           # (4, P)
    return sum(lam[a][None, :] * vals[:, nd[a]] for a in range(4))


class ParticleTracker:
    """Advance tracers with a velocity callback; write H5Part.

    velocity_of(xp, ep, lam, t) -> (3, P): the flow velocity at the
    particle positions — analytic for transport problems, interpolated
    from the solution for flow solvers (the CLI wires both).
    """

    def __init__(self, mesh, velocity_of: Callable, hops: int = 4):
        self.geom = make_tracker_geom(mesh)
        self.velocity_of = velocity_of
        self.hops = hops
        self._advance = jax.jit(self._advance_impl)

    def _advance_impl(self, geom, xp, ep, t, dt, *vargs):
        """One RK2 (midpoint) advection step + relocation."""
        lam = barycentric(geom, xp, ep)
        v1 = self.velocity_of(geom, xp, ep, lam, t, *vargs)
        xm = xp + 0.5 * dt * v1
        em = locate(geom, xm, ep, self.hops)
        lamm = barycentric(geom, xm, em)
        v2 = self.velocity_of(geom, xm, em, lamm, t + 0.5 * dt, *vargs)
        xn = xp + dt * v2
        en = locate(geom, xn, ep, self.hops)
        # clamp: a particle whose element never contains it (left the
        # domain) freezes at its previous position
        lamn = barycentric(geom, xn, en)
        stuck = lamn.min(axis=0) < -1e-6
        xn = jnp.where(stuck[None, :], xp, xn)
        en = jnp.where(stuck, ep, en)
        return xn, en

    def advance(self, xp, ep, t, dt, *vargs):
        return self._advance(self.geom, jnp.asarray(xp),
                             jnp.asarray(ep), t, dt, *vargs)


def analytic_velocity(problem):
    """velocity_of adapter for transport problems (velocity(x, t) is
    closed-form, e.g. SlotCyl's solid-body rotation)."""

    def vel(geom, xp, ep, lam, t):
        v = problem.velocity(xp, t)                    # (C, 3, P)
        return v[0]

    return vel


def nodal_velocity():
    """velocity_of adapter interpolating nodal momentum/density
    (CG compflow: u (5, N) conserved [rho, rho*u, rho*v, rho*w, E])."""

    def vel(geom, xp, ep, lam, t, U):
        q = interp_nodal(geom, ep, lam, U)             # (5, P)
        return q[1:4] / q[0]

    return vel


def cell_velocity(C: int, K: int):
    """velocity_of adapter for DG solvers: the containing element's
    cell-mean momentum/density (P0 sampling; u is (C*K, E))."""

    def vel(geom, xp, ep, lam, t, U):
        Uv = U.reshape(C, K, -1)
        q = Uv[:, 0, ep]                               # (C, P)
        return q[1:4] / q[0]

    return vel

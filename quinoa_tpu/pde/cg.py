"""Continuous-Galerkin spatial operators (feature-major layout).

The device-side data structure and the CGPDE operator protocol.
Counterpart of the reference's CGPDE interface (src/PDE/CGPDE.hpp:43-130)
and its Transport implementation (src/PDE/Transport/CGTransport.hpp),
re-designed as pure functions over static geometry tables with a
feature-major layout: solution fields are (C, N), coordinates (3, N),
per-element tables carry the element axis LAST — so every materialized
array keeps its long axis contiguous.

Geometry (Jacobians, P1 shape-function gradients, nodal volumes) is
precomputed host-side in f64 once per (re)partition; assembly is gather-
based (quinoa_tpu.ops.assembly).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.geometry import tet_geometry, nodal_volumes
from ..ops.assembly import build_nsup, gather_nodes, assemble_add


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["coords", "inpoelT", "J", "grad", "vol", "emask", "nsup",
                 "coords_n", "ctr"],
    meta_fields=["nnode"],
)
@dataclasses.dataclass(frozen=True)
class CGGeom:
    """Static per-shard geometry tables for node-centered (CG) solvers.

    coords : (3, nnode)       node coordinates
    inpoelT: (4, nelem) i32   element connectivity (local node ids)
    J      : (nelem,)         element Jacobian = 6*volume (1.0 for padding)
    grad   : (4, 3, nelem)    P1 shape-function gradients (0 for padding)
    vol    : (nnode,)         nodal volumes, fully summed across shards
    emask  : (nelem,)         1.0 real element / 0.0 padding
    nsup   : (D, nnode) i32   assembly gather table (ops.assembly)
    nnode  : int              static node count
    """

    coords: jnp.ndarray
    inpoelT: jnp.ndarray
    J: jnp.ndarray
    grad: jnp.ndarray
    vol: jnp.ndarray
    emask: jnp.ndarray
    nsup: jnp.ndarray
    nnode: int
    # static element-node coordinate caches: coords_n (4, 3, E) and the
    # element centers ctr (3, E).  Gathering coords by inpoelT inside
    # the step costs a full XLA gather launch each (dt's wave-speed
    # sweep + the Taylor-Galerkin velocity/source evaluations = 4+
    # per-step gathers of purely STATIC data); builders precompute
    # them once instead (DiagCG.cpp re-derives these per rhs because
    # Charm++ chares own their coords).
    coords_n: Optional[jnp.ndarray] = None
    ctr: Optional[jnp.ndarray] = None

    @property
    def nelem(self) -> int:
        return self.inpoelT.shape[1]


def coords_cache_np(coords, inpoelT):
    """Host-side static coordinate caches: (…, 3, N) coords +
    (…, 4, E) inpoelT -> (coords_n (…, 4, 3, E), ctr (…, 3, E)).
    Leading shard axes are looped host-side (stacked builders)."""
    coords = np.asarray(coords)
    inpoelT = np.asarray(inpoelT)
    if coords.ndim == 2:
        from ..native import coords_cache as _native_cc
        nat = _native_cc(coords.T, inpoelT.T)
        if nat is not None:  # direct (4,3,E)-layout fill, no transpose copy
            return nat
        # one (4, E, 3) gather + transpose instead of four gathers
        cn = np.ascontiguousarray(
            coords.T[inpoelT].transpose(0, 2, 1))
        return cn, cn.mean(axis=0)
    pairs = [coords_cache_np(coords[s], inpoelT[s])
             for s in range(coords.shape[0])]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def cg_coords_n(geom: CGGeom):
    """Element-node coordinates (4, 3, E): the static cache when the
    builder filled it, else the per-step gather fallback."""
    if geom.coords_n is not None:
        return geom.coords_n
    return jnp.stack([geom.coords[:, geom.inpoelT[a]] for a in range(4)])


def cg_ctr(geom: CGGeom):
    """Element centers (3, E) with the same cache-or-gather contract."""
    if geom.ctr is not None:
        return geom.ctr
    return sum(geom.coords[:, geom.inpoelT[a]] for a in range(4)) / 4.0


def make_cggeom(mesh, dtype=None) -> CGGeom:
    """Build single-shard CGGeom from a host UnsMesh (no padding).

    dtype defaults to JAX's current default float dtype (f64 with x64 —
    matching the reference's tk::real — else f32).  Geometry is always
    derived in f64 on host.
    """
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    J, grad = tet_geometry(mesh.coords, mesh.inpoel)
    if not (J > 0).all():
        raise ValueError("mesh has non-positive element Jacobians")
    vol = nodal_volumes(mesh.coords, mesh.inpoel, mesh.nnode, J=J)
    nsup, _ = build_nsup(mesh.inpoel, mesh.nnode)
    cn, ctr = coords_cache_np(mesh.coords.T, mesh.inpoel.T)
    return CGGeom(
        coords=jnp.asarray(mesh.coords.T, dtype=dtype),
        inpoelT=jnp.asarray(mesh.inpoel.T, dtype=jnp.int32),
        J=jnp.asarray(J, dtype=dtype),
        grad=jnp.asarray(np.transpose(grad, (1, 2, 0)), dtype=dtype),
        vol=jnp.asarray(vol, dtype=dtype),
        emask=jnp.ones(mesh.nelem, dtype=dtype),
        nsup=jnp.asarray(nsup),
        nnode=int(mesh.nnode),
        coords_n=jnp.asarray(cn, dtype=dtype),
        ctr=jnp.asarray(ctr, dtype=dtype),
    )


def lumped_mass(geom: CGGeom) -> jnp.ndarray:
    """Assembled lumped mass diagonal (nnode,): per-shard partial sums.

    Each element contributes V/4 = J/24 to each of its four nodes
    (FluxCorrector::lump, src/Inciter/FluxCorrector.cpp:238-280).
    """
    w = (geom.J * geom.emask) / 24.0
    contrib = jnp.broadcast_to(w[None, None, :], (4, 1, geom.nelem))
    return assemble_add(contrib, geom.nsup)[0]


class CGTransport:
    """Scalar advection(-diffusion), two-stage Taylor-Galerkin.

    Semantics match the reference CGTransport (src/PDE/Transport/
    CGTransport.hpp:183-330 rhs, 331-395 dt); optional isotropic-tensor
    diffusion follows CGAdvDiff (Physics/CGAdvDiff.cpp:30-96).
    """

    def __init__(self, problem, ncomp: Optional[int] = None):
        self.problem = problem
        self.ncomp = ncomp if ncomp is not None else problem.ncomp
        d = getattr(problem, "diffusivity", ()) or ()
        self.diffusivity = (
            np.asarray(d, dtype=np.float64).reshape(-1, 3) if len(d) else None
        )
        # dt() evaluates the velocity at t=0 by construction (matching
        # the reference's transport dt law, CGTransport.hpp:331-395), so
        # the sweep is unconditionally a run constant — drivers cache it
        self.static_dt = True

    # -- CGPDE protocol -----------------------------------------------------

    def initialize(self, xyz, t):
        return self.problem.solution(xyz, t)

    def analytic(self, xyz, t):
        return self.problem.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.problem.solinc(xyz, t, dt)

    def rhs(self, t, dt, geom: CGGeom, U):
        """Right-hand side (C, nnode): per-shard partial sums."""
        return assemble_add(
            self.rhs_contrib(t, dt, geom, U, gather_nodes(U, geom.inpoelT)),
            geom.nsup)

    def rhs_contrib(self, t, dt, geom: CGGeom, U, un):
        """Element-node rhs contributions (4, C, E), pre-assembly, from
        a shared nodal gather `un` (the DiagCG driver batches this
        assembly with the FCT mass-diffusion one)."""
        C, E = self.ncomp, geom.nelem

        # stage 1: element intermediate at t + dt/2
        # velocity at the four element nodes: (4, C, 3, E), from the
        # STATIC coords cache — no per-step gather
        cn = cg_coords_n(geom)
        vel_n = jnp.stack(
            [self.problem.velocity(cn[a], t) for a in range(4)]
        )
        # advective term: sum_a sum_j grad[a,j] * v[a,c,j] * u[a,c]
        adv = jnp.zeros((C, E), dtype=U.dtype)
        for a in range(4):
            for j in range(3):
                adv = adv + geom.grad[a, j] * vel_n[a, :, j, :] * un[a]
        ue = un.mean(axis=0) - 0.5 * dt * adv  # (C, E)

        # stage 2: element fluxes to nodes with center velocity
        vel_c = self.problem.velocity(cg_ctr(geom), t)  # (C, 3, E)
        d = dt * geom.J * geom.emask / 6.0  # (E,)

        vdotg = [
            sum(geom.grad[a, j] * vel_c[:, j, :] for j in range(3))
            for a in range(4)
        ]  # 4 x (C, E)
        contrib = jnp.stack([d * g * ue for g in vdotg])  # (4, C, E)

        if self.diffusivity is not None:
            # R_a -= dt*J/6 * D_k * grad[a,k] grad[b,k] u[b]
            D = jnp.asarray(self.diffusivity, dtype=U.dtype)  # (C, 3)
            diff = []
            for a in range(4):
                s = jnp.zeros((C, E), dtype=U.dtype)
                for k in range(3):
                    gb = sum(geom.grad[b, k] * un[b] for b in range(4))
                    s = s + D[:, k][:, None] * geom.grad[a, k] * gb
                diff.append(s)
            contrib = contrib - d * jnp.stack(diff)

        return contrib

    # -- ALECG callbacks ----------------------------------------------------

    def flux_at_nodes(self, u, xyz):
        """F_j = v_j(x) u at nodal states u (C, n)."""
        vel = self.problem.velocity(xyz, 0.0)  # (C, 3, n)
        return [vel[:, j, :] * u for j in range(3)]

    def charspeed(self, u, xyz):
        vel = self.problem.velocity(xyz, 0.0)
        return jnp.sqrt((vel**2).sum(axis=1)).max(axis=0)

    def dt(self, geom: CGGeom, U):
        """Minimum time-step over local elements (before CFL scaling)."""
        L = jnp.cbrt(geom.J / 6.0)
        cn = cg_coords_n(geom)
        speeds = []
        for a in range(4):
            v = self.problem.velocity(cn[a], 0.0)
            speeds.append(jnp.sqrt((v**2).sum(axis=1)).max(axis=0))  # (E,)
        maxvel = jnp.maximum(
            jnp.maximum(speeds[0], speeds[1]), jnp.maximum(speeds[2], speeds[3])
        )
        adv_dt = L / jnp.maximum(maxvel, 1e-300)
        if self.diffusivity is not None:
            dmax = float(self.diffusivity.max())
            elemdt = jnp.minimum(adv_dt, L * L / (2.0 * dmax))
        else:
            elemdt = adv_dt
        big = jnp.asarray(jnp.finfo(U.dtype).max, dtype=U.dtype)
        return jnp.where(geom.emask > 0, elemdt, big).min()

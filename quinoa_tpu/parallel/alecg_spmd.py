"""SPMD ALECG solver: RK3 node-centered scheme over a device mesh.

The distributed counterpart of quinoa_tpu.inciter.alecg.ALECGSolver — the
node-centered analog of the reference's ALECG chare array (src/Inciter/
ALECG.cpp:48-614, alecg.ci:29-73: comrhs per-neighbor sends + lhsmerge).
Like SPMDDiagCG, per-shard Galerkin + edge-Rusanov partial sums are
combined at shard-boundary nodes (HaloCombiner.sum) once per RK stage;
dt is a pmin; the lumped-mass lhs is the fully-summed nodal volume.

Edge-dissipation coefficients A_ab are per-shard PARTIAL sums (each
element contributes J/120 to its six edges on exactly one shard), so
summing the per-shard edge contributions at boundary nodes reproduces
the global operator exactly — the same partial-sum convention as every
other CG assembly here.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..inciter.alecg import (
    RK0, RK1, alecg_flux_rhs, alecg_dissipation, edge_arrays_np,
)
from ..inciter.diagcg import CGState
from .partition import partition_elements, partition_for
from .shard import ShardedCG, build_cg_shards
from .spmd import AXIS, HaloCombiner, PpermuteHalo, _local, place


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cg", "edgesT", "eA", "ensup", "exyz"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ShardedALECG:
    """ShardedCG plus stacked, padded per-shard edge tables.

    edgesT : (S, 2, EE) i32 local edge endpoints (0 for padding)
    eA     : (S, EE)    per-shard partial dual-face area scale (0 pad)
    ensup  : (S, De, Nl) i32 edge-slot assembly table (slots s*EE+e;
             pad slots point at 2*EE)
    """

    cg: ShardedCG
    edgesT: jnp.ndarray
    eA: jnp.ndarray
    ensup: jnp.ndarray
    exyz: "jnp.ndarray | None" = None  # (S, 2, 3, EE) static endpoint coords


def build_alecg_shards(
    mesh,
    nshard: int,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype=None,
    hierarchy=None,
) -> ShardedALECG:
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    coords, inpoel = mesh.coords, mesh.inpoel
    epart = partition_for(coords, inpoel, nshard, algorithm,
                          hierarchy=hierarchy)
    cg = build_cg_shards(
        mesh, nshard, ncomp, bcnodes=bcnodes, algorithm=algorithm,
        dtype=dtype, epart=epart,
    )

    elems = [np.nonzero(epart == s)[0] for s in range(nshard)]
    nodes = [np.unique(inpoel[e].ravel()) for e in elems]
    Nmax = cg.geom.nnode

    per = []
    for s in range(nshard):
        g2l = np.full(mesh.nnode, -1, dtype=np.int64)
        g2l[nodes[s]] = np.arange(len(nodes[s]))
        loc_inpoel = g2l[inpoel[elems[s]]]
        edges, A, ensup, D = edge_arrays_np(
            coords[nodes[s]], loc_inpoel, len(nodes[s])
        )
        per.append((edges, A, ensup, len(nodes[s])))

    EE = max(len(p[0]) for p in per)
    De = max(p[2].shape[0] for p in per)
    S = nshard
    s_edges = np.zeros((S, 2, EE), dtype=np.int32)
    s_A = np.zeros((S, EE))
    s_xyz = np.zeros((S, 2, 3, EE))
    s_ensup = np.full((S, De, Nmax), 2 * EE, dtype=np.int32)
    for s, (edges, A, ensup, nn) in enumerate(per):
        ne = len(edges)
        s_edges[s, :, :ne] = edges.T
        s_A[s, :ne] = A
        sc = coords[nodes[s]]
        s_xyz[s, 0, :, :ne] = sc[edges[:, 0]].T
        s_xyz[s, 1, :, :ne] = sc[edges[:, 1]].T
        # remap slot ids a*ne + e into the padded slot space a*EE + e
        a_idx = ensup // ne if ne else ensup
        e_idx = ensup % ne if ne else ensup
        valid = ensup < 2 * ne
        s_ensup[s, : ensup.shape[0], :nn] = np.where(
            valid, a_idx * EE + e_idx, 2 * EE
        )
    return ShardedALECG(
        cg=cg,
        edgesT=jnp.asarray(s_edges),
        eA=jnp.asarray(s_A, dtype=dtype),
        ensup=jnp.asarray(s_ensup),
        exyz=jnp.asarray(s_xyz, dtype=dtype),
    )


class SPMDALECGSolver:
    """ALECG (RK3 + edge Rusanov) over a 1-D device mesh via shard_map."""

    def __init__(
        self,
        system,
        sharded: ShardedALECG,
        mesh: Mesh,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
    ):
        if mesh.shape[AXIS] != sharded.cg.nshard:
            raise ValueError(
                f"device mesh axis '{AXIS}' has {mesh.shape[AXIS]} devices, "
                f"but data is built for {sharded.cg.nshard} shards"
            )
        self.system = system
        self.sharded = place(sharded, mesh)
        self.mesh = mesh
        self.cfl = cfl
        self.const_dt = const_dt

        # scalars ride the shard axis as (S,) pieces (see spmd.py)
        spec_state = CGState(u=P(AXIS), t=P(AXIS), it=P(AXIS),
                             dt=P(AXIS))
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

    # -- per-shard bodies ---------------------------------------------------

    def _step_local(self, sharded, state):
        sh: ShardedALECG = _local(sharded)
        geom = sh.cg.geom
        u = state.u[0]

        if sh.cg.nhalo is not None:
            halo = PpermuteHalo(sh.cg.nhalo, self.sharded.cg.nshard)
        else:
            halo = HaloCombiner(sh.cg.bnd_slot, sh.cg.rev_slot,
                                self.sharded.cg.nb)

        if self.const_dt is not None:
            dt = jnp.asarray(self.const_dt, dtype=u.dtype)
        else:
            dt = jax.lax.pmin(
                self.system.dt(geom, u) * self.cfl / 3.0, AXIS
            )

        un = u
        ts = (state.t[0], state.t[0] + dt, state.t[0] + 0.5 * dt)
        to = (state.t[0] + dt, state.t[0] + 0.5 * dt, state.t[0] + dt)
        for s in range(3):
            r = alecg_flux_rhs(self.system, geom, u) + alecg_dissipation(
                self.system, geom, sh.edgesT, sh.eA, sh.ensup, u,
                exyz=sh.exyz,
            )
            r = halo.sum(r)
            if getattr(self.system.problem, "manufactured", False):
                # nodal manufactured source (single-device parity);
                # added AFTER the combine — it is a complete nodal
                # value, not a partial sum
                r = r + geom.vol[None, :] * self.system.problem.src(
                    geom.coords, ts[s]).astype(u.dtype)
            # lumped mass == fully-summed nodal volume (ALECG lhsmerge)
            u = RK0[s] * un + RK1[s] * (u + dt * r / geom.vol[None, :])
            ubc = self.system.analytic(geom.coords,
                                       to[s]).astype(u.dtype)
            u = jnp.where(sh.cg.bcmask > 0, ubc, u)

        return CGState(u=u[None], t=(state.t[0] + dt)[None],
                       it=(state.it[0] + 1)[None], dt=dt[None])

    def _diag_local(self, sharded, state):
        sh: ShardedALECG = _local(sharded)
        u = state.u[0]
        geom = sh.cg.geom
        w = (geom.vol * sh.cg.owned)[None, :]
        vol_tot = jax.lax.psum((geom.vol * sh.cg.owned).sum(), AXIS)
        l2sol = jnp.sqrt(jax.lax.psum((u * u * w).sum(1), AXIS) / vol_tot)
        a = self.system.analytic(geom.coords, state.t[0]).astype(u.dtype)
        e = (u - a) * (sh.cg.owned[None, :] > 0)
        l2err = jnp.sqrt(jax.lax.psum((e * e * w).sum(1), AXIS) / vol_tot)
        linferr = jax.lax.pmax(jnp.abs(e).max(1), AXIS)
        return l2sol, l2err, linferr

    # -- public API -----------------------------------------------------------

    def initial_state(self, t0: float = 0.0) -> CGState:
        dtype = self.sharded.cg.geom.vol.dtype
        coords = self.sharded.cg.geom.coords  # (S, 3, Nl)
        u0 = jax.vmap(lambda c: self.system.initialize(c, t0))(coords)
        u0 = jax.device_put(
            u0.astype(dtype),
            jax.sharding.NamedSharding(self.mesh, P(AXIS)),
        )
        S = self.sharded.cg.nshard
        shard = jax.sharding.NamedSharding(self.mesh, P(AXIS))
        return CGState(
            u=u0,
            t=jax.device_put(jnp.full((S,), t0, dtype=dtype), shard),
            it=jax.device_put(jnp.zeros((S,), dtype=jnp.int32), shard),
            dt=jax.device_put(jnp.zeros((S,), dtype=dtype), shard),
        )

    def step(self, state: CGState) -> CGState:
        return self._step(self.sharded, state)

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def diagnostics(self, state: CGState):
        l2sol, l2err, linferr = self._diag(self.sharded, state)
        return (np.asarray(l2sol), np.asarray(l2err), np.asarray(linferr))

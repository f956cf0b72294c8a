"""SPMD DiagCG solver: one XLA program over a jax.sharding.Mesh.

The distributed counterpart of quinoa_tpu.inciter.DiagCGSolver: the same
step kernel (inciter.diagcg.diagcg_advance) is wrapped in `shard_map` over
a 1-D device mesh; the three node-buffer combine hooks become

    gather(local boundary partials -> global boundary buffer)
      -> psum / pmax / pmin over the shard axis   (NCCL over NVLink)
      -> gather(buffer -> local boundary nodes)

replacing the reference's DistFCT/DiagCG per-neighbor point-to-point
messages (comrhs/comaec/comalw/comlim) and its custom reducers; dt is a
`pmin`, diagnostics are ownership-masked psum/pmax (SURVEY.md §5.8).

Fields are feature-major: u is (C, Nl) per shard, and the boundary buffer
(C, nb+1) is built by *gathering* through the rev_slot table (each slot's
node lives on a shard at most once, so no scatter is ever needed).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..fct.fct import FCT
from ..inciter.diagcg import CGState, diagcg_advance
from .shard import ShardedCG

AXIS = "shard"


def _local(tree):
    """Strip the leading length-1 block axis shard_map leaves on inputs."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def place(tree, mesh: Mesh):
    """Lay every leaf's leading shard axis over the device mesh.  Tables
    left on one device would be copied out to the others on every
    dispatch, and the step would run at the speed of those copies."""
    return jax.device_put(tree, jax.sharding.NamedSharding(mesh, P(AXIS)))


class PpermuteHalo:
    """Per-neighbor boundary-node combines via lax.ppermute rounds.

    One permute per occurring shard-id offset; per-device exchange
    volume is O(local boundary), independent of the device count —
    matching the reference's per-neighbor comrhs/comaec/... messages
    (DiagCG.cpp:309-321) instead of the global-buffer psum.  Sender and
    receiver slabs are ordered identically (by global node id), so the
    receiver folds slab position j into its local node via a gather
    through `rpos` (pad -> a fill column appended on the receive side).
    """

    def __init__(self, nhalo, nshard: int):
        self.h = nhalo
        self.S = nshard

    def _combine(self, x, fill, op):
        C, Nl = x.shape
        xp = jnp.concatenate(
            [x, jnp.zeros((C, 1), dtype=x.dtype)], axis=1
        )
        out = x
        for d, send, rpos, L in zip(self.h.offsets, self.h.send,
                                    self.h.rpos, self.h.Ls):
            perm = [(s, s + d) for s in range(self.S)
                    if 0 <= s + d < self.S]
            slab = xp[:, send]                      # (C, L)
            rec = jax.lax.ppermute(slab, AXIS, perm)
            rec = jnp.concatenate(
                [rec, jnp.full((C, 1), fill, dtype=x.dtype)], axis=1
            )
            out = op(out, rec[:, rpos])
        return out

    def sum(self, x):
        return self._combine(x, 0.0, jnp.add)

    def max(self, x):
        return self._combine(x, jnp.finfo(x.dtype).min, jnp.maximum)

    def min(self, x):
        return self._combine(x, jnp.finfo(x.dtype).max, jnp.minimum)


class HaloCombiner:
    """Boundary-node buffer combines over the shard axis (gather-based).

    rev_slot may be (nb+1,) — each slot's node appears at most once on
    this shard — or (m, nb+1) for overdecomposed super-shards where a
    slot's node can live in up to m same-device chunk copies; the m
    copies fold elementwise before the cross-device reduction."""

    def __init__(self, bnd_slot, rev_slot, nb: int):
        self.slot = bnd_slot  # (Nl,); == nb for interior nodes
        self.rev = rev_slot  # (nb+1,) or (m, nb+1); == Nl when absent
        self.nb = nb
        self.is_bnd = bnd_slot < nb  # (Nl,)

    def _combine(self, x, fill, fold, reduce_op):
        if self.nb == 0:
            return x
        C, Nl = x.shape
        xpad = jnp.concatenate(
            [x, jnp.full((C, 1), fill, dtype=x.dtype)], axis=1
        )
        buf = xpad[:, self.rev]  # (C, nb+1) or (C, m, nb+1)
        if buf.ndim == 3:
            buf = fold(buf, axis=1)
        buf = reduce_op(buf, AXIS)
        g = buf[:, self.slot]  # trash column read back for interior nodes
        return jnp.where(self.is_bnd[None, :], g, x)

    def sum(self, x):
        return self._combine(x, 0.0, jnp.sum, jax.lax.psum)

    def max(self, x):
        return self._combine(
            x, jnp.finfo(x.dtype).min, jnp.max, jax.lax.pmax)

    def min(self, x):
        return self._combine(
            x, jnp.finfo(x.dtype).max, jnp.min, jax.lax.pmin)


class SPMDDiagCGSolver:
    """DiagCG+FCT over a 1-D device mesh via shard_map."""

    def __init__(
        self,
        system,
        sharded: ShardedCG,
        mesh: Mesh,
        cfl: float = 0.5,
        const_dt: Optional[float] = None,
        ctau: float = 1.0,
        fct: bool = True,
    ):
        if mesh.shape[AXIS] != sharded.nshard:
            raise ValueError(
                f"device mesh axis '{AXIS}' has {mesh.shape[AXIS]} devices, "
                f"but data is built for {sharded.nshard} shards"
            )
        self.system = system
        self.sharded = sharded = place(sharded, mesh)
        self.mesh = mesh
        self.cfl = cfl
        self.const_dt = const_dt
        self.fct = FCT(ctau=ctau)
        self.use_fct = fct

        # lumped-mass lhs == fully-assembled nodal volume (DiagCG::lhs +
        # lhsmerge; both equal sum_e J_e/24 over elements around the node)
        self.lhs = sharded.geom.vol

        # scalars ride the shard axis as (S,) arrays: a REPLICATED (P())
        # scalar output chained back into the next dispatch may cost a
        # resharding sync per dispatch, while P(AXIS) pieces chain like
        # any sharded buffer
        spec_state = CGState(u=P(AXIS), t=P(AXIS), it=P(AXIS),
                             dt=P(AXIS))

        step = jax.shard_map(
            self._step_local,
            mesh=self.mesh,
            in_specs=(P(AXIS), P(AXIS), spec_state),
            out_specs=spec_state,
        )
        # sharded tables are jit ARGUMENTS, not closure constants (constants
        # would be baked into the HLO and crush compile times)
        self._step = jax.jit(step)

        diag = jax.shard_map(
            self._diag_local,
            mesh=self.mesh,
            in_specs=(P(AXIS), spec_state),
            out_specs=(P(), P(), P()),
        )
        self._diag = jax.jit(diag)

    # -- per-shard bodies ---------------------------------------------------

    def _step_local(self, sharded, lhs, state):
        sh: ShardedCG = _local(sharded)
        geom = sh.geom
        lhs_l = _local(lhs)
        u = state.u[0]

        if sh.nhalo is not None:
            halo = PpermuteHalo(sh.nhalo, self.sharded.nshard)
        else:
            halo = HaloCombiner(sh.bnd_slot, sh.rev_slot, self.sharded.nb)

        if self.const_dt is not None:
            dt = jnp.asarray(self.const_dt, dtype=u.dtype)
        else:
            dt = jax.lax.pmin(self.system.dt(geom, u) * self.cfl, AXIS)

        unew = diagcg_advance(
            self.system,
            self.fct,
            self.use_fct,
            geom,
            lhs_l,
            sh.bcmask,
            u,
            state.t[0],
            dt,
            combine_sum=halo.sum,
            combine_max=halo.max,
            combine_min=halo.min,
        )
        return CGState(u=unew[None], t=(state.t[0] + dt)[None],
                       it=(state.it[0] + 1)[None], dt=dt[None])

    def _diag_local(self, sharded, state):
        """L2(sol), L2(err), Linf(err) with ownership-masked reductions."""
        sh: ShardedCG = _local(sharded)
        u = state.u[0]  # (C, Nl)
        w = (sh.geom.vol * sh.owned)[None, :]
        vol_tot = jax.lax.psum((sh.geom.vol * sh.owned).sum(), AXIS)
        l2sol = jnp.sqrt(jax.lax.psum((u * u * w).sum(1), AXIS) / vol_tot)
        a = self.system.analytic(sh.geom.coords, state.t[0]).astype(u.dtype)
        e = (u - a) * (sh.owned[None, :] > 0)
        l2err = jnp.sqrt(jax.lax.psum((e * e * w).sum(1), AXIS) / vol_tot)
        linferr = jax.lax.pmax(jnp.abs(e).max(1), AXIS)
        return l2sol, l2err, linferr

    # -- public API -----------------------------------------------------------

    def initial_state(self, t0: float = 0.0) -> CGState:
        dtype = self.sharded.geom.vol.dtype
        coords = self.sharded.geom.coords  # (S, 3, Nl)
        u0 = jax.vmap(lambda c: self.system.initialize(c, t0))(coords)
        u0 = jax.device_put(
            u0.astype(dtype),
            jax.sharding.NamedSharding(self.mesh, P(AXIS)),
        )
        S = self.sharded.nshard
        shard = jax.sharding.NamedSharding(self.mesh, P(AXIS))
        return CGState(
            u=u0,
            t=jax.device_put(jnp.full((S,), t0, dtype=dtype), shard),
            it=jax.device_put(jnp.zeros((S,), dtype=jnp.int32), shard),
            dt=jax.device_put(jnp.zeros((S,), dtype=dtype), shard),
        )

    def step(self, state: CGState) -> CGState:
        return self._step(self.sharded, self.lhs, state)

    def nsteps(self, state, n):
        for _ in range(n):
            state = self.step(state)
        return state

    def diagnostics(self, state: CGState):
        l2sol, l2err, linferr = self._diag(self.sharded, state)
        return (np.asarray(l2sol), np.asarray(l2err), np.asarray(linferr))

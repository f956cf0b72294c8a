"""Overdecomposition: multiple mesh chunks per device (virtualization).

The reference's single biggest published perf lever is Charm++
overdecomposition — more chares than PEs, sized by
tk::linearLoadDistributor's virtualization parameter u in [0,1]
(LoadDistributor.cpp:23-90, doc/pages/inciter_performance.dox:21-62).
The analog here:

- `linear_load_distributor(u, nelem, npes)` picks the chunk count,
  rounded up to a multiple of npes so every device hosts the same
  number of chunks;
- the partitioner cuts nchunk = cpd*npes pieces; chunks are assigned to
  devices by LPT (longest-processing-time greedy) over their REAL
  element counts — the load-balance role Charm++ chare placement and
  migration play;
- each device's cpd chunks are then MERGED along the node/element axes
  into one super-shard (long trailing axes, the layout every kernel wants;
  no nested collectives), so the existing SPMD solvers run unchanged.
  A boundary node shared by two chunks of the same device appears as
  two local copies, so the boundary-buffer gather table becomes
  multi-copy: rev_slot (m, nb+1) with the combiner folding the m copies
  elementwise before the cross-device psum/pmax/pmin.

Smaller chunks give the assignment finer granularity: after AMR the
per-chunk loads diverge, and rebuilding only the chunk->device
assignment rebalances without repartitioning the mesh.  The chunk
bookkeeping (assign, per-chunk slices) is kept in OverdecomposedCG.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..base.load import linear_load_distributor
from ..pde.cg import CGGeom
from .shard import ShardedCG, build_cg_shards


def lpt_assign(costs: np.ndarray, npes: int, cpd: int) -> np.ndarray:
    """Longest-processing-time greedy: chunks (sorted by cost desc) go to
    the least-loaded device that still has capacity (cpd chunks each).
    Returns (npes, cpd) chunk ids."""
    nchunk = len(costs)
    assert nchunk == npes * cpd
    order = np.argsort(-np.asarray(costs), kind="stable")
    load = np.zeros(npes)
    fill = np.zeros(npes, dtype=np.int64)
    out = np.full((npes, cpd), -1, dtype=np.int64)
    for c in order:
        open_ = np.nonzero(fill < cpd)[0]
        d = open_[np.argmin(load[open_])]
        out[d, fill[d]] = c
        fill[d] += 1
        load[d] += costs[c]
    return out


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["sharded"],
    meta_fields=["npes", "cpd", "assign"],
)
@dataclasses.dataclass(frozen=True)
class OverdecomposedCG:
    """A merged ShardedCG (nshard=npes, multi-copy rev_slot) plus the
    chunk bookkeeping needed to rebalance by reassignment."""

    sharded: ShardedCG
    npes: int
    cpd: int
    assign: tuple  # (npes, cpd) chunk ids as tuple-of-tuples


def build_overdecomposed_cg(
    mesh,
    npes: int,
    virtualization: float,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype=None,
    epart: Optional[np.ndarray] = None,
) -> OverdecomposedCG:
    """Partition into linear_load_distributor-many chunks, LPT-assign
    them to devices, and merge each device's chunks into a super-shard
    the unchanged SPMD solvers can run."""
    _, nchare = linear_load_distributor(virtualization, mesh.nelem, npes)
    cpd = max(math.ceil(nchare / npes), 1)
    nchunk = cpd * npes
    base = build_cg_shards(
        mesh, nchunk, ncomp, bcnodes=bcnodes, algorithm=algorithm,
        dtype=dtype, epart=epart,
    )
    costs = np.asarray(base.geom.emask).sum(axis=1)
    assign = lpt_assign(costs, npes, cpd)
    perm = assign.reshape(-1)

    g = base.geom
    Nl = int(np.asarray(g.vol).shape[1])
    Emax = int(np.asarray(g.emask).shape[1])
    D = int(np.asarray(g.nsup).shape[1])
    nb = base.nb

    def grp(a):
        """(nchunk, ...) -> (npes, cpd, ...) in assignment order."""
        return np.asarray(a)[perm].reshape((npes, cpd) + a.shape[1:])

    coords = grp(g.coords)          # (npes, cpd, 3, Nl)
    inpoelT = grp(g.inpoelT)        # (npes, cpd, 4, Emax)
    J = grp(g.J)
    grad = grp(g.grad)              # (npes, cpd, 4, 3, Emax)
    vol = grp(g.vol)
    emask = grp(g.emask)
    nsup = grp(g.nsup)              # (npes, cpd, D, Nl)
    slot = grp(base.bnd_slot)       # (npes, cpd, Nl)
    owned = grp(base.owned)
    bcmask = grp(base.bcmask)       # (npes, cpd, C, Nl)
    gids = grp(base.gids)

    NlM, EM = cpd * Nl, cpd * Emax
    coff = (np.arange(cpd) * Nl)[None, :, None, None]
    inpoelT_m = (inpoelT + coff).transpose(0, 2, 1, 3).reshape(npes, 4, EM)

    # nsup values index the chunk's (4*Emax) gather-slot space
    # (a*Emax + e, pad = 4*Emax); remap into the merged (4*EM) space:
    # a*EM + c*Emax + e, pad -> 4*EM
    a_idx = nsup // Emax
    e_idx = nsup % Emax
    valid = nsup < 4 * Emax
    ch = (np.arange(cpd) * Emax)[None, :, None, None]
    nsup_m = np.where(valid, a_idx * EM + ch + e_idx, 4 * EM)
    nsup_m = nsup_m.transpose(0, 2, 1, 3).reshape(npes, D, NlM)

    slot_m = slot.reshape(npes, NlM)
    # multi-copy reverse table: each boundary slot's local positions
    rev_lists = [[[] for _ in range(nb)] for _ in range(npes)]
    for d in range(npes):
        on = np.nonzero(slot_m[d] < nb)[0]
        for p in on:
            rev_lists[d][slot_m[d][p]].append(p)
    m = max(
        (len(v) for dev in rev_lists for v in dev), default=1
    )
    rev_m = np.full((npes, m, nb + 1), NlM, dtype=np.int32)
    for d in range(npes):
        for s, v in enumerate(rev_lists[d]):
            rev_m[d, : len(v), s] = v

    from ..pde.cg import coords_cache_np

    coords_m = coords.transpose(0, 2, 1, 3).reshape(npes, 3, NlM)
    cn_m, ctr_m = coords_cache_np(coords_m, inpoelT_m)
    geom = CGGeom(
        coords=jnp.asarray(coords_m, dtype=g.coords.dtype),
        inpoelT=jnp.asarray(inpoelT_m),
        J=jnp.asarray(J.reshape(npes, EM), dtype=g.J.dtype),
        grad=jnp.asarray(
            grad.transpose(0, 2, 3, 1, 4).reshape(npes, 4, 3, EM),
            dtype=g.grad.dtype),
        vol=jnp.asarray(vol.reshape(npes, NlM), dtype=g.vol.dtype),
        emask=jnp.asarray(emask.reshape(npes, EM), dtype=g.emask.dtype),
        nsup=jnp.asarray(nsup_m),
        nnode=NlM,
        coords_n=jnp.asarray(cn_m, dtype=g.coords.dtype),
        ctr=jnp.asarray(ctr_m, dtype=g.coords.dtype),
    )
    merged = ShardedCG(
        geom=geom,
        bnd_slot=jnp.asarray(slot_m),
        rev_slot=jnp.asarray(rev_m),
        owned=jnp.asarray(owned.reshape(npes, NlM), dtype=g.vol.dtype),
        bcmask=jnp.asarray(
            bcmask.transpose(0, 2, 1, 3).reshape(npes, ncomp, NlM),
            dtype=g.vol.dtype),
        gids=jnp.asarray(gids.reshape(npes, NlM)),
        nhalo=None,  # multi-copy combine goes through the slot buffer
        nshard=npes,
        nb=nb,
        nnode_global=base.nnode_global,
        nelem_global=base.nelem_global,
    )
    return OverdecomposedCG(
        sharded=merged, npes=npes, cpd=cpd,
        assign=tuple(map(tuple, assign.tolist())),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["sharded"],
    meta_fields=["npes", "cpd", "assign"],
)
@dataclasses.dataclass(frozen=True)
class OverdecomposedDG:
    """A merged ShardedDG (nshard=npes) plus chunk bookkeeping."""

    sharded: object
    npes: int
    cpd: int
    assign: tuple


def build_overdecomposed_dg(
    mesh,
    npes: int,
    virtualization: float,
    ndof: int,
    bc_sidesets=None,
    algorithm: str = "sfc",
    dtype=None,
    elem_weights=None,
) -> OverdecomposedDG:
    """DG overdecomposition: cut linearLoadDistributor-many chunks with
    the existing stacked builder (uniformly padded El/Fl per chunk),
    LPT-assign, and merge each device's chunks along the element/face
    axes (connectivity offset per chunk block).  Ghost exchange runs
    through the global interface buffer (each interface element has ONE
    owner chunk, so the push table stays single-copy; same-device
    ghost copies pull through the buffer like remote ones)."""
    from ..pde.dg import DGGeom
    from .dg_shard import ShardedDG, build_dg_shards

    _, nchare = linear_load_distributor(virtualization, mesh.nelem, npes)
    cpd = max(math.ceil(nchare / npes), 1)
    nchunk = cpd * npes
    base = build_dg_shards(mesh, nchunk, ndof, bc_sidesets=bc_sidesets,
                           algorithm=algorithm, dtype=dtype)
    g = base.geom
    if elem_weights is None:
        costs = np.asarray(base.owned).sum(axis=1)
    else:
        # dynamic LB: chunk cost = summed per-element weight (active
        # dofs under p-adaptivity) — chunks keep their membership, only
        # the chunk->device packing migrates (chare migration analog)
        w = np.asarray(elem_weights, dtype=np.float64)
        eg = np.asarray(base.eglobal)
        owned = np.asarray(base.owned) > 0
        costs = np.array([w[eg[c][owned[c]]].sum()
                          for c in range(nchunk)])
    assign = lpt_assign(costs, npes, cpd)
    perm = assign.reshape(-1)

    El = int(np.asarray(g.vol).shape[1])
    Fl = int(np.asarray(g.el).shape[1])
    ElM, FlM = cpd * El, cpd * Fl
    nslots = base.nslots

    def grp(a):
        return np.asarray(a)[perm].reshape((npes, cpd) + a.shape[1:])

    def cat_e(a):  # (npes, cpd, ..., El) -> (npes, ..., cpd*El)
        x = grp(a)
        return np.moveaxis(x, 1, -2).reshape(
            x.shape[:1] + x.shape[2:-1] + (ElM,))

    def cat_f(a):
        x = grp(a)
        return np.moveaxis(x, 1, -2).reshape(
            x.shape[:1] + x.shape[2:-1] + (FlM,))

    eoff = (np.arange(cpd) * El)[None, :, None]
    foff = (np.arange(cpd) * Fl)[None, :, None]

    el = grp(base.geom.el) + eoff
    er = grp(base.geom.er) + eoff
    el = np.moveaxis(el, 1, -2).reshape(npes, FlM)
    er = np.moveaxis(er, 1, -2).reshape(npes, FlM)

    fose = grp(base.geom.fose)  # (npes, cpd, 4, El); pad = Fl
    fose = np.where(fose == Fl, FlM, fose + foff[:, :, None, :])
    fose = np.moveaxis(fose, 1, -2).reshape(npes, 4, ElM)

    esu = grp(base.geom.esuelT)  # (npes, cpd, 4, El); -1 absent
    esu = np.where(esu < 0, -1, esu + eoff[:, :, None, :])
    esu = np.moveaxis(esu, 1, -2).reshape(npes, 4, ElM)

    # per-device single-copy push table: the owning chunk's local id
    grev = grp(base.grev)  # (npes, cpd, nslots+1); pad = El
    grev_m = np.full((npes, nslots + 1), ElM, dtype=np.int32)
    for d in range(npes):
        for c in range(cpd):
            own = grev[d, c] < El
            grev_m[d, own] = c * El + grev[d, c][own]

    dt_ = np.asarray(g.vol).dtype
    geom = DGGeom(
        vol=jnp.asarray(cat_e(g.vol), dtype=dt_),
        jacInv=jnp.asarray(cat_e(g.jacInv), dtype=dt_),
        Jmat=jnp.asarray(cat_e(g.Jmat), dtype=dt_),
        node0=jnp.asarray(cat_e(g.node0), dtype=dt_),
        emask=jnp.asarray(cat_e(g.emask), dtype=dt_),
        el=jnp.asarray(el),
        er=jnp.asarray(er),
        fn=jnp.asarray(cat_f(g.fn), dtype=dt_),
        farea=jnp.asarray(cat_f(g.farea), dtype=dt_),
        xi_l=jnp.asarray(cat_f(g.xi_l), dtype=dt_),
        xi_r=jnp.asarray(cat_f(g.xi_r), dtype=dt_),
        bctype=jnp.asarray(cat_f(g.bctype)),
        fmask=jnp.asarray(cat_f(g.fmask), dtype=dt_),
        fose=jnp.asarray(fose),
        fsideR=jnp.asarray(cat_e(g.fsideR), dtype=dt_),
        esuelT=jnp.asarray(esu),
        ndof=int(ndof),
        nelem_real=g.nelem_real,
        tables=g.tables,
    )
    merged = ShardedDG(
        geom=geom,
        owned=jnp.asarray(cat_e(base.owned), dtype=dt_),
        gslot=jnp.asarray(cat_e(base.gslot)),
        grev=jnp.asarray(grev_m),
        eglobal=jnp.asarray(cat_e(base.eglobal)),
        ghalo=None,  # same-device ghosts ride the interface buffer
        nshard=npes,
        nslots=nslots,
        nelem_global=base.nelem_global,
    )
    return OverdecomposedDG(
        sharded=merged, npes=npes, cpd=cpd,
        assign=tuple(map(tuple, assign.tolist())),
    )


def build_overdecomposed_alecg(
    mesh,
    npes: int,
    virtualization: float,
    ncomp: int,
    bcnodes: Optional[np.ndarray] = None,
    algorithm: str = "sfc",
    dtype=None,
):
    """ALECG overdecomposition: the CG node/element merge plus per-chunk
    edge tables merged along the edge axis (slot space offset per
    chunk).  Shared-node dual-face areas stay per-chunk partial sums —
    the boundary-node combine totals them exactly as across shards."""
    from .alecg_spmd import ShardedALECG, edge_arrays_np
    from .partition import partition_elements

    if dtype is None:
        dtype = jnp.zeros(0).dtype
    _, nchare = linear_load_distributor(virtualization, mesh.nelem, npes)
    cpd = max(math.ceil(nchare / npes), 1)
    nchunk = cpd * npes
    coords, inpoel = mesh.coords, mesh.inpoel
    epart = partition_elements(coords, inpoel, nchunk, algorithm)
    over = build_overdecomposed_cg(
        mesh, npes, virtualization, ncomp, bcnodes=bcnodes,
        algorithm=algorithm, dtype=dtype, epart=epart,
    )
    assert over.cpd == cpd

    elems = [np.nonzero(epart == c)[0] for c in range(nchunk)]
    nodes = [np.unique(inpoel[e].ravel()) for e in elems]
    Nl = over.sharded.geom.nnode // cpd

    per = []
    for c in range(nchunk):
        g2l = np.full(mesh.nnode, -1, dtype=np.int64)
        g2l[nodes[c]] = np.arange(len(nodes[c]))
        loc_inpoel = g2l[inpoel[elems[c]]]
        edges, A, ensup, D = edge_arrays_np(
            coords[nodes[c]], loc_inpoel, len(nodes[c])
        )
        per.append((edges, A, ensup, len(nodes[c])))

    EE = max(len(p[0]) for p in per)
    De = max(p[2].shape[0] for p in per)
    EEM = cpd * EE
    s_edges = np.zeros((npes, 2, EEM), dtype=np.int32)
    s_A = np.zeros((npes, EEM))
    s_ensup = np.full((npes, De, cpd * Nl), 2 * EEM, dtype=np.int32)
    for d, row in enumerate(over.assign):
        for j, c in enumerate(row):
            edges, A, ensup, nn = per[c]
            ne = len(edges)
            s_edges[d, :, j * EE : j * EE + ne] = edges.T + j * Nl
            s_A[d, j * EE : j * EE + ne] = A
            a_idx = ensup // ne if ne else ensup
            e_idx = ensup % ne if ne else ensup
            valid = ensup < 2 * ne
            s_ensup[d, : ensup.shape[0], j * Nl : j * Nl + nn] = np.where(
                valid, a_idx * EEM + j * EE + e_idx, 2 * EEM
            )
    sh = ShardedALECG(
        cg=over.sharded,
        edgesT=jnp.asarray(s_edges),
        eA=jnp.asarray(s_A, dtype=dtype),
        ensup=jnp.asarray(s_ensup),
    )
    return OverdecomposedCG(sharded=sh, npes=npes, cpd=cpd,
                            assign=over.assign)

"""DG shard construction: ghost-element layer + exchange tables.

Counterpart of the reference DG chare's ghost machinery (src/Inciter/
DG.cpp:135-226 resizeComm, 469-714 setupGhost/comGhost — a 600-line
runtime handshake matching face node-triplets across chares): here the
host builds, once per (re)partition,

- per-shard local element sets = owned elements + the one-deep layer of
  face neighbors (ghosts), with all faces incident on owned elements;
- a global *interface-element buffer*: every element that is a ghost on
  some shard gets one slot; each stage the owner pushes its modal state
  into the buffer (gather + psum, one collective) and ghost holders pull
  — replacing the reference's per-neighbor comsol messages;
- faces-of-element tables built for owned elements only, so ghost rows
  never contribute garbage.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.derived import gen_esuel
from ..pde.dg import DGGeom, build_dggeom
from .partition import partition_elements, partition_for


def _build_ghost_halo(owned_l, ghosts_l, local_l, E, El, nshard):
    """Per-neighbor ghost-element exchange tables (NodeHalo layout, but
    asymmetric: the owner SENDS, the ghost holder RECEIVES — the comsol
    analog, src/Inciter/DG.cpp:1019-1036).  Slabs are ordered by global
    element id on both sides."""
    from .shard import NodeHalo

    if nshard < 2:
        return None
    owner = np.empty(E, dtype=np.int64)
    for s in range(nshard):
        owner[owned_l[s]] = s
    g2l = []
    for s in range(nshard):
        m = np.full(E, -1, dtype=np.int64)
        m[local_l[s]] = np.arange(len(local_l[s]))
        g2l.append(m)

    shared = {}
    for holder in range(nshard):
        gh = ghosts_l[holder]  # sorted global ids (np.unique)
        if not len(gh):
            continue
        for s in np.unique(owner[gh]):
            shared[(int(s), holder)] = gh[owner[gh] == s]

    offsets = sorted({h - s for (s, h) in shared})
    send, rpos, Ls = [], [], []
    for d in offsets:
        L = max(
            (len(v) for (s, h), v in shared.items() if h - s == d),
            default=0,
        )
        sd = np.full((nshard, L), El, dtype=np.int32)
        rp = np.full((nshard, El), L, dtype=np.int32)
        for s in range(nshard):
            v = shared.get((s, s + d))
            if v is not None:
                sd[s, : len(v)] = g2l[s][v]
            v = shared.get((s - d, s))
            if v is not None:
                rp[s, g2l[s][v]] = np.arange(len(v))
        send.append(jnp.asarray(sd))
        rpos.append(jnp.asarray(rp))
        Ls.append(L)
    return NodeHalo(
        send=tuple(send), rpos=tuple(rpos),
        offsets=tuple(int(d) for d in offsets), Ls=tuple(Ls),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["geom", "owned", "gslot", "grev", "eglobal", "ghalo"],
    meta_fields=["nshard", "nslots", "nelem_global"],
)
@dataclasses.dataclass(frozen=True)
class ShardedDG:
    """Stacked per-shard DG tables (leading axis = shard).

    geom    : DGGeom with leading [S] axis on every data field
    owned   : (S, El) 1.0 where the local element is owned by this shard
    gslot   : (S, El) i32 interface-buffer slot of the local element, or
              nslots for non-interface elements / padding
    grev    : (S, nslots+1) i32 local index of the slot's element IF this
              shard owns it, else El (a zero pad column) — the push table
    eglobal : (S, El) i32 global element id (-1 padding)
    """

    geom: DGGeom
    owned: jnp.ndarray
    gslot: jnp.ndarray
    grev: jnp.ndarray
    eglobal: jnp.ndarray
    ghalo: object
    nshard: int
    nslots: int
    nelem_global: int


def build_dg_shards(
    mesh,
    nshard: int,
    ndof: int,
    bc_sidesets: Optional[Dict[int, int]] = None,
    algorithm: str = "sfc",
    dtype=None,
    hierarchy=None,
    epart: Optional[np.ndarray] = None,
) -> ShardedDG:
    if dtype is None:
        dtype = jnp.zeros(0).dtype

    # global geometry (numpy views of the single-shard build).  Pin
    # its many small jnp stages to the LOCAL CPU backend: each would
    # otherwise compile and launch on the accelerator for a few hundred
    # elements' worth of work; everything is pulled to numpy here, so
    # nothing CPU-committed leaks into the device tables below.
    import contextlib

    try:
        _cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        _cpu = None
    with (jax.default_device(_cpu) if _cpu is not None
          else contextlib.nullcontext()):
        g = build_dggeom(mesh, ndof, bc_sidesets, dtype=dtype)
        gnp = {
            k: np.asarray(getattr(g, k))
            for k in ("vol", "jacInv", "Jmat", "node0", "el", "er", "fn",
                      "farea", "xi_l", "xi_r", "bctype", "fmask",
                      "esuelT")
        }
    E = mesh.nelem
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)  # (E,4)

    if epart is None:
        epart = partition_for(mesh.coords, mesh.inpoel, nshard, algorithm,
                              hierarchy=hierarchy)
    else:
        # explicit partition (dynamic load balancing rebuilds with a
        # weighted split; the Charm++ migration analog)
        epart = np.asarray(epart, dtype=np.int32)
        if epart.shape != (E,):
            raise ValueError("epart must be (nelem,)")

    owned_l, local_l, ghosts_l = [], [], []
    for s in range(nshard):
        own = np.nonzero(epart == s)[0]
        nbr = esuel[own].ravel()
        nbr = np.unique(nbr[nbr >= 0])
        ghosts = nbr[epart[nbr] != s]
        owned_l.append(own)
        ghosts_l.append(ghosts)
        local_l.append(np.concatenate([own, ghosts]))

    # interface elements: ghosts anywhere
    iface = np.unique(np.concatenate([gh for gh in ghosts_l])) if any(
        len(gh) for gh in ghosts_l
    ) else np.zeros(0, np.int64)
    nslots = len(iface)
    slot_of = np.full(E, nslots, dtype=np.int64)
    slot_of[iface] = np.arange(nslots)

    El = max(len(l) for l in local_l)
    # per-shard face sets: faces with el or er owned
    face_sets = []
    gel, ger = gnp["el"].astype(np.int64), gnp["er"].astype(np.int64)
    for s in range(nshard):
        m = (epart[gel] == s) | ((epart[ger] == s) & (ger != gel))
        face_sets.append(np.nonzero(m)[0])
    Fl = max(len(f) for f in face_sets)

    S = nshard
    G = gnp["xi_l"].shape[1]

    def zeros(shape, val=0.0):
        return np.full(shape, val)

    s_vol = zeros((S, El), 1.0)
    s_jacInv = zeros((S, 3, 3, El))
    s_Jmat = zeros((S, 3, 3, El))
    s_node0 = zeros((S, 3, El))
    s_emask = zeros((S, El))
    s_el = np.zeros((S, Fl), dtype=np.int32)
    s_er = np.zeros((S, Fl), dtype=np.int32)
    # padding faces keep a unit normal so the Riemann solver stays finite
    # (their weights are zero, but 0*NaN would poison the contributions)
    s_fn = zeros((S, 3, Fl))
    s_fn[:, 0, :] = 1.0
    s_farea = zeros((S, Fl))
    s_xil = zeros((S, 3, G, Fl))
    s_xir = zeros((S, 3, G, Fl))
    s_bct = np.zeros((S, Fl), dtype=np.int32)
    s_fmask = zeros((S, Fl))
    s_fose = np.full((S, 4, El), Fl, dtype=np.int32)
    s_fsideR = zeros((S, 4, El))
    s_esuelT = np.full((S, 4, El), -1, dtype=np.int32)
    s_owned = zeros((S, El))
    s_gslot = np.full((S, El), nslots, dtype=np.int32)
    s_grev = np.full((S, nslots + 1), El, dtype=np.int32)
    s_eglobal = np.full((S, El), -1, dtype=np.int32)

    for s in range(S):
        loc = local_l[s]
        nl = len(loc)
        nown = len(owned_l[s])
        g2l = np.full(E, -1, dtype=np.int64)
        g2l[loc] = np.arange(nl)

        s_vol[s, :nl] = gnp["vol"][loc]
        s_jacInv[s, :, :, :nl] = gnp["jacInv"][:, :, loc]
        s_Jmat[s, :, :, :nl] = gnp["Jmat"][:, :, loc]
        s_node0[s, :, :nl] = gnp["node0"][:, loc]
        s_emask[s, :nown] = 1.0  # emask marks OWNED elements (dt/diag)
        s_owned[s, :nown] = 1.0
        s_eglobal[s, :nl] = loc

        fs = face_sets[s]
        nf = len(fs)
        # el-sort the local faces, as the single-shard build does
        fs = fs[np.argsort(g2l[gel[fs]], kind="stable")]
        lel = g2l[gel[fs]]
        ler = g2l[ger[fs]]
        # a face's R element may be absent (face on the far side of a
        # ghost): clamp to L (boundary-style; such faces only feed ghost
        # rows, which fose ignores)
        ler = np.where(ler < 0, lel, ler)
        s_el[s, :nf] = lel
        s_er[s, :nf] = ler
        s_fn[s, :, :nf] = gnp["fn"][:, fs]
        s_farea[s, :nf] = gnp["farea"][fs]
        s_xil[s, :, :, :nf] = gnp["xi_l"][:, :, fs]
        s_xir[s, :, :, :nf] = gnp["xi_r"][:, :, fs]
        s_bct[s, :nf] = gnp["bctype"][fs]
        s_fmask[s, :nf] = 1.0

        # fose for owned elements only
        from ..native import build_fose_masked
        bad = build_fose_masked(lel, ler, gnp["bctype"][fs], El, nown,
                                s_fose[s], s_fsideR[s])
        if bad is not None:
            if bad:
                raise AssertionError("owned element missing face slots")
        else:
            slot = np.zeros(nl, dtype=np.int64)
            for fi in range(nf):
                for e_loc, side in ((lel[fi], 0.0), (ler[fi], 1.0)):
                    if e_loc < nown and (side == 0.0
                                         or ler[fi] != lel[fi]):
                        if side == 1.0 and gnp["bctype"][fs[fi]] != 0:
                            continue
                        s_fose[s, slot[e_loc], e_loc] = fi
                        s_fsideR[s, slot[e_loc], e_loc] = side
                        slot[e_loc] += 1
            if not (slot[:nown] == 4).all():
                raise AssertionError("owned element missing face slots")

        # limiter neighbors (local ids; -1 where absent)
        nb = esuel[loc]
        nbl = np.where(nb >= 0, g2l[np.clip(nb, 0, E - 1)], -1)
        nbl = np.where(nb >= 0, nbl, -1)
        s_esuelT[s, :, :nl] = nbl.T

        # ghost exchange tables
        s_gslot[s, :nl] = slot_of[loc]
        own_iface = owned_l[s][slot_of[owned_l[s]] < nslots]
        s_grev[s, slot_of[own_iface]] = g2l[own_iface]

    geom = DGGeom(
        vol=jnp.asarray(s_vol, dtype=dtype),
        jacInv=jnp.asarray(s_jacInv, dtype=dtype),
        Jmat=jnp.asarray(s_Jmat, dtype=dtype),
        node0=jnp.asarray(s_node0, dtype=dtype),
        emask=jnp.asarray(s_emask, dtype=dtype),
        el=jnp.asarray(s_el),
        er=jnp.asarray(s_er),
        fn=jnp.asarray(s_fn, dtype=dtype),
        farea=jnp.asarray(s_farea, dtype=dtype),
        xi_l=jnp.asarray(s_xil, dtype=dtype),
        xi_r=jnp.asarray(s_xir, dtype=dtype),
        bctype=jnp.asarray(s_bct),
        fmask=jnp.asarray(s_fmask, dtype=dtype),
        fose=jnp.asarray(s_fose),
        fsideR=jnp.asarray(s_fsideR, dtype=dtype),
        esuelT=jnp.asarray(s_esuelT),
        ndof=int(ndof),
        nelem_real=int(E),
        tables=g.tables,
    )
    return ShardedDG(
        geom=geom,
        owned=jnp.asarray(s_owned, dtype=dtype),
        gslot=jnp.asarray(s_gslot),
        grev=jnp.asarray(s_grev),
        eglobal=jnp.asarray(s_eglobal),
        ghalo=_build_ghost_halo(owned_l, ghosts_l, local_l, E, El, S),
        nshard=S,
        nslots=nslots,
        nelem_global=E,
    )

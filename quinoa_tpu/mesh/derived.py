"""Derived mesh connectivity generators (vectorized NumPy).

Counterpart of the reference's ``src/Mesh/DerivedData.hpp:50-161``
(genEsup/genPsup/genEdsup/genInpoed/genEsuel/genNbfacTet/genEsuf/...), but
re-designed as O(sort) vectorized array algorithms instead of per-entity
linked-list loops: all outputs are CSR pairs or dense tables ready to be
padded and shipped to the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Local nodes of the four faces of a tet, outward-oriented for a
# positive-Jacobian element; face f is opposite local node f.
_TET_FACES = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]],
    dtype=np.int32,
)

# The six edges of a tet by local node pairs.
_TET_EDGES = np.array(
    [[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]],
    dtype=np.int32,
)

CSR = Tuple[np.ndarray, np.ndarray]  # (items, row-offsets); offsets len nrow+1


def gen_esup(inpoel: np.ndarray, nnode: int) -> CSR:
    """Elements surrounding points as CSR (elem-ids, offsets).

    ``items[offsets[p]:offsets[p+1]]`` are the elements containing node p.
    """
    flat = inpoel.ravel()
    order = np.argsort(flat, kind="stable")
    items = (order // inpoel.shape[1]).astype(np.int32)
    counts = np.bincount(flat, minlength=nnode)
    offsets = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return items, offsets


def _unique_undirected_edges(inpoel: np.ndarray) -> np.ndarray:
    """All unique undirected edges as sorted (lo, hi) pairs, lexsorted."""
    from ..native import unique_edges
    nat = unique_edges(inpoel)
    if nat is not None:  # one u64-key sort in C++; same lex order
        return nat
    e = inpoel[:, _TET_EDGES].reshape(-1, 2)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def gen_inpoed(inpoel: np.ndarray) -> np.ndarray:
    """Edge connectivity: unique undirected edges, (nedge, 2) with lo < hi."""
    return _unique_undirected_edges(inpoel).astype(np.int32)


def gen_psup(inpoel: np.ndarray, nnode: int) -> CSR:
    """Points surrounding points as CSR (node-ids, offsets).

    For tetrahedra the point-neighbour graph equals the edge graph, so this
    is the symmetrized unique-edge list in CSR form.
    """
    e = _unique_undirected_edges(inpoel)
    both = np.concatenate([e, e[:, ::-1]], axis=0)
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    items = both[:, 1].astype(np.int32)
    counts = np.bincount(both[:, 0], minlength=nnode)
    offsets = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return items, offsets


def gen_edsup(inpoel: np.ndarray, nnode: int) -> CSR:
    """Edges surrounding points: CSR of edge ids incident to each node."""
    edges = gen_inpoed(inpoel)
    nedge = edges.shape[0]
    eid = np.arange(nedge, dtype=np.int32)
    node = np.concatenate([edges[:, 0], edges[:, 1]])
    eids = np.concatenate([eid, eid])
    order = np.argsort(node, kind="stable")
    items = eids[order]
    counts = np.bincount(node, minlength=nnode)
    offsets = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return items, offsets


def _face_keys(inpoel: np.ndarray) -> np.ndarray:
    """Sorted node triples of all 4*nelem tet faces, shape (4*nelem, 3)."""
    faces = inpoel[:, _TET_FACES]  # (E,4,3)
    return np.sort(faces.reshape(-1, 3), axis=1)


def gen_esuel(inpoel: np.ndarray, nnode: int) -> np.ndarray:
    """Element neighbours across faces: (nelem, 4) int32, -1 on boundary.

    Entry (e, f) is the element sharing face f of element e (the face
    opposite local node f), or -1 if that face is on the domain boundary.
    Uses the native C++ kernel when available (native/quinoa_native.cpp).
    """
    from ..native import gen_esuel as _native

    out = _native(inpoel)
    if out is not None:
        return out
    nelem = inpoel.shape[0]
    keys = _face_keys(inpoel)
    owner = np.repeat(np.arange(nelem, dtype=np.int64), 4)
    lface = np.tile(np.arange(4, dtype=np.int64), nelem)

    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    same = (k[:-1] == k[1:]).all(axis=1)

    esuel = np.full((nelem, 4), -1, dtype=np.int32)
    a = order[:-1][same]
    b = order[1:][same]
    esuel[owner[a], lface[a]] = owner[b]
    esuel[owner[b], lface[b]] = owner[a]
    return esuel


def gen_faces(inpoel: np.ndarray, nnode: int):
    """Face tables for cell-centered (DG) solvers.

    Returns a dict with:
      - ``esuf``   : (nface, 2) int32 — left/right element of each face;
                     right = -1 for boundary faces.  Left is always the
                     lower element id for interior faces so the table is
                     deterministic; for boundary faces left is the owner.
      - ``inpofa`` : (nface, 3) int32 — face nodes, outward-oriented w.r.t.
                     the *left* element.
      - ``lfacel`` : (nface,) int32 — local face id in the left element.
      - ``lfacer`` : (nface,) int32 — local face id in the right element
                     (-1 for boundary).
      - ``nbfac``  : number of boundary faces; boundary faces come *first*
                     (like the reference's genEsuf ordering contract,
                     src/Mesh/DerivedData.hpp).
    """
    nelem = inpoel.shape[0]
    keys = _face_keys(inpoel)
    owner = np.repeat(np.arange(nelem, dtype=np.int64), 4)
    lface = np.tile(np.arange(4, dtype=np.int64), nelem)

    if keys.size and int(keys.max()) < (1 << 21):
        # pack the sorted triple into one u64 (21 bits/node): a single
        # argsort instead of three lexsort passes, identical order
        pk = ((keys[:, 0].astype(np.uint64) << np.uint64(42))
              | (keys[:, 1].astype(np.uint64) << np.uint64(21))
              | keys[:, 2].astype(np.uint64))
        order = np.argsort(pk, kind="stable")
        eq = pk[order][:-1] == pk[order][1:]
    else:
        order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
        k = keys[order]
        eq = (k[:-1] == k[1:]).all(axis=1)
    same = np.zeros(len(order), dtype=bool)
    same[:-1] |= eq
    same[1:] |= eq

    # boundary faces: unmatched
    bnd_rows = order[~same]
    # interior faces: first of each matched pair (in lexsorted order)
    first = order[:-1][eq]
    second = order[1:][eq]

    # order interior pair as (lower elem id, higher elem id)
    el_a, el_b = owner[first], owner[second]
    lf_a, lf_b = lface[first], lface[second]
    swap = el_a > el_b
    el_l = np.where(swap, el_b, el_a)
    el_r = np.where(swap, el_a, el_b)
    lf_l = np.where(swap, lf_b, lf_a)
    lf_r = np.where(swap, lf_a, lf_b)

    nbfac = len(bnd_rows)
    nifac = len(first)
    nface = nbfac + nifac

    esuf = np.empty((nface, 2), dtype=np.int32)
    inpofa = np.empty((nface, 3), dtype=np.int32)
    lfacel = np.empty(nface, dtype=np.int32)
    lfacer = np.empty(nface, dtype=np.int32)

    # boundary first
    b_el = owner[bnd_rows]
    b_lf = lface[bnd_rows]
    esuf[:nbfac, 0] = b_el
    esuf[:nbfac, 1] = -1
    inpofa[:nbfac] = inpoel[b_el[:, None], _TET_FACES[b_lf]]
    lfacel[:nbfac] = b_lf
    lfacer[:nbfac] = -1

    esuf[nbfac:, 0] = el_l
    esuf[nbfac:, 1] = el_r
    inpofa[nbfac:] = inpoel[el_l[:, None], _TET_FACES[lf_l]]
    lfacel[nbfac:] = lf_l
    lfacer[nbfac:] = lf_r

    return {
        "esuf": esuf,
        "inpofa": inpofa,
        "lfacel": lfacel,
        "lfacer": lfacer,
        "nbfac": nbfac,
    }


def exterior_faces(inpoel: np.ndarray, nnode: int) -> np.ndarray:
    """Outward-oriented boundary triangles (ntri, 3): the faces with no
    neighbor element.  The reference's meshconv derives these when the
    input mesh carries no boundary (its multiblockexo2exo baseline
    shear.exo.std gains a 16000-triangle shell block this way)."""
    esuel = gen_esuel(inpoel, nnode)
    e, lf = np.nonzero(esuel < 0)
    return inpoel[e[:, None], _TET_FACES[lf]].astype(np.int32)


def leaky_partition(esuel: np.ndarray, inpoel: np.ndarray, coords: np.ndarray) -> bool:
    """Boundary surface-integral leak test.

    The closed-surface integral of the outward normals over all boundary
    faces of a partition must vanish (reference: tk::leakyPartition, used at
    src/Inciter/DG.cpp:148 and Refiner.cpp:373).  Returns True if leaky.
    """
    e_idx, f_idx = np.nonzero(esuel < 0)
    tris = inpoel[e_idx[:, None], _TET_FACES[f_idx]]
    a = coords[tris[:, 0]]
    b = coords[tris[:, 1]]
    c = coords[tris[:, 2]]
    n = np.cross(b - a, c - a)  # 2*area*outward normal
    s = np.abs(n.sum(axis=0))
    ref = np.abs(n).sum(axis=0) + 1e-300
    return bool((s / ref > 1e-9).any())

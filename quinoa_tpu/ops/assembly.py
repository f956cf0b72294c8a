"""Gather-based finite-element assembly (feature-major layout).

The two primitives under every CG operator:

- LAYOUT: all fields are component-major, entity-minor — U is (C, N),
  element slabs are (4, C, E) — so the long node/element axis is the
  contiguous one.  This is the array realization of the reference's
  compile-time data-layout switch (tk::Data<EqCompUnk>,
  src/Base/Data.hpp:32-37).

- ASSEMBLY IS A GATHER, NOT A SCATTER: instead of scatter-adding element
  contributions to nodes, the host precomputes a padded slots-surrounding-node table `nsup`
  (D, N) indexing into the flattened (a, e) contribution slots (the
  dense-CSR form of the reference's tk::genEsup, src/Mesh/
  DerivedData.hpp:50-161); each node then *gathers and sums* its <= D
  incident contributions — D fully vectorized gathers of (C, N).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def build_nsup(inpoel: np.ndarray, nnode: int):
    """Slots-surrounding-node table for any incidence table.

    inpoel is (E, A) — A slots per entity (4 for tets, 2 for edges).
    Returns (nsup (D, N) int32, D): nsup[d, p] indexes the flattened
    contribution slot a*E + e (local slot a of entity e) that scatters
    into node p, or A*E (a zero pad slot) when node p has fewer than D
    incident slots.
    """
    from ..native import build_nsup as _native

    nat = _native(np.asarray(inpoel), nnode)
    if nat is not None:
        return nat

    E, A = inpoel.shape
    flat = inpoel.T.ravel()  # slot id s = a*E + e holds node inpoel[e, a]
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nnode)
    D = int(counts.max()) if len(counts) else 0
    nsup = np.full((D, nnode), A * E, dtype=np.int32)
    pos = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(counts, out=pos[1:])
    # column-fill: for node p, its slots are order[pos[p]:pos[p+1]]
    idx_in_node = np.arange(len(flat)) - pos[flat[order]]
    nsup[idx_in_node, flat[order]] = order.astype(np.int32)
    return nsup, D


def gather_nodes(U: jnp.ndarray, inpoelT: jnp.ndarray) -> jnp.ndarray:
    """Gather nodal fields to element-node slabs.

    U (C, N), inpoelT (4, E) -> (4, C, E).
    """
    return jnp.stack([U[:, inpoelT[a]] for a in range(4)])


def assemble_add(contrib: jnp.ndarray, nsup: jnp.ndarray) -> jnp.ndarray:
    """Sum element-node contributions into nodes.

    contrib (4, C, E), nsup (D, N) -> (C, N).
    Padded elements must carry zero contributions.
    """
    A, C, E = contrib.shape
    flat = contrib.transpose(1, 0, 2).reshape(C, A * E)
    flat = jnp.concatenate([flat, jnp.zeros((C, 1), dtype=contrib.dtype)], axis=1)
    out = flat[:, nsup[0]]
    for d in range(1, nsup.shape[0]):
        out = out + flat[:, nsup[d]]
    return out


def _assemble_extreme(contrib, nsup, op, fill):
    A, C, E = contrib.shape
    flat = contrib.transpose(1, 0, 2).reshape(C, A * E)
    pad = jnp.full((C, 1), fill, dtype=contrib.dtype)
    flat = jnp.concatenate([flat, pad], axis=1)
    out = flat[:, nsup[0]]
    for d in range(1, nsup.shape[0]):
        out = op(out, flat[:, nsup[d]])
    return out


def assemble_max(contrib: jnp.ndarray, nsup: jnp.ndarray) -> jnp.ndarray:
    """Max of element-node contributions over each node's incident slots."""
    fill = jnp.finfo(contrib.dtype).min
    return _assemble_extreme(contrib, nsup, jnp.maximum, fill)


def assemble_add_max(contribA: jnp.ndarray, contribM: jnp.ndarray,
                     nsup: jnp.ndarray):
    """Fused sum- and max-assembly sharing the D nsup gathers.

    Stacking the add rows (Ca) and the max rows (Cm) into ONE gather per
    slot level reads each slot index once for both assemblies (the
    reference pays the same locality twice in FluxCorrector::aec and
    ::alw over esup).

    contribA (4, Ca, E), contribM (4, Cm, E) -> ((Ca, N), (Cm, N)).
    """
    A, Ca, E = contribA.shape
    Cm = contribM.shape[1]
    fill = jnp.finfo(contribM.dtype).min
    flat = jnp.concatenate([contribA, contribM], axis=1)
    flat = flat.transpose(1, 0, 2).reshape(Ca + Cm, A * E)
    pad = jnp.concatenate(
        [jnp.zeros((Ca, 1), contribA.dtype),
         jnp.full((Cm, 1), fill, contribM.dtype)], axis=0)
    flat = jnp.concatenate([flat, pad], axis=1)
    g = flat[:, nsup[0]]
    outA, outM = g[:Ca], g[Ca:]
    for d in range(1, nsup.shape[0]):
        g = flat[:, nsup[d]]
        outA = outA + g[:Ca]
        outM = jnp.maximum(outM, g[Ca:])
    return outA, outM


def assemble_min(contrib: jnp.ndarray, nsup: jnp.ndarray) -> jnp.ndarray:
    fill = jnp.finfo(contrib.dtype).max
    return _assemble_extreme(contrib, nsup, jnp.minimum, fill)

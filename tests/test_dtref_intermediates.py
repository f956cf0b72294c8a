"""Persistent AMR intermediates through dtref.

The reference keeps ONE long-lived AMR::mesh_adapter_t in its Refiner,
used for t0ref AND every during-timestep event: partial 1:2/1:4
templates are intermediate-locked between events
(mesh_adapter.cpp:538 lock_intermediates), incoming tags on locked
edges are dropped (mesh_adapter.cpp:134 mark_error_refinement), and
tagging a partial child's UNLOCKED edge re-refines the PARENT 2:8/4:8
(Refiner.cpp:241-260 dtref entry; two_to_eight/four_to_eight) — partial
templates never stack.  quinoa_tpu threads the same machine
(amr/multipass.py AMRState) through dtref via AdaptChain.state.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from quinoa_tpu.mesh import box_tet_mesh  # noqa: E402
from quinoa_tpu.mesh.derived import gen_inpoed, _TET_EDGES  # noqa: E402
from quinoa_tpu.amr.multipass import (  # noqa: E402
    AMRState, refine_pass, transfer_dg_pass,
)
from quinoa_tpu.amr.adapt import dtref_adapt, AdaptChain  # noqa: E402

from test_multipass import (  # noqa: E402
    _vol, _check_conforming, _check_nodes_unique, _check_groups,
)


def _elem_vols(mesh):
    x = np.asarray(mesh.coords)[np.asarray(mesh.inpoel)]
    a = x[:, 0]
    return np.einsum("ij,ij->i", np.cross(x[:, 1] - a, x[:, 2] - a),
                     x[:, 3] - a) / 6.0


def _total_mass(mesh, u, ncomp, ndof):
    v = _elem_vols(mesh)
    means = np.asarray(u).reshape(ncomp, ndof, -1)[:, 0, :]
    return (means * v).sum(axis=1)


def test_second_event_on_partial_child_rebuilds_parent():
    """Two consecutive refine_pass events: the second tags an unlocked
    edge of a 1:2 child — the PARENT must rebuild 2:8 (no stacked
    template), and the conservative DG transfer must preserve the total
    integral exactly through the rebuild."""
    mesh = box_tet_mesh(2, 2, 2)
    v0 = _vol(mesh)
    ncomp, ndof = 1, 4
    # smooth DG(P1) field: means = x-coordinate of the centroid
    cent = np.asarray(mesh.coords)[np.asarray(mesh.inpoel)].mean(axis=1)
    u = np.zeros((ncomp * ndof, mesh.nelem))
    u[0] = 1.0 + cent[:, 0]
    u[1] = 0.01  # a nonzero slope dof, zeroed on split children

    # event 1: tag exactly one edge -> 1:2 partial groups on every
    # incident element
    state = AMRState()
    e0 = gen_inpoed(mesh.inpoel).astype(np.int64)[3]
    m1, r1, state = refine_pass(mesh, e0[None, :], state)
    assert state.groups, "single-edge tag produced no partial group"
    assert all(g.kind == 2 for g in state.groups)
    u1 = transfer_dg_pass(r1, u, _elem_vols(mesh), ncomp, ndof)
    np.testing.assert_allclose(_total_mass(m1, u1, ncomp, ndof),
                               _total_mass(mesh, u, ncomp, ndof),
                               rtol=1e-13)

    # event 2: tag an UNLOCKED edge of one group's child (an edge not
    # touching the group's midpoint node)
    g = state.groups[0]
    child = np.asarray(m1.inpoel, np.int64)[g.children[0]]
    mids = set(g.mids.tolist())
    unlocked = [
        (child[a], child[b]) for a, b in _TET_EDGES
        if child[a] not in mids and child[b] not in mids
    ]
    assert unlocked, "1:2 child must have 3 unlocked edges"
    tag2 = np.asarray([unlocked[0]], np.int64)
    parent_key = tuple(sorted(g.parent.tolist()))
    m2, r2, state2 = refine_pass(m1, tag2, state)

    # the tagged group was REBUILT through its parent (Algorithm 3):
    assert r2.rebuilt, "no 2:8 rebuild recorded"
    reb_old = {tuple(rows.tolist()) for rows, _ in r2.rebuilt}
    assert tuple(g.children.tolist()) in reb_old
    # ... and its parent is gone from the live groups (no stacking)
    assert parent_key not in {tuple(sorted(h.parent.tolist()))
                              for h in state2.groups}
    # the rebuild produced the full 1:8 of the parent
    (rows_old, rows_new), = [rn for rn in r2.rebuilt
                             if tuple(rn[0].tolist())
                             == tuple(g.children.tolist())]
    assert len(rows_new) == 8

    # conservative transfer through the rebuild
    u2 = transfer_dg_pass(r2, u1, _elem_vols(m1), ncomp, ndof)
    np.testing.assert_allclose(_total_mass(m2, u2, ncomp, ndof),
                               _total_mass(mesh, u, ncomp, ndof),
                               rtol=1e-13)
    # untouched elements keep their slope dofs 1:1
    okp = np.asarray(r2.parent) >= 0
    cnt = np.bincount(np.maximum(r2.parent, 0)[okp],
                      minlength=m1.nelem)
    same = okp & (cnt[np.maximum(r2.parent, 0)] == 1)
    np.testing.assert_array_equal(
        u2.reshape(ncomp, ndof, -1)[:, 1, same],
        u1.reshape(ncomp, ndof, -1)[:, 1,
                                    np.asarray(r2.parent)[same]])

    _check_conforming(m2)
    _check_nodes_unique(m2)
    _check_groups(m2, state2)
    np.testing.assert_allclose(_vol(m2), v0, rtol=1e-12)


def test_locked_edge_tags_are_dropped():
    """Tags arriving on intermediate-locked edges (incident to a live
    group's midpoint) are dropped at intake — the partial child is NOT
    subdivided in place (mesh_adapter.cpp:134)."""
    mesh = box_tet_mesh(2, 2, 2)
    state = AMRState()
    e0 = gen_inpoed(mesh.inpoel).astype(np.int64)[3]
    m1, _, state = refine_pass(mesh, e0[None, :], state)
    g = state.groups[0]
    child = np.asarray(m1.inpoel, np.int64)[g.children[0]]
    mid = int(g.mids[0])
    locked = [(child[a], child[b]) for a, b in _TET_EDGES
              if mid in (int(child[a]), int(child[b]))]
    m2, r2, state2 = refine_pass(
        m1, np.asarray(locked[:1], np.int64), state)
    assert m2.nelem == m1.nelem and not len(r2.mid_edges)
    assert not r2.rebuilt
    assert len(state2.groups) == len(state.groups)


def test_dtref_adapt_threads_state_and_conserves():
    """dtref_adapt carries the AMRState across events: a first event
    creates partial groups; a second event whose error spikes at a
    partial child's unlocked corner rebuilds parents instead of
    stacking, conserving the DG means exactly."""
    mesh = box_tet_mesh(3, 3, 3)
    v0 = _vol(mesh)
    ncomp, ndof = 1, 1
    u = np.ones((1, mesh.nelem))
    u[0] = 2.0 + np.asarray(mesh.coords)[
        np.asarray(mesh.inpoel)].mean(axis=1)[:, 1]
    mass0 = _total_mass(mesh, u, ncomp, ndof)

    # event-1 error: spike at one node tags its incident edges
    uerr = np.full((1, mesh.nnode), 1e-6)
    uerr[0, 13] = 1.0
    chain = AdaptChain(mesh)
    ch, mesh1, chain, u1 = dtref_adapt(
        mesh, chain, uerr, u, False, ncomp, ndof,
        tol_refine=0.5, tol_derefine=0.0, maxlevels=4)
    assert ch and mesh1.nelem > mesh.nelem
    assert chain.state.groups, "event 1 left no partial templates"
    np.testing.assert_allclose(_total_mass(mesh1, u1, ncomp, ndof),
                               mass0, rtol=1e-13)

    # event-2 error: spike at a non-midpoint corner of a partial child
    g = chain.state.groups[0]
    child = np.asarray(mesh1.inpoel, np.int64)[g.children[0]]
    mids = set(g.mids.tolist())
    corner = next(int(n) for n in child if int(n) not in mids)
    uerr2 = np.full((1, mesh1.nnode), 1e-6)
    uerr2[0, corner] = 1.0
    parents_before = {tuple(sorted(h.parent.tolist()))
                      for h in chain.state.groups}
    ch2, mesh2, chain, u2 = dtref_adapt(
        mesh1, chain, uerr2, u1, False, ncomp, ndof,
        tol_refine=0.5, tol_derefine=0.0, maxlevels=4)
    assert ch2
    rmap2 = chain.levels[-1][1]
    assert rmap2.rebuilt, "partial-child tag did not rebuild its parent"
    # the rebuilt parents left the live set (no stacked templates)
    parents_after = {tuple(sorted(h.parent.tolist()))
                     for h in chain.state.groups}
    reb_parents = parents_before - parents_after
    assert reb_parents, "no group was retired by the rebuild"
    np.testing.assert_allclose(_total_mass(mesh2, u2, ncomp, ndof),
                               mass0, rtol=1e-13)
    _check_conforming(mesh2)
    _check_nodes_unique(mesh2)
    _check_groups(mesh2, chain.state)
    np.testing.assert_allclose(_vol(mesh2), v0, rtol=1e-12)
    # elevel stays consistent with the new mesh
    assert len(chain.elevel) == mesh2.nelem
    assert chain.elevel.max() <= 4


def test_dtref_adapt_cap_locks_inside_closure():
    """The level cap is enforced as pre-locked edges inside the mark
    fixed point (refinement.hpp:28): repeated spikes at the same node
    never push any element past maxlevels."""
    mesh = box_tet_mesh(2, 2, 2)
    ncomp, ndof = 1, 1
    u = np.ones((1, mesh.nelem))
    chain = AdaptChain(mesh)
    for _ in range(4):
        uerr = np.full((1, mesh.nnode), 1e-6)
        uerr[0, 0] = 1.0
        _, mesh, chain, u = dtref_adapt(
            mesh, chain, uerr, u, False, ncomp, ndof,
            tol_refine=0.5, tol_derefine=0.0, maxlevels=2)
        assert chain.elevel.max() <= 2
        assert len(u[0]) == mesh.nelem
    _check_conforming(mesh)

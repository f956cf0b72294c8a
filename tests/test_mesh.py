"""Mesh core tests: box generator, derived connectivity, geometry.

Modeled on the reference's tests/unit/Mesh/TestDerivedData.cpp coverage:
CSR structure sanity, symmetry of psup, esuel/face matching consistency,
volume and leak checks.
"""

import numpy as np
import pytest

from quinoa_tpu.mesh import (
    box_tet_mesh,
    gen_esup,
    gen_psup,
    gen_inpoed,
    gen_esuel,
    gen_faces,
    tet_geometry,
    nodal_volumes,
)
from quinoa_tpu.mesh.derived import leaky_partition


@pytest.fixture(scope="module")
def mesh():
    return box_tet_mesh(4, 4, 4)


def test_box_mesh_counts(mesh):
    assert mesh.nnode == 5**3
    assert mesh.nelem == 6 * 4**3
    assert mesh.positive_jacobians()


def test_total_volume(mesh):
    J, grad = tet_geometry(mesh.coords, mesh.inpoel)
    assert np.all(J > 0)
    assert np.isclose(J.sum() / 6.0, 1.0)
    vol = nodal_volumes(mesh.coords, mesh.inpoel, mesh.nnode)
    assert np.isclose(vol.sum(), 1.0)


def test_gradients_partition_of_unity(mesh):
    _, grad = tet_geometry(mesh.coords, mesh.inpoel)
    # shape function gradients sum to zero per element
    assert np.allclose(grad.sum(axis=1), 0.0, atol=1e-12)
    # gradient reproduces linear function exactly: sum_a grad_a * x_a = e_x
    xn = mesh.coords[mesh.inpoel]  # (E,4,3)
    G = np.einsum("ead,eac->edc", grad, xn)  # d/dx_d of coordinate c
    assert np.allclose(G, np.eye(3), atol=1e-9)


def test_esup(mesh):
    items, offs = gen_esup(mesh.inpoel, mesh.nnode)
    assert offs[-1] == 4 * mesh.nelem
    # every node appears in each of its elements
    for p in [0, 17, mesh.nnode - 1]:
        elems = items[offs[p] : offs[p + 1]]
        for e in elems:
            assert p in mesh.inpoel[e]


def test_psup_symmetric(mesh):
    items, offs = gen_psup(mesh.inpoel, mesh.nnode)
    neigh = [set(items[offs[p] : offs[p + 1]].tolist()) for p in range(mesh.nnode)]
    for p in range(mesh.nnode):
        assert p not in neigh[p]
        for q in neigh[p]:
            assert p in neigh[q]


def test_inpoed_euler(mesh):
    edges = gen_inpoed(mesh.inpoel)
    assert np.all(edges[:, 0] < edges[:, 1])
    # structured box: nedge known from construction (grid + face + main diags)
    n = 4
    grid_edges = 3 * n * (n + 1) ** 2
    face_diags = 3 * (n + 1) * n * n  # one diagonal per square face
    body_diags = n**3  # one main diagonal per hex
    assert edges.shape[0] == grid_edges + face_diags + body_diags


def test_esuel_consistency(mesh):
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)
    E = mesh.nelem
    for e in range(0, E, 37):
        for f in range(4):
            n = esuel[e, f]
            if n >= 0:
                assert e in esuel[n]
    # boundary face count of the box: 2 tri per square * 6 faces * n^2
    assert (esuel < 0).sum() == 12 * 4**2


def test_faces(mesh):
    fd = gen_faces(mesh.inpoel, mesh.nnode)
    esuf = fd["esuf"]
    assert fd["nbfac"] == 12 * 4**2
    ninter = esuf.shape[0] - fd["nbfac"]
    assert ninter == (4 * mesh.nelem - fd["nbfac"]) // 2
    # boundary faces first, with right == -1
    assert np.all(esuf[: fd["nbfac"], 1] == -1)
    assert np.all(esuf[fd["nbfac"] :, 1] >= 0)


def test_side_sets(mesh):
    assert set(mesh.bface.keys()) == {1, 2, 3, 4, 5, 6}
    for ss, tris in mesh.bface.items():
        assert tris.shape[0] == 2 * 4**2
    # side set nodes lie on the correct plane
    for ss, ax, val in [(1, 0, 0.0), (2, 0, 1.0), (5, 2, 0.0), (6, 2, 1.0)]:
        nodes = mesh.bnode[ss]
        assert np.allclose(mesh.coords[nodes, ax], val)


def test_not_leaky(mesh):
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)
    assert not leaky_partition(esuel, mesh.inpoel, mesh.coords)


def test_hilbert_element_reorder_invisible():
    """Hilbert element reorder permutes inpoel rows only: same cells,
    same nodes, and a DG run's diagnostics are unchanged."""
    import jax.numpy as jnp

    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.reorder import hilbert_element_reorder
    from quinoa_tpu.pde.dg import build_dggeom, BC_DIRICHLET
    from quinoa_tpu.pde.dg_compflow import DGCompFlow
    from quinoa_tpu.pde.problems import SedovBlastwave
    from quinoa_tpu.inciter.dg import DGSolver, DGDiagnostics

    mesh = box_tet_mesh(6, 6, 5, hi=(0.6, 0.6, 0.5))
    m2, eorder = hilbert_element_reorder(mesh)
    assert sorted(map(tuple, m2.inpoel.tolist())) \
        == sorted(map(tuple, mesh.inpoel.tolist()))
    assert np.array_equal(m2.coords, mesh.coords)

    # smooth problem: a shock (Sedov) would amplify the benign
    # FP-reassociation noise of the permuted reductions into the
    # limiter's branch decisions
    from quinoa_tpu.pde.problems import TaylorGreen

    bc = {i: BC_DIRICHLET for i in range(1, 7)}
    rows = []
    for m in (mesh, m2):
        geom = build_dggeom(m, ndof=4, bc_sidesets=bc)
        system = DGCompFlow(TaylorGreen())
        solver = DGSolver(system, geom, cfl=0.5)
        s = solver.nsteps(solver.initial_state(), 3)
        diag = DGDiagnostics(system, geom)
        rows.append(np.asarray(diag.compute(s)))
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-9, atol=1e-11)


def test_mesh_statistics_box():
    """Setup mesh-statistics block (Transporter::stat analog) on a box
    whose edge population is known: a unit cube at n=2 has axis edges
    of h=0.5, face diagonals h*sqrt(2), body diagonals h*sqrt(3)."""
    import numpy as np
    from quinoa_tpu.mesh import box_tet_mesh
    from quinoa_tpu.mesh.stats import (
        mesh_statistics, format_mesh_statistics, write_mesh_pdfs)

    mesh = box_tet_mesh(2, 2, 2, hi=(1.0, 1.0, 1.0))
    st = mesh_statistics(mesh)
    mn, mx, av = st["edgelength"]
    assert np.isclose(mn, 0.5)
    assert np.isclose(mx, 0.5 * np.sqrt(3.0))
    # every tet is vol = (0.5^3)/6
    vn, vx, _ = st["V^{1/3}"]
    assert np.isclose(vn, (0.5**3 / 6.0) ** (1.0 / 3.0))
    assert np.isclose(vx, vn)
    assert st["ntets"] == (mesh.nelem, mesh.nelem, mesh.nelem)
    txt = format_mesh_statistics(st)
    assert "min/max/avg(edgelength)" in txt
    assert "min/max/avg(ntets)" in txt

    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        write_mesh_pdfs(st, d)
        for f in ("mesh_edge_pdf.txt", "mesh_vol_pdf.txt",
                  "mesh_ntet_pdf.txt"):
            lines = open(os.path.join(d, f)).read().splitlines()
            assert lines[0].startswith("#")
            assert len(lines) > 1

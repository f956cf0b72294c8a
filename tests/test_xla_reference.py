"""The solvers' XLA formulations against plain NumPy references.

The DG face pass gathers each element's four face integrals through the
faces-of-element table (fose), the limiter's bounds gather face
neighbours through esuelT, and the CG assembly gathers each node's
element slots through nsup.  The references below compute the same sums
the straightforward way: a Python loop over faces that scatters each
face integral into its left and right elements, a loop over neighbours,
and np.add.at / np.maximum.at over the element-node incidence.  Physics
(fluxes, Riemann solvers, boundary states, characteristic speeds) is the
systems' own; only the integration and accumulation are re-derived.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.ops.basis import eval_basis_cm
from quinoa_tpu.pde.dg import (
    BC_DIRICHLET, BC_EXTRAPOLATE, BC_INTERIOR, BC_SYMMETRY, build_dggeom,
    dg_dt, dg_rhs,
)
from quinoa_tpu.pde.dg_compflow import DGCompFlow, DGTransport
from quinoa_tpu.pde.problems import (
    GaussHump, SedovBlastwave, TaylorGreen,
)


def _face_states(system, geom, Uv, t, face_gp):
    """Left/right states (C, G, F) at the face Gauss points, one face at
    a time; boundary faces take the system's ghost state."""
    el, er = np.asarray(geom.el), np.asarray(geom.er)
    B_l = np.asarray(eval_basis_cm(geom.ndof, geom.xi_l))     # (K,G,F)
    B_r = np.asarray(eval_basis_cm(geom.ndof, geom.xi_r))
    F = len(el)
    sL = np.stack([Uv[:, :, el[f]] @ B_l[:, :, f] for f in range(F)], -1)
    sR = np.stack([Uv[:, :, er[f]] @ B_r[:, :, f] for f in range(F)], -1)
    gpf = None
    if face_gp:
        node0, Jmat = np.asarray(geom.node0), np.asarray(geom.Jmat)
        xi_l = np.asarray(geom.xi_l)
        gpf = jnp.asarray(np.stack(
            [node0[:, el[f], None] + Jmat[:, :, el[f]] @ xi_l[:, :, f]
             for f in range(F)], -1))
    fn = jnp.asarray(np.asarray(geom.fn)[:, None, :])
    ghost = np.asarray(system.bc_state(geom.bctype, jnp.asarray(sL), fn,
                                       gpf, t))
    interior = np.asarray(geom.bctype) == BC_INTERIOR
    sR = np.where(interior, sR, ghost)
    return sL, sR, fn, gpf, B_l, B_r


def face_loop_rhs(system, geom, U, t, dofmask=None, face_gp=True):
    """dg_rhs the plain way: volume and source integrals summed over the
    volume Gauss points, then a loop over faces that scatters each
    face's flux integral into its elements (dg_rhs's signs: -B_l into
    the left element, +B_r into the right one of an interior face)."""
    C, K, E = system.ncomp, geom.ndof, geom.nelem
    tb = geom.tables
    Uv = np.asarray(U).reshape(C, K, E)
    if dofmask is not None:
        Uv = Uv * dofmask[None]
    vol = np.asarray(geom.vol)
    jacInv = np.asarray(geom.jacInv)              # [m, j, e] = dxi_m/dx_j
    node0, Jmat = np.asarray(geom.node0), np.asarray(geom.Jmat)
    R = np.zeros((C, K, E))
    for g, w in enumerate(tb["w_vol"]):
        s = np.einsum("k,cke->ce", tb["B_vol"][g], Uv)
        x = node0 + np.einsum("ime,m->ie", Jmat, tb["xi_vol"][g])
        if K > 1:
            Fj = system.flux_cols(jnp.asarray(s[:, None]),
                                  jnp.asarray(x[:, None]), t)
            for j in range(3):
                dBdx = np.einsum("km,me->ke", tb["dBdxi_vol"][g],
                                 jacInv[:, j])
                R += w * np.asarray(Fj[j])[:, 0, None, :] * dBdx * vol
        if getattr(system, "has_src", True):
            S = np.asarray(system.src(jnp.asarray(x[:, None]), t))[:, 0]
            R += w * S[:, None, :] * tb["B_vol"][g][None, :, None] * vol

    sL, sR, fn, gpf, B_l, B_r = _face_states(system, geom, Uv, t, face_gp)
    fl = np.asarray(system.riemann(fn, jnp.asarray(sL), jnp.asarray(sR),
                                   gpf, t))                 # (C,G,F)
    el, er = np.asarray(geom.el), np.asarray(geom.er)
    bct, area = np.asarray(geom.bctype), np.asarray(geom.farea)
    for f in range(len(el)):
        c = fl[:, :, f] * (tb["w_face"] * area[f])          # (C,G)
        R[:, :, el[f]] -= c @ B_l[:, :, f].T
        if bct[f] == BC_INTERIOR:
            R[:, :, er[f]] += c @ B_r[:, :, f].T
    if dofmask is not None:
        R = R * dofmask[None]
    return R.reshape(C * K, E)


def _flow_state(C, K, E, seed):
    """A positive-pressure compressible state with small slopes."""
    rng = np.random.default_rng(seed)
    U = np.zeros((C, K, E))
    U[0, 0] = 1.0 + 0.05 * rng.random(E)
    U[1:4, 0] = 0.1 * rng.standard_normal((3, E))
    U[4, 0] = 2.5 + 0.05 * rng.random(E)
    U[:, 1:] = 0.01 * rng.standard_normal((C, K - 1, E))
    return jnp.asarray(U.reshape(C * K, E))


_WALLS = {i: BC_SYMMETRY for i in range(1, 7)}
_DIRICHLET = {i: BC_DIRICHLET for i in range(1, 7)}

#: name -> (system factory, ndof, sidesets, face_gp, p-adaptive mask)
DG_CASES = {
    "transport_p0": (lambda: DGTransport(GaussHump()), 1, _DIRICHLET,
                     True, False),
    "transport_p1": (lambda: DGTransport(GaussHump()), 4, _DIRICHLET,
                     True, False),
    "compflow_hllc_p1": (
        lambda: DGCompFlow(SedovBlastwave(), riemann_flux="hllc"), 4,
        _WALLS, False, False),
    "compflow_laxfriedrichs_p1": (
        lambda: DGCompFlow(TaylorGreen(), riemann_flux="laxfriedrichs"), 4,
        _DIRICHLET, True, False),
    "compflow_hllc_p2": (
        lambda: DGCompFlow(SedovBlastwave(), riemann_flux="hllc"), 10,
        _WALLS, False, False),
    "compflow_hllc_p1_dofmask": (
        lambda: DGCompFlow(SedovBlastwave(), riemann_flux="hllc"), 4,
        _WALLS, False, True),
}


@pytest.mark.parametrize("name", sorted(DG_CASES))
def test_dg_rhs_matches_face_loop(name):
    make, K, bc, face_gp, pmask = DG_CASES[name]
    system = make()
    geom = build_dggeom(box_tet_mesh(3, 3, 3), ndof=K, bc_sidesets=bc)
    E = geom.nelem
    if system.ncomp == 5:
        U = _flow_state(5, K, E, seed=K)
    else:
        rng = np.random.default_rng(K)
        U = jnp.asarray(rng.standard_normal((system.ncomp * K, E)))
    dofmask = None
    if pmask:
        # every third element at P0, the rest P1
        nd = np.where(np.arange(E) % 3 == 0, 1, K)
        dofmask = (np.arange(K)[:, None] < nd[None]).astype(float)
    got = dg_rhs(system, geom, U, None if dofmask is None
                 else jnp.asarray(dofmask), 0.1, face_gp=face_gp)
    ref = face_loop_rhs(system, geom, U, 0.1, dofmask, face_gp)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("variant", ["p0", "p1", "p1_thinc"])
def test_multimat_rhs_matches_face_loop(variant):
    """The multimat rhs (the P0 finite-volume sweep, or the P1 path
    through the generic face pass) against the face loop over the
    facade's AUSM+up + riemannDeriv rows, followed by the system's
    non-conservative terms."""
    from quinoa_tpu.pde.dg import dg_initialize
    from quinoa_tpu.pde.multimat import (MultiMatSystem, _MMFacade,
                                         mm_consistent_limit)
    from quinoa_tpu.pde.problems.multimat import MMInterfaceAdvection

    K = 1 if variant == "p0" else 4
    thinc = variant == "p1_thinc"
    system = MultiMatSystem(MMInterfaceAdvection(), intsharp=thinc)
    geom = build_dggeom(box_tet_mesh(4, 3, 3),
                        ndof=K, bc_sidesets={i: BC_EXTRAPOLATE
                                             for i in range(1, 7)})
    C, nmat, E = system.ncomp, system.nmat, geom.nelem
    U = dg_initialize(system, geom, 0.0)
    if K > 1:
        # the raw P1 projection of the interface has negative fractions
        # at face points; the solver limits before every rhs
        U = mm_consistent_limit(system, geom, U)
    got = np.asarray(system.rhs(geom, U, 0.0))
    assert np.isfinite(got).all()

    facade = _MMFacade(system, thinc=thinc)
    Uv = U.reshape(C, K, E)
    parts = [Uv, jnp.zeros((3 * nmat + 1, K, E), U.dtype)]
    if thinc:
        parts.append(system.thinc_carriers(geom, Uv))
    Up = jnp.concatenate(parts, axis=0).reshape(facade.ncomp * K, E)
    acc = face_loop_rhs(facade, geom, Up, 0.0,
                        face_gp=False).reshape(facade.ncomp, K, E)
    dap = jnp.asarray(acc[C:C + 3 * nmat, 0])
    divu = jnp.asarray(acc[C + 3 * nmat, 0])
    if K == 1:
        nc = np.asarray(system._nonconservative(geom, U, dap, divu))
        ref = acc[:C, 0] + nc
    else:
        nc = np.asarray(system._nonconservative_ho(geom, Uv, dap, divu))
        ref = (acc[:C] + nc).reshape(C * K, E)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * scale)


@pytest.mark.parametrize("pmask", [False, True], ids=["p1", "p1_dofmask"])
def test_dg_dt_matches_charvel_sum(pmask):
    """dg_dt against min_e vol_e / (sum over the element's faces of the
    area-weighted largest characteristic speed), faces looped."""
    system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    geom = build_dggeom(box_tet_mesh(3, 3, 3), ndof=4, bc_sidesets=_WALLS)
    E = geom.nelem
    U = _flow_state(5, 4, E, seed=11)
    dofmask = None
    Uv = np.asarray(U).reshape(5, 4, E)
    if pmask:
        nd = np.where(np.arange(E) % 2 == 0, 1, 4)
        dofmask = (np.arange(4)[:, None] < nd[None]).astype(float)
        Uv = Uv * dofmask[None]
    sL, sR, fn, _, _, _ = _face_states(system, geom, Uv, 0.0, False)
    cl = np.asarray(system.charvel(jnp.asarray(sL), fn))    # (G,F)
    cr = np.asarray(system.charvel(jnp.asarray(sR), fn))
    w, area = geom.tables["w_face"], np.asarray(geom.farea)
    el, er, bct = (np.asarray(geom.el), np.asarray(geom.er),
                   np.asarray(geom.bctype))
    delt = np.zeros(E)
    for f in range(len(el)):
        interior = bct[f] == BC_INTERIOR
        sv = np.maximum(cl[:, f], cr[:, f]) if interior else cl[:, f]
        mx = (w * area[f] * sv).sum()
        delt[el[f]] += mx
        if interior:
            delt[er[f]] += mx
    ref = (np.asarray(geom.vol) / delt).min()
    got = float(dg_dt(system, geom, U, None if dofmask is None
                      else jnp.asarray(dofmask)))
    assert np.isclose(got, ref, rtol=1e-13, atol=0)


def test_neighbor_bounds_match_numpy():
    """The Superbee bounds (min/max over an element's own and its face
    neighbours' means) against a loop over each element's neighbours."""
    from quinoa_tpu.mesh.derived import gen_esuel
    from quinoa_tpu.pde.limiter import neighbor_bounds

    mesh = box_tet_mesh(4, 3, 3)
    geom = build_dggeom(mesh, ndof=4)
    rng = np.random.default_rng(5)
    u0 = rng.standard_normal((5, geom.nelem))
    umin, umax = neighbor_bounds(geom, jnp.asarray(u0))
    esuel = gen_esuel(mesh.inpoel, mesh.nnode)             # (E, 4)
    rmin, rmax = u0.copy(), u0.copy()
    for e in range(geom.nelem):
        for n in esuel[e]:
            if n >= 0:
                rmin[:, e] = np.minimum(rmin[:, e], u0[:, n])
                rmax[:, e] = np.maximum(rmax[:, e], u0[:, n])
    np.testing.assert_array_equal(np.asarray(umin), rmin)
    np.testing.assert_array_equal(np.asarray(umax), rmax)


@pytest.mark.parametrize("op", ["gather", "add", "max", "min", "add_max"])
def test_nsup_assembly_matches_scatter(op):
    """The nsup gather-assembly against np.add.at / np.maximum.at /
    np.minimum.at over the element-node incidence (and the element-node
    gather against direct indexing)."""
    from quinoa_tpu.ops.assembly import (
        assemble_add, assemble_add_max, assemble_max, assemble_min,
        build_nsup, gather_nodes,
    )

    mesh = box_tet_mesh(4, 3, 2)
    N, E = mesh.nnode, mesh.nelem
    nsup = jnp.asarray(build_nsup(mesh.inpoel, N)[0])
    rng = np.random.default_rng(3)
    contrib = rng.standard_normal((4, 3, E))

    def scatter(ufunc, init):
        out = np.full((3, N), init)
        for a in range(4):
            ufunc.at(out.T, mesh.inpoel[:, a], contrib[a].T)
        return out

    c = jnp.asarray(contrib)
    if op == "gather":
        U = rng.standard_normal((3, N))
        got = gather_nodes(jnp.asarray(U), jnp.asarray(mesh.inpoel.T))
        np.testing.assert_array_equal(
            np.asarray(got), np.stack([U[:, mesh.inpoel[:, a]]
                                       for a in range(4)]))
    elif op == "add":
        np.testing.assert_allclose(np.asarray(assemble_add(c, nsup)),
                                   scatter(np.add, 0.0), rtol=0, atol=1e-14)
    elif op == "max":
        np.testing.assert_array_equal(np.asarray(assemble_max(c, nsup)),
                                      scatter(np.maximum, -np.inf))
    elif op == "min":
        np.testing.assert_array_equal(np.asarray(assemble_min(c, nsup)),
                                      scatter(np.minimum, np.inf))
    else:
        P, Q = assemble_add_max(c, c[:, :2], nsup)
        np.testing.assert_allclose(np.asarray(P), scatter(np.add, 0.0),
                                   rtol=0, atol=1e-14)
        np.testing.assert_array_equal(np.asarray(Q),
                                      scatter(np.maximum, -np.inf)[:2])

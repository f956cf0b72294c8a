"""Discontinuous-Galerkin core: geometry tables and integral operators
(feature-major layout, gather-based accumulation).

Re-design of the reference's DG machinery (src/PDE/Integrate/
{Volume,Surface,Boundary,Mass,Source}.cpp and src/Inciter/DG.cpp) as
array programs:

- everything static is precomputed host-side per (re)partition: element
  Jacobians, face normals/areas, and the *reference coordinates* of every
  face Gauss point in the left/right element frames;
- LAYOUT: the modal solution is U (C*K, E) with row c*K+k; per-face slabs
  are (C*K, F); coordinates are (3, n).  The long element/face axis is
  always LAST, so small feature axes are never the contiguous one;
- ACCUMULATION IS A GATHER: face-flux contributions land in per-face
  arrays; each element then gathers its four faces through the
  faces-of-element table `fose` (with an L/R side selector);
- quadrature loops (<= 11 volume, <= 6 face points) are unrolled in
  Python: XLA fuses each into one elementwise kernel over (·, E)/(·, F).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.derived import gen_faces, gen_esuel, _TET_FACES
from ..ops.basis import eval_basis, eval_basis_cm, eval_dbdxi, mass_diag
from ..ops.quadrature import gauss_tet, gauss_tri, ng_vol, ng_face, ng_init

#: precision of every contraction on the solver path: an f32 dot may
#: otherwise run in TF32 (about three decimal digits) on the GPU
HI = jax.lax.Precision.HIGHEST

# BC type codes (per boundary face)
BC_INTERIOR = 0
BC_DIRICHLET = 1
BC_SYMMETRY = 2
BC_EXTRAPOLATE = 3
BC_INLET = 4
BC_OUTLET = 5

_REF_NODES = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)


class _Tables(dict):
    """Static (metadata) table dict: identity-hashed so it can live in the
    meta fields of a registered dataclass."""

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "vol", "jacInv", "Jmat", "node0", "emask",
        "el", "er", "fn", "farea", "xi_l", "xi_r", "bctype", "fmask",
        "fose", "fsideR", "esuelT",
    ],
    meta_fields=["ndof", "nelem_real", "tables"],
)
@dataclasses.dataclass(frozen=True)
class DGGeom:
    """Static DG geometry tables (single shard; padded in the SPMD build).

    vol     : (E,)        element volumes (1.0 padding)
    jacInv  : (3,3,E)     d(xi)/dx
    Jmat    : (3,3,E)     dx/d(xi)
    node0   : (3,E)       coordinates of local node 0
    emask   : (E,)        1.0 real / 0.0 padding
    el, er  : (F,) i32    left/right elements (er == el for boundary)
    fn      : (3,F)       unit face normal, outward from the left element
    farea   : (F,)        face area
    xi_l/r  : (3,G,F)     face Gauss points in left/right element ref coords
    bctype  : (F,) i32    BC code (interior 0)
    fmask   : (F,)        1.0 real face / 0.0 padding
    fose    : (4,E) i32   the element's four faces
    fsideR  : (4,E)       1.0 where the element is the RIGHT of that face
    esuelT  : (4,E) i32   face-neighbor elements (-1 = boundary), limiters
    tables  : constant numpy quadrature/basis tables (baked into jit)
    """

    vol: jnp.ndarray
    jacInv: jnp.ndarray
    Jmat: jnp.ndarray
    node0: jnp.ndarray
    emask: jnp.ndarray
    el: jnp.ndarray
    er: jnp.ndarray
    fn: jnp.ndarray
    farea: jnp.ndarray
    xi_l: jnp.ndarray
    xi_r: jnp.ndarray
    bctype: jnp.ndarray
    fmask: jnp.ndarray
    fose: jnp.ndarray
    fsideR: jnp.ndarray
    esuelT: jnp.ndarray
    ndof: int
    nelem_real: int
    tables: dict

    @property
    def nelem(self) -> int:
        return self.vol.shape[0]

    @property
    def nface(self) -> int:
        return self.farea.shape[0]


def _self_face_gauss(ng: int) -> np.ndarray:
    """Ref coords of the ng face Gauss points on the 4 ref-tet faces."""
    pts, _ = gauss_tri(ng)
    shp = np.stack([1.0 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]], axis=1)
    out = np.empty((4, ng, 3))
    for lf in range(4):
        out[lf] = shp @ _REF_NODES[_TET_FACES[lf]]
    return out


def _make_tables(ndof: int) -> _Tables:
    ngv = ng_vol(ndof)
    vp, vw = gauss_tet(ngv)
    ngf = ng_face(ndof)
    tp, tw = gauss_tri(ngf)
    ip, iw = gauss_tet(ng_init(ndof))
    B_self = np.stack(
        [
            np.asarray(eval_basis(ndof, jnp.asarray(_self_face_gauss(ngf)[lf])))
            for lf in range(4)
        ]
    )  # (4, G, K)
    return _Tables(
        w_vol=vw,
        xi_vol=vp,
        B_vol=np.asarray(eval_basis(ndof, jnp.asarray(vp))),
        dBdxi_vol=np.asarray(eval_dbdxi(ndof, jnp.asarray(vp))),
        w_face=tw,
        w_init=iw,
        xi_init=ip,
        B_init=np.asarray(eval_basis(ndof, jnp.asarray(ip))),
        B_selfface=B_self,
        mnorm=mass_diag(ndof),
    )


def build_dggeom(
    mesh,
    ndof: int,
    bc_sidesets: Optional[Dict[int, int]] = None,
    dtype=None,
) -> DGGeom:
    """Build single-shard DG geometry from a host UnsMesh.

    bc_sidesets maps side-set id -> BC code; unlisted boundary faces
    default to extrapolate.
    """
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    coords, inpoel = mesh.coords, mesh.inpoel
    E = mesh.nelem

    n0 = coords[inpoel[:, 0]]
    Jm = np.stack(
        [
            coords[inpoel[:, 1]] - n0,
            coords[inpoel[:, 2]] - n0,
            coords[inpoel[:, 3]] - n0,
        ],
        axis=2,
    )  # (E,3,3)
    detJ = np.linalg.det(Jm)
    if not (detJ > 0).all():
        raise ValueError("mesh has non-positive element Jacobians")
    vol = detJ / 6.0
    jacInv = np.linalg.inv(Jm)

    fd = gen_faces(inpoel, mesh.nnode)
    esuf = fd["esuf"]
    inpofa = fd["inpofa"]
    nbfac = fd["nbfac"]
    F = esuf.shape[0]

    a = coords[inpofa[:, 0]]
    b = coords[inpofa[:, 1]]
    c = coords[inpofa[:, 2]]
    nvec = np.cross(b - a, c - a)
    farea = 0.5 * np.linalg.norm(nvec, axis=1)
    fn = nvec / (2.0 * farea[:, None])

    ngf = ng_face(ndof)
    tp, _ = gauss_tri(ngf)
    shp = np.stack([1.0 - tp[:, 0] - tp[:, 1], tp[:, 0], tp[:, 1]], axis=1)
    el = esuf[:, 0].astype(np.int64)
    er = np.where(esuf[:, 1] < 0, el, esuf[:, 1]).astype(np.int64)
    from ..native import face_xi as _native_face_xi
    nat = _native_face_xi(coords, inpofa, shp, jacInv, n0, el, er)
    if nat is not None:  # fused C++ pass over gathered 3x3 matvecs
        xi_l, xi_r = nat
    else:
        gp = np.einsum("gi,fid->fgd", shp, coords[inpofa])  # (F,G,3)
        xi_l = np.einsum("fij,fgj->fgi", jacInv[el],
                         gp - n0[el][:, None, :])
        xi_r = np.einsum("fij,fgj->fgi", jacInv[er],
                         gp - n0[er][:, None, :])

    bctype = np.zeros(F, dtype=np.int32)
    bctype[:nbfac] = BC_EXTRAPOLATE
    if bc_sidesets:
        key2f = {tuple(sorted(inpofa[i])): i for i in range(nbfac)}
        for ss, code in bc_sidesets.items():
            for tri in mesh.bface.get(ss, ()):
                f = key2f.get(tuple(sorted(tri)))
                if f is not None:
                    bctype[f] = code

    # sort faces by their left element: face order is internal to the
    # geometry (fose is built below from the sorted order), and el-sorted
    # faces keep the left-state gathers local in memory
    forder = np.argsort(el, kind="stable")
    el, er = el[forder], er[forder]
    fn, farea = fn[forder], farea[forder]
    xi_l, xi_r = xi_l[forder], xi_r[forder]
    bctype = bctype[forder]

    # faces-of-element table with L/R side flags
    from ..native import build_fose as _native_fose
    natf = _native_fose(el, er, E)
    if natf is not None:
        fose, fsideR = natf
    else:
        fose = np.zeros((4, E), dtype=np.int32)
        fsideR = np.zeros((4, E))
        slot = np.zeros(E, dtype=np.int64)
        for f in range(F):
            e = el[f]
            fose[slot[e], e] = f
            slot[e] += 1
            if er[f] != el[f]:
                e2 = er[f]
                fose[slot[e2], e2] = f
                fsideR[slot[e2], e2] = 1.0
                slot[e2] += 1
        if not (slot == 4).all():
            raise AssertionError("every tet must own exactly 4 face slots")

    esuel = gen_esuel(inpoel, mesh.nnode)

    return DGGeom(
        vol=jnp.asarray(vol, dtype=dtype),
        jacInv=jnp.asarray(np.transpose(jacInv, (1, 2, 0)), dtype=dtype),
        Jmat=jnp.asarray(np.transpose(Jm, (1, 2, 0)), dtype=dtype),
        node0=jnp.asarray(n0.T, dtype=dtype),
        emask=jnp.ones(E, dtype=dtype),
        el=jnp.asarray(el, dtype=jnp.int32),
        er=jnp.asarray(er, dtype=jnp.int32),
        fn=jnp.asarray(fn.T, dtype=dtype),
        farea=jnp.asarray(farea, dtype=dtype),
        xi_l=jnp.asarray(np.transpose(xi_l, (2, 1, 0)), dtype=dtype),
        xi_r=jnp.asarray(np.transpose(xi_r, (2, 1, 0)), dtype=dtype),
        bctype=jnp.asarray(bctype),
        fmask=jnp.ones(F, dtype=dtype),
        fose=jnp.asarray(fose),
        fsideR=jnp.asarray(fsideR, dtype=dtype),
        esuelT=jnp.asarray(esuel.T),
        ndof=int(ndof),
        nelem_real=int(E),
        tables=_make_tables(ndof),
    )


# -- helpers -----------------------------------------------------------------


def uview(U, C, K):
    """(C*K, E) -> (C, K, E) view."""
    return U.reshape(C, K, U.shape[-1])


def eval_state_at(Uv, B):
    """Modal evaluation: Uv (C,K,n), B (K,n) or (K,) -> (C,n)."""
    K = Uv.shape[1]
    s = Uv[:, 0, :] * B[0]
    for k in range(1, K):
        s = s + Uv[:, k, :] * B[k]
    return s


def _phys_gp(node0, Jmat, xi):
    """Physical coords (3, n) of ref point(s) xi ((3,) or (3, n))."""
    return jnp.stack(
        [
            node0[i]
            + Jmat[i, 0] * xi[0] + Jmat[i, 1] * xi[1] + Jmat[i, 2] * xi[2]
            for i in range(3)
        ]
    )


# -- operators ---------------------------------------------------------------


def dg_rhs(system, geom: DGGeom, U, dofmask, t, face_gp=True):
    """DG right-hand side: volume + surface + boundary + source integrals.

    U (C*K, E); dofmask (K, E) or None when every dof is active (the
    non-p-adaptive case: skipping the mask saves two (K,1,F) gathers and
    several full-size multiplies per rhs).  Returns (C*K, E).

    All quadrature loops are single einsum contractions whose outputs keep
    the long element/face axis LAST; the whole rhs is ~20 dots + fused
    elementwise chains.  Every contraction is pinned to HIGHEST precision
    (an f32 dot may otherwise run in TF32 on the GPU).
    """
    C = system.ncomp
    K = geom.ndof
    E = geom.nelem
    tb = geom.tables
    dt_ = U.dtype

    Uv = uview(U, C, K)
    if dofmask is not None:
        Uv = Uv * dofmask[None]

    with jax.named_scope("dg_volume"):
        # ---- volume + source integrals ------------------------------------
        B_vol = jnp.asarray(tb["B_vol"], dtype=dt_)          # (G,K)
        xi_vol = jnp.asarray(tb["xi_vol"].T, dtype=dt_)      # (3,G)
        # weighted reference-gradient table: (G,K,3) * w -> wdB
        wdB = jnp.asarray(tb["w_vol"][:, None, None] * tb["dBdxi_vol"],
                          dtype=dt_)
        wB = jnp.asarray(tb["w_vol"][:, None] * tb["B_vol"],
                         dtype=dt_)                      # (G,K)

        state = jnp.einsum("gk,cke->cge", B_vol, Uv,
                           precision=HI)                 # (C,G,E)
        gp = (
            geom.node0[:, None, :]
            + jnp.einsum("ime,mg->ige", geom.Jmat, xi_vol, precision=HI)
        )                                                    # (3,G,E)

        Rv = jnp.zeros((C, K, E), dtype=dt_)
        if K > 1:
            Fj = system.flux_cols(state, gp, t)              # [3] of (C,G,E)
            Fref = jnp.stack(
                [
                    sum(Fj[j] * geom.jacInv[m, j] for j in range(3))
                    for m in range(3)
                ]
            )                                                # (3,C,G,E)
            Rv = Rv + jnp.einsum("gkm,mcge->cke", wdB, Fref, precision=HI)
        if getattr(system, "has_src", True):
            sarr = system.src(gp, t)                         # (C,G,E)
            Rv = Rv + jnp.einsum("gk,cge->cke", wB, sarr, precision=HI)

        Rv = Rv * (geom.vol * geom.emask)

    with jax.named_scope("dg_face"):
        # ---- face pass (interior + boundary in one sweep) -----------------
        interior = geom.bctype == BC_INTERIOR
        B_l = eval_basis_cm(K, geom.xi_l)                    # (K,G,F)
        B_r = eval_basis_cm(K, geom.xi_r)
        if dofmask is not None:
            B_l = B_l * dofmask[:, None, geom.el]
            B_r = B_r * dofmask[:, None, geom.er]
        sL = jnp.einsum("kgf,ckf->cgf", B_l, Uv[:, :, geom.el],
                        precision=HI)
        sR = jnp.einsum("kgf,ckf->cgf", B_r, Uv[:, :, geom.er],
                        precision=HI)
        if face_gp:
            gpf = (
                geom.node0[:, None, geom.el]
                + jnp.einsum("imf,mgf->igf", geom.Jmat[:, :, geom.el],
                             geom.xi_l, precision=HI)
            )                                                # (3,G,F)
        else:
            # the system's flux/bcs are coordinate-free on faces (compflow
            # without Dirichlet/inlet): skip the node0/Jmat face gathers
            gpf = None
        fnf = geom.fn[:, None, :]                            # (3,1,F)
        sR = jnp.where(
            interior,
            sR,
            system.bc_state(geom.bctype, sL, fnf, gpf, t),
        )
        fl = system.riemann(fnf, sL, sR, gpf, t)             # (C,G,F)

        wt = jnp.asarray(tb["w_face"], dtype=dt_)[:, None] * (
            geom.farea * geom.fmask
        )                                                    # (G,F)
        contribL = -jnp.einsum("kgf,gf,cgf->ckf", B_l, wt, fl,
                               precision=HI)
        contribR = jnp.einsum("kgf,gf,cgf->ckf", B_r, wt, fl,
                              precision=HI)

        # gather each element's four faces through the fose table
        for i in range(4):
            f = geom.fose[i]
            side = geom.fsideR[i]
            Rv = Rv + jnp.where(side > 0, contribR[:, :, f],
                                contribL[:, :, f])

    if dofmask is not None:
        Rv = Rv * dofmask[None]
    return Rv.reshape(C * K, E)


def dg_dt(system, geom: DGGeom, U, dofmask):
    """Max-characteristic-speed face sweep: min_e vol_e / sum_f dSV
    (DGCompFlow.hpp dt:197-406)."""
    C, K = system.ncomp, geom.ndof
    tb = geom.tables
    dt_ = U.dtype
    Uv = uview(U, C, K)
    if dofmask is not None:
        Uv = Uv * dofmask[None]
    interior = geom.bctype == BC_INTERIOR

    B_l = eval_basis_cm(K, geom.xi_l)
    B_r = eval_basis_cm(K, geom.xi_r)
    if dofmask is not None:
        B_l = B_l * dofmask[:, None, geom.el]
        B_r = B_r * dofmask[:, None, geom.er]
    sL = jnp.einsum("kgf,ckf->cgf", B_l, Uv[:, :, geom.el], precision=HI)
    sR = jnp.einsum("kgf,ckf->cgf", B_r, Uv[:, :, geom.er], precision=HI)
    if getattr(system, "needs_face_gp", True):
        gpf = (
            geom.node0[:, None, geom.el]
            + jnp.einsum("imf,mgf->igf", geom.Jmat[:, :, geom.el],
                         geom.xi_l, precision=HI)
        )
    else:
        gpf = None
    fnf = geom.fn[:, None, :]
    dSV_l = system.charvel(sL, fnf, gpf)                 # (G,F)
    dSV_r = system.charvel(sR, fnf, gpf)
    wt = jnp.asarray(tb["w_face"], dtype=dt_)[:, None] * (
        geom.farea * geom.fmask
    )
    mx = (wt * jnp.where(interior, jnp.maximum(dSV_l, dSV_r), dSV_l)).sum(0)

    delt = sum(mx[geom.fose[i]] for i in range(4))
    big = jnp.asarray(jnp.finfo(dt_).max, dtype=dt_)
    elemdt = geom.vol / jnp.maximum(delt, 1e-300)
    return jnp.where(geom.emask > 0, elemdt, big).min()


def dg_initialize(system, geom: DGGeom, t):
    """L2 projection of the IC onto the modal basis (tk::initialize /
    eval_init, src/PDE/Integrate/Initialize.cpp).  Returns (C*K, E)."""
    C, K, E = system.ncomp, geom.ndof, geom.nelem
    tb = geom.tables
    dtype = geom.vol.dtype
    xi = jnp.asarray(tb["xi_init"].T, dtype=dtype)       # (3,G)
    gp = geom.node0[:, None, :] + jnp.einsum("ime,mg->ige", geom.Jmat, xi,
                                             precision=HI)
    f = system.initialize(gp, t)                          # (C,G,E)
    wB = jnp.asarray(tb["w_init"][:, None] * tb["B_init"], dtype=dtype)
    proj = jnp.einsum("gk,cge->cke", wB, f, precision=HI)
    mn = jnp.asarray(tb["mnorm"], dtype=dtype)
    return (proj / mn[None, :, None]).reshape(C * K, E)


def eval_ndof_sticky(geom, u, ndofel, ncomp, tolref):
    """p-adaptive indicator shared by the single-shard and SPMD solvers:
    keep P1 where any component's reference-space gradient magnitude
    exceeds tolref (DG.cpp eval_ndof:1089-1163).  Sticky: only elements
    currently at ndof==4 are re-evaluated (DG.cpp:1108) — a dropped
    element's frozen (zeroed) dofs can never flip it back; re-activation
    happens only through propagate_ndof's ring promotion."""
    K = geom.ndof
    Uv = uview(u, ncomp, K)
    u1, u2, u3 = Uv[:, 1, :], Uv[:, 2, :], Uv[:, 3, :]
    dxi = (2.0 * u1, u1 + 3.0 * u2, u1 + u2 + 4.0 * u3)
    grad2 = None
    for j in range(3):
        d = (
            dxi[0] * geom.jacInv[0, j]
            + dxi[1] * geom.jacInv[1, j]
            + dxi[2] * geom.jacInv[2, j]
        )
        grad2 = d * d if grad2 is None else grad2 + d * d
    keep = (jnp.sqrt(grad2) > tolref).any(axis=0)
    fresh = jnp.where(keep, 4, 1).astype(jnp.int32)
    return jnp.where(ndofel == 4, fresh, ndofel)


def propagate_ndof(geom, ndofel):
    """p-refine every face-neighbor of a p-refined element, one ring per
    step (DG.cpp propagate_ndof:1286-1313): this is what lets a
    dropped-to-P0 element re-activate as the feature front reaches it.
    Non-transitive (the reference reads m_ndof and writes a copy);
    implemented as a 4-row esuelT gather."""
    nbr = ndofel[jnp.maximum(geom.esuelT, 0)]  # (4,E) gather
    prom = ((nbr == 4) & (geom.esuelT >= 0)).any(axis=0)
    return jnp.where(prom, 4, ndofel)


def dg_cell_avg(U, C, K):
    """Cell averages (C, E): the 0th Dubiner dof is the mean."""
    return uview(U, C, K)[:, 0, :]

"""Every contraction on the solver and walker paths is pinned to full
precision.

On the GPU an f32 dot_general without an explicit precision may run in
TF32 (about three decimal digits), which would make the accelerator's
results silently disagree with the CPU's.  These tests trace one step of
each solver the CLI routes to (and of the walker's SDE systems) and check
that every dot_general in the jaxpr, nested programs included, carries
Precision.HIGHEST on both operands.
"""

import numpy as np
import pytest

import jax
import jax.extend
import jax.numpy as jnp
from jax.lax import Precision

from quinoa_tpu.control.config import build_inciter, load_inciter
from quinoa_tpu.mesh import box_tet_mesh

import chip_smoke


def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def dot_precisions(jaxpr):
    """The precision parameter of every dot_general in a jaxpr, nested
    programs (jit, shard_map, scan, cond, custom rules) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in _sub_jaxprs(eqn.params):
            out += dot_precisions(sub)
    return out


def _assert_highest(closed, expect_dots=True):
    precs = dot_precisions(closed.jaxpr)
    assert bool(precs) == expect_dots, precs
    bad = [p for p in precs
           if p is None or any(q != Precision.HIGHEST for q in
                               (p if isinstance(p, tuple) else (p,)))]
    assert not bad, f"{len(bad)} of {len(precs)} dot_generals: {bad[:3]}"


def test_dot_precisions_sees_nested_default_precision():
    """The checker itself: a default-precision dot inside a jitted
    function is found."""
    f = jax.jit(lambda a, b: jnp.einsum("ij,jk->ik", a, b))
    closed = jax.make_jaxpr(lambda a, b: f(a, b) + 1.0)(
        jnp.ones((2, 3)), jnp.ones((3, 2)))
    assert dot_precisions(closed.jaxpr) == [None]


def _deck_cases():
    cases = {"flagship": (chip_smoke.flagship_deck(), (3,) + (
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))}
    for name, (deck, box, _, _) in chip_smoke.parity_cases(3).items():
        if box is not None:
            cases[name] = (deck, box)
    return cases


@pytest.mark.parametrize("name", sorted(_deck_cases()))
def test_solver_step_pins_highest(name):
    deck, (n, lo, hi) = _deck_cases()[name]
    cfg = load_inciter(deck)
    solver, _ = build_inciter(cfg, box_tet_mesh(n, n, n, lo=lo, hi=hi))
    state = solver.initial_state()
    # the node-centred CG schemes contract nothing: their steps are
    # gathers, elementwise chains and assemblies
    cg = name.startswith(("alecg", "diagcg"))
    _assert_highest(jax.make_jaxpr(solver.step)(state), expect_dots=not cg)


def test_spmd_dg_step_pins_highest():
    from quinoa_tpu.control.config import build_inciter_spmd

    cfg = load_inciter(chip_smoke.flagship_deck())
    solver = build_inciter_spmd(cfg, box_tet_mesh(3, 3, 3), 1)
    _assert_highest(jax.make_jaxpr(solver.step)(solver.initial_state()))


def _walker_systems():
    from quinoa_tpu.diffeq import (
        Dissipation, GeneralizedDirichlet, OrnsteinUhlenbeck, Position,
        Velocity, WrightFisher,
    )

    pos, vel, dis = (Position(depvar="x"), Velocity(depvar="u", c0=2.1),
                     Dissipation(depvar="o", c3=1.0, c4=0.25))
    return {
        "ou": [OrnsteinUhlenbeck(depvar="y", sigmasq=((0.25, 0.1),
                                                      (0.1, 0.25)),
                                 theta=(1.0, 1.0), mu=(0.0, 0.0))],
        "gendir": [GeneralizedDirichlet(
            depvar="y", b=(0.1, 1.5), S=(0.3, 0.45), kappa=(0.1, 0.3),
            cij=(0.1,))],
        "wright_fisher": [WrightFisher(depvar="y", omega=(0.25, 0.5, 0.25))],
        "langevin": [pos, vel, dis],
    }


@pytest.mark.parametrize("name", sorted(_walker_systems()))
def test_walker_step_pins_highest(name):
    from quinoa_tpu.walker import Walker

    systems = Walker.layout(_walker_systems()[name])
    if name == "langevin":
        pos, vel, dis = systems
        pos.velocity_offset = vel.offset
        vel.dissipation_offset = dis.offset
        dis.velocity_offset = vel.offset
    w = Walker(systems, npar=8, dt=0.01, seed=1)
    P = jnp.asarray(np.full((8, w.nprop), 0.3))
    _assert_highest(jax.make_jaxpr(w._step_impl)(
        P, jax.random.key(0), 0.0))

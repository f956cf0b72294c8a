"""Compressible-flow (Euler) problem policies — component-major layout.

Vectorized jnp re-implementations of the reference problem policies
(src/PDE/CompFlow/Problem/{VorticalFlow,TaylorGreen,SodShocktube,
RotatedSodShocktube,SedovBlastwave,NLEnergyGrowth,RayleighTaylor,
UserDefined}.cpp).

LAYOUT CONTRACT (feature-major): coordinates arrive as ``xyz`` of
shape (3, n) and solutions return (5, n) — components lead, the long
point axis is last, so it is the contiguous one in every materialized
array.  Conservative components:
(rho, rho*u, rho*v, rho*w, rhoE).

Manufactured sources are *derived by automatic differentiation* instead of
transcribing the reference's hand-derived formulas: for a manufactured
solution U(x,t) of the Euler system the source is exactly

    S(x,t) = dU/dt + div F(U),   F = inviscid flux,

evaluated with batched jax.jvp along t and the three coordinate directions
— mathematically identical to the reference's closed forms (e.g.
VorticalFlow.cpp:80-140, RayleighTaylor.cpp:99-190) by construction.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..eos import StiffenedGas


def euler_flux_dir(U: jnp.ndarray, p: jnp.ndarray, j: int) -> jnp.ndarray:
    """Column j of the inviscid flux for component-major states U (5, n)."""
    rho = U[0]
    vj = U[1 + j] / rho
    return jnp.stack(
        [
            U[1 + j],
            U[1] * vj + (p if j == 0 else 0.0),
            U[2] * vj + (p if j == 1 else 0.0),
            U[3] * vj + (p if j == 2 else 0.0),
            (U[4] + p) * vj,
        ]
    )


class CompFlowProblem:
    """Base for Euler problems: analytic solution + autodiff source."""

    ncomp: int = 5
    eos: StiffenedGas = StiffenedGas(gamma=1.4)
    #: True if the analytic solution satisfies Euler only with a
    #: manufactured source.
    manufactured: bool = False

    # subclasses implement: solution(xyz (3,n), t) -> (5, n)

    def analytic(self, xyz, t):
        return self.solution(xyz, t)

    def solinc(self, xyz, t, dt):
        return self.solution(xyz, t + dt) - self.solution(xyz, t)

    def src(self, xyz, t):
        """Manufactured source S = dU/dt + div F(U), or zeros: (5, n)."""
        if not self.manufactured:
            return jnp.zeros((5,) + xyz.shape[1:], dtype=xyz.dtype)
        t = jnp.asarray(t, dtype=xyz.dtype)

        _, dUdt = jax.jvp(lambda tt: self.solution(xyz, tt), (t,), (jnp.ones_like(t),))

        def flux_j(p, j):
            U = self.solution(p, t)
            pr = self.eos.pressure_cons_cm(U)
            return euler_flux_dir(U, pr, j)

        divF = jnp.zeros_like(dUdt)
        for j in range(3):
            # axis-j one-hot tangent
            row = jax.lax.broadcasted_iota(jnp.int32, xyz.shape, 0)
            tangent = jnp.where(row == j, 1.0, 0.0).astype(xyz.dtype)
            _, dFj = jax.jvp(lambda p, jj=j: flux_j(p, jj), (xyz,), (tangent,))
            divF = divF + dFj
        return dUdt + divF


@dataclasses.dataclass(frozen=True)
class VorticalFlow(CompFlowProblem):
    """Steady vortical flow manufactured solution (VorticalFlow.cpp:28-64);
    regression decks use gamma=5/3, alpha=0.1, beta=1.0, p0=10."""

    alpha: float = 0.1
    beta: float = 1.0
    p0: float = 10.0
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        a, b, g = self.alpha, self.beta, self.eos.gamma
        x, y, z = xyz[0], xyz[1], xyz[2]
        ru = a * x - b * y
        rv = b * x + a * y
        rw = -2.0 * a * z
        rE = (ru * ru + rv * rv + rw * rw) / 2.0 + (
            self.p0 - 2.0 * a * a * z * z
        ) / (g - 1.0)
        return jnp.stack([jnp.ones_like(x), ru, rv, rw, rE])


@dataclasses.dataclass(frozen=True)
class TaylorGreen(CompFlowProblem):
    """Steady 2-D Taylor-Green vortex (TaylorGreen.cpp:28-90); the closed
    form of its energy source assumes gamma=5/3, which all reference decks
    set."""

    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        r = jnp.ones_like(x)
        pr = 10.0 + (jnp.cos(2 * jnp.pi * x) + jnp.cos(2 * jnp.pi * y)) / 4.0
        u = jnp.sin(jnp.pi * x) * jnp.cos(jnp.pi * y)
        v = -jnp.cos(jnp.pi * x) * jnp.sin(jnp.pi * y)
        w = jnp.zeros_like(x)
        rE = self.eos.totalenergy(r, u, v, w, pr)
        return jnp.stack([r, r * u, r * v, r * w, rE])

    def solinc(self, xyz, t, dt):
        return jnp.zeros((5,) + xyz.shape[1:], dtype=xyz.dtype)


@dataclasses.dataclass(frozen=True)
class SodShocktube(CompFlowProblem):
    """Sod shock tube ICs (SodShocktube.cpp:28-100); like the reference,
    `solution` returns the t=0 state (no exact Riemann evolution)."""

    eos: StiffenedGas = StiffenedGas(gamma=1.4)

    def solution(self, xyz, t):
        x = xyz[0]
        left = x < 0.5
        r = jnp.where(left, 1.0, 0.125).astype(x.dtype)
        pr = jnp.where(left, 1.0, 0.1).astype(x.dtype)
        u = jnp.zeros_like(x)
        rE = self.eos.totalenergy(r, u, u, u, pr)
        z = jnp.zeros_like(x)
        return jnp.stack([r, z, z, z, rE])


@dataclasses.dataclass(frozen=True)
class RotatedSodShocktube(SodShocktube):
    """Sod tube rotated by (-45,-45,-45) degrees about X, Y, Z
    (RotatedSodShocktube.cpp): evaluate the unrotated problem in the
    rotated frame."""

    def solution(self, xyz, t):
        c, s = np.cos(-np.pi / 4), np.sin(-np.pi / 4)
        Rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        R = jnp.asarray(Rx @ Ry @ Rz, dtype=xyz.dtype)
        q = jnp.tensordot(R, xyz, axes=1,
                          precision=jax.lax.Precision.HIGHEST)
        return SodShocktube.solution(self, q, t)


@dataclasses.dataclass(frozen=True)
class SedovBlastwave(CompFlowProblem):
    """Sedov blast wave ICs: high-pressure corner region
    (SedovBlastwave.cpp:28-100)."""

    #: source-region and ambient pressures are hard-coded in the reference
    #: (SedovBlastwave.cpp:55) and deliberately NOT deck-controlled: decks
    #: carry stray alpha/beta/p0 lines the reference ignores.
    p_hot: float = 783.4112
    p_ambient: float = 1.0e-6
    rcorner: float = 0.05
    eos: StiffenedGas = StiffenedGas(gamma=1.4)

    def solution(self, xyz, t):
        x, y = xyz[0], xyz[1]
        hot = (x < self.rcorner) & (y < self.rcorner)
        r = jnp.ones_like(x)
        pr = jnp.where(hot, self.p_hot, self.p_ambient).astype(x.dtype)
        u = jnp.zeros_like(x)
        rE = self.eos.totalenergy(r, u, u, u, pr)
        z = jnp.zeros_like(x)
        return jnp.stack([r, z, z, z, rE])


@dataclasses.dataclass(frozen=True)
class NLEnergyGrowth(CompFlowProblem):
    """Nonlinear energy growth manufactured solution
    (NLEnergyGrowth.cpp:25-190)."""

    alpha: float = 0.25
    betax: float = 1.0
    betay: float = 0.75
    betaz: float = 0.5
    r0: float = 2.0
    ce: float = -1.0
    kappa: float = 0.8
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        x, y, z = xyz[0], xyz[1], xyz[2]
        gx = 1.0 - x * x - y * y - z * z
        h = (
            jnp.cos(self.betax * jnp.pi * x)
            * jnp.cos(self.betay * jnp.pi * y)
            * jnp.cos(self.betaz * jnp.pi * z)
        )
        ft = jnp.exp(-self.alpha * t)
        r = self.r0 + ft * gx
        ec = (-3.0 * (self.ce + self.kappa * h * h * t)) ** (-1.0 / 3.0)
        zero = jnp.zeros_like(x)
        return jnp.stack([r, zero, zero, zero, r * ec])


@dataclasses.dataclass(frozen=True)
class RayleighTaylor(CompFlowProblem):
    """Time-dependent Rayleigh-Taylor manufactured solution
    (RayleighTaylor.cpp:28-200)."""

    alpha: float = 1.0
    betax: float = 1.0
    betay: float = 1.0
    betaz: float = 1.0
    p0: float = 1.0
    r0: float = 1.0
    kappa: float = 1.0
    eos: StiffenedGas = StiffenedGas(gamma=5.0 / 3.0)
    manufactured: bool = True

    def solution(self, xyz, t):
        x, y, z = xyz[0], xyz[1], xyz[2]
        gx = self.betax * x * x + self.betay * y * y + self.betaz * z * z
        r = self.r0 - gx
        pr = self.p0 + self.alpha * gx
        ft = jnp.cos(self.kappa * jnp.pi * t)
        u = ft * z * jnp.sin(jnp.pi * x)
        v = ft * z * jnp.cos(jnp.pi * y)
        w = ft * (
            -0.5 * jnp.pi * z * z * (jnp.cos(jnp.pi * x) - jnp.sin(jnp.pi * y))
        )
        rE = self.eos.totalenergy(r, u, v, w, pr)
        return jnp.stack([r, r * u, r * v, r * w, rE])


@dataclasses.dataclass(frozen=True)
class UserDefined(CompFlowProblem):
    """Quiescent user-defined ICs (UserDefined.cpp)."""

    eos: StiffenedGas = StiffenedGas(gamma=1.4)

    def solution(self, xyz, t):
        one = jnp.ones_like(xyz[0])
        zero = jnp.zeros_like(xyz[0])
        return jnp.stack([one, zero, zero, zero, one])

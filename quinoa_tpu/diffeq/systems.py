"""The SDE/ODE systems, ensemble-vectorized.

Each system operates on its slice of the particle array via `offset` and
`nprop` (number of per-particle slots it owns, which can exceed `ncomp`
when derived quantities like instantaneous density are stored, mirroring
the reference's fraction-beta systems).  `advance(key, P, dt, t, moments)`
takes and returns the FULL particle array (npar, nprop_total).

Coupled systems (Position<-Velocity<-Dissipation, the Langevin family of
Velocity/Langevin.cpp) reference other systems' offsets, like the
reference's CoupledEq machinery (src/DiffEq/CoupledEq.hpp).

Moment-coupled coefficient policies (the mix-beta DECAY policy of
MixNumberFractionBetaCoeffPolicy.cpp:71-96, Dissipation's mean-frequency
source) read the `moments` dict produced by quinoa_tpu.statistics each
step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: precision of every contraction: an f32 dot may otherwise run in TF32
#: (about three decimal digits) on the GPU
HI = jax.lax.Precision.HIGHEST


def _arr(x, dtype=None):
    return jnp.asarray(x, dtype=dtype or jnp.zeros(0).dtype)


def _gauss(key, npar, ncomp, dtype):
    return jax.random.normal(key, (npar, ncomp), dtype=dtype)


def _sqrt_pos(d):
    return jnp.sqrt(jnp.maximum(d, 0.0))


@dataclasses.dataclass
class SDEBase:
    """Common bookkeeping: depvar (for moment lookups), offset, init."""

    depvar: str = "x"
    offset: int = 0
    init = None  # callable (key, npar) -> (npar, ncomp), set by driver/user

    @property
    def nprop(self) -> int:
        return self.ncomp

    def slice(self, P):
        return P[:, self.offset : self.offset + self.ncomp]

    def put(self, P, Y):
        return P.at[:, self.offset : self.offset + self.ncomp].set(Y)


@dataclasses.dataclass
class DiagOrnsteinUhlenbeck(SDEBase):
    """dY_i = theta_i(mu_i - Y_i)dt + sigma_i dW_i
    (DiagOrnsteinUhlenbeck.hpp:144-165)."""

    sigmasq: Sequence[float] = (0.25,)
    theta: Sequence[float] = (1.0,)
    mu: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.theta)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        th, mu, s2 = _arr(self.theta), _arr(self.mu), _arr(self.sigmasq)
        Y = Y + th * (mu - Y) * dt + _sqrt_pos(s2 * dt) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class OrnsteinUhlenbeck(SDEBase):
    """dY_i = theta_i(mu_i - Y_i)dt + sigma_ji dW_j with full matrix square
    root sigma (upper-triangular Cholesky factor of the covariance, applied
    transposed like the reference: OrnsteinUhlenbeck.hpp:157-180)."""

    sigmasq: Sequence[Sequence[float]] = ((0.25,),)  # covariance matrix
    theta: Sequence[float] = (1.0,)
    mu: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.theta)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        th, mu = _arr(self.theta), _arr(self.mu)
        cov = _arr(self.sigmasq)
        L = jnp.linalg.cholesky(cov)  # lower; reference stores upper+transpose
        Y = (Y + th * (mu - Y) * dt
             + jnp.sqrt(dt) * jnp.matmul(dW, L.T, precision=HI))
        return self.put(P, Y)


@dataclasses.dataclass
class Beta(SDEBase):
    """dY = b/2 (S-Y)dt + sqrt(k Y(1-Y)) dW (Beta.hpp:106-126)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)
        Y = Y + 0.5 * b * (S - Y) * dt + _sqrt_pos(k * Y * (1.0 - Y) * dt) * dW
        return self.put(P, Y)


class _FractionBetaMixin:
    """Adds instantaneous density/specific-volume slots (2*ncomp extra)."""

    @property
    def nprop(self):
        return 3 * self.ncomp

    def _store_derived(self, P, Y):
        rho = self.rho(Y)
        o = self.offset
        n = self.ncomp
        P = P.at[:, o + n : o + 2 * n].set(rho)
        P = P.at[:, o + 2 * n : o + 3 * n].set(1.0 / rho)
        return P


@dataclasses.dataclass
class NumberFractionBeta(_FractionBetaMixin, SDEBase):
    """Number-fraction beta: beta SDE + derived rho = rho2(1 - r'X), V=1/rho
    (NumberFractionBeta.hpp:120-190)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    rcomma: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.b)

    def rho(self, X):
        return _arr(self.rho2) * (1.0 - _arr(self.rcomma) * X)

    def advance(self, key, P, dt, t, moments=None):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)
        X = X + 0.5 * b * (S - X) * dt + _sqrt_pos(k * X * (1.0 - X) * dt) * dW
        return self._store_derived(self.put(P, X), X)


@dataclasses.dataclass
class MassFractionBeta(_FractionBetaMixin, SDEBase):
    """Mass-fraction beta: rho = rho2/(1 + r Y) (MassFractionBeta.hpp:47,187)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    r: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.b)

    def rho(self, Y):
        return _arr(self.rho2) / (1.0 + _arr(self.r) * Y)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)
        Y = Y + 0.5 * b * (S - Y) * dt + _sqrt_pos(k * Y * (1.0 - Y) * dt) * dW
        return self._store_derived(self.put(P, Y), Y)


def _decay_coeffs(bprime, kprime, m, v):
    """DECAY policy: b = b'(1 - v/(m(1-m))), k = k'v, with means/variances
    clamped away from the no-mix/fully-mixed limits
    (MixNumberFractionBetaCoeffPolicy.cpp:71-96)."""
    m = jnp.where((m < 1e-8) | (m > 1 - 1e-8), 0.5, m)
    v = jnp.where((v < 1e-8) | (v > 1 - 1e-8), 0.5, v)
    b = bprime * (1.0 - v / (m * (1.0 - m)))
    k = kprime * v
    return b, k


@dataclasses.dataclass
class MixNumberFractionBeta(_FractionBetaMixin, SDEBase):
    """Mix number-fraction beta: beta SDE with decay coefficient policy
    driven by the evolving mean/variance of X."""

    bprime: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kprime: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    rcomma: Sequence[float] = (0.5,)

    @property
    def ncomp(self):
        return len(self.bprime)

    def rho(self, X):
        return _arr(self.rho2) * (1.0 - _arr(self.rcomma) * X)

    def advance(self, key, P, dt, t, moments=None):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X.dtype)
        m = X.mean(axis=0)
        v = ((X - m) ** 2).mean(axis=0)
        b, k = _decay_coeffs(_arr(self.bprime), _arr(self.kprime), m, v)
        S = _arr(self.S)
        X = X + 0.5 * b * (S - X) * dt + _sqrt_pos(k * X * (1.0 - X) * dt) * dW
        return self._store_derived(self.put(P, X), X)


def _homdecay_S(b, k, r, rho2, d, d2, d3):
    """The homogeneous-decay S constraint forcing d<rho>/dt = 0 where
    <rho> = rho2/(1+rY) (MixMassFracBetaCoeffHomDecay::update,
    src/DiffEq/Beta/MixMassFractionBetaCoeffPolicy.cpp:243-259)."""
    d = jnp.where(d < 1e-8, 0.5, d)
    R = 1.0 + d2 / d / d
    B = -1.0 / r / r
    C = (2.0 + r) / r / r
    D = -(1.0 + r) / r / r
    diff = (
        B * d / rho2
        + C * d * d * R / rho2 / rho2
        + D * d * d * d * (1.0 + 3.0 * d2 / d / d + d3 / d / d / d)
        / rho2 / rho2 / rho2
    )
    return (
        rho2 / d / R
        + 2.0 * k / b * rho2 * rho2 / d / d * r * r / R * diff
        - 1.0
    ) / r


@dataclasses.dataclass
class MixMassFractionBeta(_FractionBetaMixin, SDEBase):
    """Mix mass-fraction beta with moment-coupled coefficient policies.

    coeff selects the policy (src/DiffEq/Beta/
    MixMassFractionBetaCoeffPolicy.cpp):
    - 'decay':     b = b'(1 - <y^2>/(<Y>(1-<Y>))), k = k'<y^2>
    - 'homdecay':  decay + S constrained so d<rho>/dt = 0
    - 'montecarlo_homdecay': the same constraint from raw MC moments
      (<YR^2>, <Y(1-Y)R^3>, <R^2>) instead of the closed-form density
      expansion
    - 'hydrotimescale': b,k additionally scaled by the DNS inverse
      hydro-timescale (eps/k) and shaped by P/eps tables; S as homdecay
      but without the [0,1] clamp (update():470-616).  Needs hts/hp:
      per-component tables (deck `hydrotimescales`/`hydroproductions`
      keywords resolved via diffeq.hydro.hydro_table).

    Derived per-particle slots (reference derived(), MixMassFractionBeta
    .hpp:308-318): R at ncomp+i, V=1/R at 2*ncomp+i, 1-Y at 3*ncomp+i.
    """

    bprime: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kprime: Sequence[float] = (1.0,)
    rho2: Sequence[float] = (1.0,)
    r: Sequence[float] = (0.5,)
    coeff: str = "decay"
    hts: Optional[Tuple] = None  # per-comp Table callables (hydrotimescale)
    hp: Optional[Tuple] = None

    @property
    def ncomp(self):
        return len(self.bprime)

    @property
    def nprop(self):
        return 4 * self.ncomp

    def rho(self, Y):
        return _arr(self.rho2) / (1.0 + _arr(self.r) * Y)

    def _store_derived(self, P, Y):
        rho = self.rho(Y)
        o, n = self.offset, self.ncomp
        P = P.at[:, o + n : o + 2 * n].set(rho)
        P = P.at[:, o + 2 * n : o + 3 * n].set(1.0 / rho)
        P = P.at[:, o + 3 * n : o + 4 * n].set(1.0 - Y)
        return P

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        bprime, kprime = _arr(self.bprime), _arr(self.kprime)
        r_, rho2_ = _arr(self.r), _arr(self.rho2)
        m = Y.mean(axis=0)
        v = ((Y - m) ** 2).mean(axis=0)

        if self.coeff in ("homdecay", "hydrotimescale"):
            R = self.rho(Y)
            d = R.mean(axis=0)
            rf = R - d
            d2 = (rf**2).mean(axis=0)
            d3 = (rf**3).mean(axis=0)

        if self.coeff == "homdecay":
            b, k = _decay_coeffs(bprime, kprime, m, v)
            S = _homdecay_S(b, k, r_, rho2_, d, d2, d3)
            S = jnp.where((S < 0.0) | (S > 1.0), 0.5, S)
        elif self.coeff == "montecarlo_homdecay":
            # S from raw Monte Carlo moments instead of the closed-form
            # density-moment expansion: S = (<YR^2> + 2k/b (r/rho2)
            # <Y(1-Y)R^3>) / <R^2>
            # (MixMassFracBetaCoeffMonteCarloHomDecay::update,
            # MixMassFractionBetaCoeffPolicy.cpp:318-403)
            b, k = _decay_coeffs(bprime, kprime, m, v)
            R = self.rho(Y)
            r2 = (R * R).mean(axis=0)
            yr2 = (Y * R * R).mean(axis=0)
            y1myr3 = (Y * (1.0 - Y) * R**3).mean(axis=0)
            r2 = jnp.where(r2 < 1e-8, 0.5, r2)
            S = (yr2 + 2.0 * k / b * r_ / rho2_ * y1myr3) / r2
            S = jnp.where((S < 0.0) | (S > 1.0), 0.5, S)
        elif self.coeff == "hydrotimescale":
            V = 1.0 / R
            RY = (R * Y).mean(axis=0)
            ds = -(rf * (V - V.mean(axis=0))).mean(axis=0)  # -<rv>
            yt = RY / d
            ts = jnp.stack([tb(t) for tb in self.hts])  # eps/k per comp
            pe = jnp.stack([tb(t) for tb in self.hp])   # P/eps per comp
            # b1..b3 are the FIRST THREE deck S values regardless of comp
            # (update() m_s[0..2], MixMassFractionBetaCoeffPolicy.cpp:567)
            if len(self.S) < 3:
                raise ValueError(
                    "hydrotimescale policy needs >= 3 S entries (the first "
                    "three seed the beta-shape constants b1..b3)")
            Sdeck = _arr(self.S)
            b1, b2, b3 = Sdeck[0], Sdeck[1], Sdeck[2]
            a = r_ / (1.0 + r_ * yt)
            bnm = a * a * yt * (1.0 - yt)
            thetab = 1.0 - ds / bnm
            f2 = 1.0 / jnp.sqrt(1.0 + (pe - 1.0) ** 2 * ds**0.25)
            eta = d2 / d / d / ds
            beta2 = b2 * (1.0 + eta * ds)
            Thetap = thetab * 0.5 * (1.0 + eta / (1.0 + eta * ds))
            beta3 = b3 * (1.0 + eta * ds)
            beta10 = b1 * (1.0 + ds) / (1.0 + eta * ds)
            beta1 = bprime * 2.0 / (1.0 + eta + eta * ds) * (
                beta10 + beta2 * Thetap * f2
                + beta3 * Thetap * (1.0 - Thetap) * f2
            )
            b = beta1 * ts
            k = kprime * beta1 * ts * ds * ds
            S = _homdecay_S(b, k, r_, rho2_, d, d2, d3)
        else:  # plain decay
            b, k = _decay_coeffs(bprime, kprime, m, v)
            S = _arr(self.S)

        Y = Y + 0.5 * b * (S - Y) * dt + _sqrt_pos(k * Y * (1.0 - Y) * dt) * dW
        return self._store_derived(self.put(P, Y), Y)


@dataclasses.dataclass
class Dirichlet(SDEBase):
    """K=N-1 Dirichlet SDE (Dirichlet.hpp:116-141)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kappa: Sequence[float] = (1.0, 1.0)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)
        yn = 1.0 - Y.sum(axis=1, keepdims=True)
        Y = Y + 0.5 * b * (S * yn - (1.0 - S) * Y) * dt + _sqrt_pos(
            k * Y * yn * dt
        ) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class GeneralizedDirichlet(SDEBase):
    """Lochner's generalized Dirichlet (GeneralizedDirichlet.hpp:150-190)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kappa: Sequence[float] = (1.0, 1.0)
    #: upper-triangular c_ij coefficients, K(K-1)/2 of them, row-major
    cij: Sequence[float] = (0.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        n = self.ncomp
        dW = _gauss(key, Y.shape[0], n, Y.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)

        # Y_i = 1 - sum_{k<=i} y_k  (cumulative remainder)
        Ycum = 1.0 - jnp.cumsum(Y, axis=1)  # (npar, n)
        # U_i = prod_{j>i} 1/Ycum_j ... U_{n-1}=1
        inv = 1.0 / Ycum
        # reverse cumulative product of inv over j=i..n-2
        rev = jnp.concatenate(
            [jnp.cumprod(inv[:, ::-1][:, 1:], axis=1)[:, ::-1],
             jnp.ones_like(inv[:, :1])],
            axis=1,
        )
        U = rev  # (npar, n)

        # a_i = sum_{j=i}^{n-2} c_ij / Ycum_j
        cmat = np.zeros((n, n))
        idx = 0
        cij = np.asarray(self.cij, dtype=np.float64)
        for i in range(n):
            for j in range(i, n - 1):
                cmat[i, j] = cij[idx] if idx < len(cij) else 0.0
                idx += 1
        cmat_j = _arr(cmat)
        # (npar,n) sum_j c_ij / Ycum_j (cols j<n-1 only set)
        a = jnp.matmul(inv, cmat_j.T, precision=HI)

        YN = Ycum[:, -1:]
        d = _sqrt_pos(k * Y * YN * U * dt)
        drift = U / 2.0 * (b * (S * YN - (1.0 - S) * Y) + Y * YN * a)
        Y = Y + drift * dt + d * dW
        return self.put(P, Y)


@dataclasses.dataclass
class MixDirichlet(SDEBase):
    """Mix Dirichlet: K advanced scalars + YN keeping the sum at 1, plus
    derived density/volume slots (MixDirichlet.hpp:141-231).

    coeff: 'const_coeff' keeps the deck S; 'homogeneous' updates S from
    MC moments so the mixture density stays homogeneous
    (MixDirichletHomogeneous::update, MixDirichletCoeffPolicy.cpp:
    196-272: S_c = (<R^2 Yc> + 2k/b r_c/rhoH <R^3 Yc YN>) /
    (<R^2 Yc> + <R^2 YN>)).

    The deck's rho vector is pre-sorted by normalization (heavy:
    ascending so rho_N = rho_H; light: descending — Grammar.hpp:
    495-506) and r_i = rho_N/rho_i -+ 1 (MixDir_r)."""

    b: Sequence[float] = (1.0, 1.5)
    S: Sequence[float] = (0.4, 0.4)
    kprime: Sequence[float] = (1.0, 1.0)
    rho: Sequence[float] = (1.0, 1.0, 1.0)  # N material densities
    r: Sequence[float] = ()
    coeff: str = "const_coeff"
    normalization: str = "light"

    @property
    def ncomp(self):
        return len(self.b)

    @property
    def nprop(self):
        # K advanced + YN + density + volume
        return self.ncomp + 3

    def advance(self, key, P, dt, t, moments=None):
        n = self.ncomp
        o = self.offset
        Y = P[:, o : o + n]
        yn = P[:, o + n : o + n + 1]
        dW = _gauss(key, Y.shape[0], n, Y.dtype)
        b = _arr(self.b)
        k = _arr(self.kprime)  # k = kprime for const/homogeneous
        rhoN = _arr(self.rho)
        if self.coeff in ("homogeneous", "hydrotimescale"):
            # the reference's MixDirichletHydroTimeScale::update ACTIVE
            # code is identical to Homogeneous (every table-driven S
            # variant is commented out, MixDirichletCoeffPolicy.cpp:
            # 479-508), so the policies share this branch
            R = P[:, o + n + 1 : o + n + 2]  # derived density slot
            R2Y = (R * R * Y).mean(axis=0)             # <R^2 Yc>
            R2YN = (R * R * yn).mean()                 # <R^2 YN>
            R3YNY = (R**3 * Y * yn).mean(axis=0)       # <R^3 Yc YN>
            if self.normalization == "light":          # rho sorted desc
                rhoL, rhoH = rhoN[-1], rhoN[0]
                rc = (rhoL / rhoN[:-1] + 1.0 - 2.0) * rhoH / rhoL
            else:                                      # rho sorted asc
                rhoL, rhoH = rhoN[0], rhoN[-1]
                rc = _arr(self.r) if len(self.r) else (
                    rhoN[-1] / rhoN[:-1] - 1.0)
            S = (R2Y + 2.0 * k / b * rc / rhoH * R3YNY) / (R2Y + R2YN)
        else:
            S = _arr(self.S)
        dY = 0.5 * b * (S * yn - (1.0 - S) * Y) * dt + _sqrt_pos(
            k * Y * yn * dt
        ) * dW
        Y = Y + dY
        yn = yn - dY.sum(axis=1, keepdims=True)
        # instantaneous density: 1/rho = sum_alpha Y_alpha/rho_alpha
        Yall = jnp.concatenate([Y, yn], axis=1)
        vol = (Yall / rhoN).sum(axis=1, keepdims=True)
        rho = 1.0 / vol
        P = P.at[:, o : o + n].set(Y)
        P = P.at[:, o + n : o + n + 1].set(yn)
        P = P.at[:, o + n + 1 : o + n + 2].set(rho)
        P = P.at[:, o + n + 2 : o + n + 3].set(vol)
        return P

    def initialize_derived(self, P):
        """Fill the density/volume slots from the initial Y (the
        reference's initialize() calls derived() per particle)."""
        n, o = self.ncomp, self.offset
        Yall = P[:, o : o + n + 1]
        vol = (Yall / _arr(self.rho)).sum(axis=1, keepdims=True)
        P = P.at[:, o + n + 1 : o + n + 2].set(1.0 / vol)
        P = P.at[:, o + n + 2 : o + n + 3].set(vol)
        return P


@dataclasses.dataclass
class Gamma(SDEBase):
    """dY = b/2 (S - (1-S)Y)dt + sqrt(k Y)dW (Gamma.hpp:104-124)."""

    b: Sequence[float] = (1.0,)
    S: Sequence[float] = (0.5,)
    kappa: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.b)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        dW = _gauss(key, Y.shape[0], self.ncomp, Y.dtype)
        b, S, k = _arr(self.b), _arr(self.S), _arr(self.kappa)
        Y = Y + 0.5 * b * (S - (1.0 - S) * Y) * dt + _sqrt_pos(k * Y * dt) * dW
        return self.put(P, Y)


@dataclasses.dataclass
class SkewNormal(SDEBase):
    """Skew-normal SDE (SkewNormal.hpp:136-161)."""

    T: Sequence[float] = (1.0,)
    sigmasq: Sequence[float] = (1.0,)
    lam: Sequence[float] = (1.0,)

    @property
    def ncomp(self):
        return len(self.T)

    def advance(self, key, P, dt, t, moments=None):
        X = self.slice(P)
        dW = _gauss(key, X.shape[0], self.ncomp, X.dtype)
        T, s2, lam = _arr(self.T), _arr(self.sigmasq), _arr(self.lam)
        drift = -(
            X
            - lam * s2 * jnp.sqrt(2.0 / jnp.pi)
            * jnp.exp(-(lam**2) * X**2 / 2.0)
            / (1.0 + jax.scipy.special.erf(lam * X / jnp.sqrt(2.0)))
        ) / T
        X = X + drift * dt + _sqrt_pos(2.0 * s2 / T * dt) * dW
        return self.put(P, X)


@dataclasses.dataclass
class WrightFisher(SDEBase):
    """Wright-Fisher: dY_i = (omega_i - Omega Y_i)/2 dt + sigma(Y)dW with
    diffusion B = diag(Y) - Y Y^T.

    The reference's advance is explicitly marked unfinished (a stable
    matrix square root is 'not yet implemented', WrightFisher.hpp:141-160);
    here B^(1/2) is computed per particle by symmetric eigendecomposition
    with negative eigenvalues clamped — slower but correct.
    """

    omega: Sequence[float] = (0.25, 0.5, 0.25)

    @property
    def ncomp(self):
        # advance the first N-1 fractions; store N
        return len(self.omega)

    def advance(self, key, P, dt, t, moments=None):
        Y = self.slice(P)
        n = self.ncomp
        om = _arr(self.omega)
        Om = om.sum()
        dW = _gauss(key, Y.shape[0], n, Y.dtype)

        B = jnp.eye(n, dtype=Y.dtype) * Y[:, :, None] - Y[:, :, None] * Y[:, None, :]
        w, V = jnp.linalg.eigh(B)
        sqB = jnp.einsum(
            "pij,pj,pkj->pik", V, jnp.sqrt(jnp.maximum(w, 0.0)), V,
            precision=HI,
        )
        Y = Y + 0.5 * (om - Om * Y) * dt + jnp.sqrt(dt) * jnp.einsum(
            "pij,pj->pi", sqB, dW, precision=HI
        )
        return self.put(P, Y)


@dataclasses.dataclass
class Position(SDEBase):
    """dX = (dU X + u) dt: particle position with coupled velocity
    (Position.hpp:82-102).  velocity_offset points at the coupled Velocity
    system's slots."""

    dU: Sequence[float] = (0.0,) * 9  # prescribed mean velocity gradient
    velocity_offset: int = 3

    ncomp = 3

    def advance(self, key, P, dt, t, moments=None):
        X = self.slice(P)
        u = P[:, self.velocity_offset : self.velocity_offset + 3]
        G = _arr(np.asarray(self.dU).reshape(3, 3))
        X = X + (jnp.matmul(X, G.T, precision=HI) + u) * dt
        return self.put(P, X)


@dataclasses.dataclass
class Dissipation(SDEBase):
    """Turbulence-frequency (gamma-distribution) model coupled to velocity
    (Dissipation.hpp:92-141)."""

    c3: float = 1.0
    c4: float = 0.25
    com1: float = 0.44
    com2: float = 0.9
    velocity_offset: int = 0
    prescribed_shear: float = 1.0

    ncomp = 1

    def advance(self, key, P, dt, t, moments=None):
        Op = self.slice(P)
        O = Op.mean()
        u = P[:, self.velocity_offset : self.velocity_offset + 3]
        fluc = u - u.mean(axis=0)
        rij = (fluc[:, :, None] * fluc[:, None, :]).mean(axis=0)
        tke = 0.5 * (rij[0, 0] + rij[1, 1] + rij[2, 2])
        Prod = -rij[0, 1] * self.prescribed_shear
        Som = self.com2 - self.com1 * Prod / (O * tke)
        dW = _gauss(key, Op.shape[0], 1, Op.dtype)
        d = _sqrt_pos(2.0 * self.c3 * self.c4 * O * O * Op * dt)
        Op = Op + (-self.c3 * (Op - O) - Som * Op) * O * dt + d * dW
        return self.put(P, Op)


def _glm_G(hts, C0, rij, dU):
    """Generalized Langevin model drift tensor (Langevin.cpp glm():
    Haworth-Pope coefficients over the Reynolds-stress anisotropy)."""
    A1, A2 = -(0.5 + 0.75 * C0), 3.7
    B1, B2, B3 = -0.2, 0.8, -0.2
    G1, G2, G3, G4, G5, G6 = -1.28, 3.01, -2.18, 0.0, 4.29, -3.09
    eye = jnp.eye(3, dtype=rij.dtype)
    tr = rij[0, 0] + rij[1, 1] + rij[2, 2]
    b = rij / tr - eye / 3.0
    trdU = dU[0, 0] + dU[1, 1] + dU[2, 2]
    dtmp = (b * dU).sum()
    G = (hts * A1 + B1 * trdU + G1 * dtmp) * eye
    G = G + hts * A2 * b + B2 * dU + B3 * dU.T + G4 * b * trdU
    G = G + G2 * jnp.einsum("jl,il->ij", b, dU, precision=HI)
    G = G + G3 * jnp.einsum("jl,li->ij", b, dU, precision=HI)
    G = G + G5 * jnp.einsum("il,lj->ij", b, dU, precision=HI)
    G = G + G6 * jnp.einsum("il,jl->ij", b, dU, precision=HI)
    return G


@dataclasses.dataclass
class Velocity(SDEBase):
    """Simplified Langevin model (Velocity.hpp:111-155, Langevin.cpp):
    dU_i = G_ij (U_j - <U_j>) dt + sqrt(C0 eps) dW_i.

    coeff selects the policy (VelocityCoeffPolicy.cpp):
    - 'const_shear' : G = -(1/2+3C0/4) eps/k I - dU, eps from the
      coupled Dissipation system (eps = k <omega>) or unit timescale
    - 'stationary'  : eps=1, G = -(3C0/4) I — forces a statistically
      stationary velocity PDF (update():102-141)
    - 'hydrotimescale': ts = hts(t) (DNS eps/k table), eps = ts*k,
      G = -(1/2+3C0/4) ts I (update():157-195)
    """

    c0: float = 2.1
    dissipation_offset: Optional[int] = None
    dU: Sequence[float] = (0.0,) * 9  # mean velocity gradient (shear)
    coeff: str = "const_shear"
    variant: str = "slm"  # slm | glm (Langevin.cpp slm()/glm())
    hts: Optional[object] = None  # Table callable (hydrotimescale)

    ncomp = 3

    def advance(self, key, P, dt, t, moments=None):
        U = self.slice(P)
        fluc = U - U.mean(axis=0)
        rij = (fluc[:, :, None] * fluc[:, None, :]).mean(axis=0)
        k = 0.5 * (rij[0, 0] + rij[1, 1] + rij[2, 2])
        eye = jnp.eye(3, dtype=U.dtype)
        if self.coeff == "stationary":
            eps = jnp.asarray(1.0, dtype=U.dtype)
            G = (-0.75 * self.c0) * eye
        elif self.coeff == "hydrotimescale":
            ts = jnp.asarray(self.hts(t), dtype=U.dtype)
            eps = ts * k
            G = (-(0.5 + 0.75 * self.c0) * ts) * eye
        else:  # const_shear
            if self.dissipation_offset is not None:
                O = P[:, self.dissipation_offset].mean()
                eps = k * O
            else:
                eps = k  # unit-timescale fallback
            dUm = _arr(np.asarray(self.dU).reshape(3, 3))
            if self.variant == "glm":
                G = _glm_G(eps / k, self.c0, rij, dUm)
            else:
                G = (-(0.5 + 0.75 * self.c0) * eps / k) * eye
            # the prescribed shear is subtracted AFTER the policy tensor
            # (Velocity.hpp:132)
            G = G - dUm
        dW = _gauss(key, U.shape[0], 3, U.dtype)
        d = _sqrt_pos(self.c0 * eps * dt)
        U = U + jnp.matmul(fluc, G.T, precision=HI) * dt + d * dW
        return self.put(P, U)

"""Particle initialization policies.

Counterpart of the reference's InitPolicy.hpp (RAW, ZERO, JOINTDELTA,
JOINTBETA, JOINTGAUSSIAN, JOINTCORRGAUSSIAN, JOINTGAMMA): pure functions
(key, npar) -> (npar, ncomp) using jax.random.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def init_raw(key, npar, ncomp, dtype=None):
    """Leave particles as-is (zeros here; the reference leaves memory raw)."""
    dtype = dtype or jnp.zeros(0).dtype
    return jnp.zeros((npar, ncomp), dtype=dtype)


def init_zero(key, npar, ncomp, dtype=None):
    dtype = dtype or jnp.zeros(0).dtype
    return jnp.zeros((npar, ncomp), dtype=dtype)


def init_jointdelta(key, npar, spikes: Sequence[Sequence[Tuple[float, float]]],
                    dtype=None):
    """Spikes per component: [(value, probability), ...]; probabilities sum
    to 1 per component."""
    dtype = dtype or jnp.zeros(0).dtype
    cols = []
    for c, sp in enumerate(spikes):
        vals = jnp.asarray([v for v, _ in sp], dtype=dtype)
        probs = np.asarray([p for _, p in sp])
        if not np.isclose(probs.sum(), 1.0):
            raise ValueError("spike probabilities must sum to 1")
        k = jax.random.fold_in(key, c)
        idx = jax.random.choice(k, len(sp), (npar,), p=jnp.asarray(probs))
        cols.append(vals[idx])
    return jnp.stack(cols, axis=1)


def init_jointbeta(key, npar, betapdf: Sequence[Tuple[float, float, float, float]],
                   dtype=None):
    """Per component (alpha, beta, lo, extent): lo + extent*Beta(a,b)."""
    dtype = dtype or jnp.zeros(0).dtype
    cols = []
    for c, (a, b, lo, ext) in enumerate(betapdf):
        k = jax.random.fold_in(key, c)
        cols.append(lo + ext * jax.random.beta(k, a, b, (npar,), dtype=dtype))
    return jnp.stack(cols, axis=1)


def init_jointgaussian(key, npar, gaussians: Sequence[Tuple[float, float]],
                       dtype=None):
    """Per component (mean, variance), independent."""
    dtype = dtype or jnp.zeros(0).dtype
    mu = jnp.asarray([m for m, _ in gaussians], dtype=dtype)
    sd = jnp.sqrt(jnp.asarray([v for _, v in gaussians], dtype=dtype))
    z = jax.random.normal(key, (npar, len(gaussians)), dtype=dtype)
    return mu + sd * z


def init_jointcorrgaussian(key, npar, mean, cov, dtype=None):
    """Correlated joint Gaussian with full covariance (Cholesky)."""
    dtype = dtype or jnp.zeros(0).dtype
    mu = jnp.asarray(mean, dtype=dtype)
    L = jnp.linalg.cholesky(jnp.asarray(cov, dtype=dtype))
    z = jax.random.normal(key, (npar, mu.shape[0]), dtype=dtype)
    return mu + jnp.matmul(z, L.T, precision=jax.lax.Precision.HIGHEST)


def init_jointgamma(key, npar, gammas: Sequence[Tuple[float, float]],
                    dtype=None):
    """Per component (shape, scale), independent."""
    dtype = dtype or jnp.zeros(0).dtype
    cols = []
    for c, (a, scale) in enumerate(gammas):
        k = jax.random.fold_in(key, c)
        cols.append(scale * jax.random.gamma(k, a, (npar,), dtype=dtype))
    return jnp.stack(cols, axis=1)


def init_jointdirichlet(key, npar, alphas, dtype=None):
    """Dirichlet(alpha_1..alpha_N) samples via normalized unit-scale
    gammas (InitPolicy.hpp:320-355): returns (npar, N) with sum 1."""
    dtype = dtype or jnp.zeros(0).dtype
    cols = []
    for c, a in enumerate(alphas):
        k = jax.random.fold_in(key, c)
        cols.append(jax.random.gamma(k, a, (npar,), dtype=dtype))
    Y = jnp.stack(cols, axis=1)
    return Y / Y.sum(axis=1, keepdims=True)

"""walker — time integration of SDE ensembles with online statistics.

Counterpart of the reference's Distributor/Integrator/Collector triple
(src/Walker/Distributor.cpp:53-134, Integrator.hpp:45-95, Collector.hpp):
the Charm++ chare-array-over-particle-chunks decomposition becomes a single
(npar, nprop) device array sharded over the 'par' axis of a
jax.sharding.Mesh — pure data parallelism, where every moment estimate is
a mean whose cross-device psum XLA inserts automatically (the Collector
pre-merge + custom reducers disappear).

The per-step pipeline (advance -> accumulateOrd -> bcast -> accumulateCen
-> PDFs at intervals) is one jitted function; moment histories are
accumulated with lax.scan for benchmarks or step-by-step for output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..statistics.stats import estimate_moments, Term
from ..statistics.pdf import estimate_pdf


class Walker:
    """Drive a set of coupled SDE systems over a particle ensemble.

    systems : list of quinoa_tpu.diffeq systems; offsets must already be
              laid out (use Walker.layout to assign them contiguously).
    npar    : ensemble size
    dt      : time step (the reference walker uses constant dt)
    seed    : RNG seed; per-step, per-system keys are folded from it
    ordinary/central : moment requests (statistics.Term) estimated at
              `stat_every` steps.
    mesh    : optional jax.sharding.Mesh with axis 'par' to shard particles.
    """

    def __init__(
        self,
        systems: Sequence,
        npar: int,
        dt: float,
        t0: float = 0.0,
        seed: int = 0,
        ordinary: Sequence[Term] = (),
        central: Sequence[Term] = (),
        mesh=None,
        dtype=None,
    ):
        self.systems = list(systems)
        self.npar = npar
        self.dt = dt
        self.t0 = t0
        self.dtype = dtype or jnp.zeros(0).dtype
        # QUINOA_PRNG_IMPL overrides the stream family (e.g. `rbg`, XLA's
        # RngBitGenerator-backed stream instead of
        # threefry2x32; statistically validated by the rngtest
        # batteries).  Default: jax's default (threefry), matching the
        # reference's Random123 streams.
        import os

        impl = os.environ.get("QUINOA_PRNG_IMPL")
        self.key = (jax.random.key(seed, impl=impl) if impl
                    else jax.random.key(seed))
        self.ordinary = list(ordinary)
        self.central = list(central)
        self.mesh = mesh

        self.offsets: Dict[str, int] = {}
        for s in self.systems:
            self.offsets[s.depvar] = s.offset
        self.nprop = max(s.offset + s.nprop for s in self.systems)

        self._it0 = 0  # global step counter: successive run() calls draw
        # fresh per-step keys (never reuse a (seed, step) pair)
        self._sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._sharding = NamedSharding(mesh, P("par", None))

        self._step = jax.jit(self._step_impl)

    @staticmethod
    def layout(systems: Sequence) -> List:
        """Assign contiguous offsets to systems in order."""
        off = 0
        for s in systems:
            s.offset = off
            off += s.nprop
        return list(systems)

    # -- lifecycle ------------------------------------------------------------

    def initialize(self):
        """Apply each system's init policy (InitPolicy.hpp analog)."""
        P = jnp.zeros((self.npar, self.nprop), dtype=self.dtype)
        for i, s in enumerate(self.systems):
            k = jax.random.fold_in(self.key, 10_000 + i)
            if s.init is not None:
                y0 = s.init(k, self.npar)
                P = P.at[:, s.offset : s.offset + y0.shape[1]].set(
                    y0.astype(self.dtype)
                )
            if hasattr(s, "initialize_derived"):
                P = s.initialize_derived(P)
        if self._sharding is not None:
            P = jax.device_put(P, self._sharding)
        return P

    def _step_impl(self, P, key, t):
        for i, s in enumerate(self.systems):
            k = jax.random.fold_in(key, i)
            P = s.advance(k, P, self.dt, t)
        return P

    def run(self, nsteps: int, stat_every: int = 0, P=None):
        """Integrate; returns (P, history) where history is a list of
        (t, {term: value}) at `stat_every` intervals."""
        if P is None:
            P = self.initialize()
        t = self.t0 + self._it0 * self.dt
        history = []
        for it in range(self._it0, self._it0 + nsteps):
            key = jax.random.fold_in(self.key, it)
            P = self._step(P, key, t)
            t += self.dt
            if stat_every and (it + 1) % stat_every == 0:
                mom = estimate_moments(
                    P, self.offsets, self.ordinary, self.central
                )
                history.append((t, {k: float(v) for k, v in mom.items()}))
        self._it0 += nsteps
        return P, history

    def pdf(self, P, term, binsize, extents=None, central=None):
        return estimate_pdf(P, self.offsets, term, binsize, extents,
                            central=central)

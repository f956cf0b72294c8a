"""Counter-based random number generation.

Counterpart of the reference's tk::RNG value-semantic wrapper over
Random123/RNGSSE2/MKL (src/RNG/RNG.hpp:35-63, RNGStack.cpp): jax.random *is*
a counter-based (threefry/philox-family) generator, the direct analog of
Random123's philox/threefry — so streams are folded keys, and every draw is
reproducible and parallelizable by construction.

The reference gives each Charm++ PE/chare its own stream id; here a stream
is `jax.random.fold_in(key, stream_id)`, and per-step keys are folded from
the step counter — the SPMD walker shards particles, not streams.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class RNG:
    """Value-semantic RNG with numbered streams (tk::RNG analog)."""

    def __init__(self, seed: int = 0, impl: str = "threefry"):
        # 'threefry' is jax's default counter-based generator (Random123
        # family); 'rbg' is XLA's RngBitGenerator-backed generator.
        self.impl = impl
        self.key = jax.random.key(seed, impl="threefry2x32" if impl == "threefry" else impl)

    def stream(self, i: int):
        return jax.random.fold_in(self.key, i)

    @staticmethod
    def uniform(key, shape, dtype=None):
        dtype = dtype or jnp.zeros(0).dtype
        return jax.random.uniform(key, shape, dtype=dtype)

    @staticmethod
    def gaussian(key, shape, dtype=None):
        dtype = dtype or jnp.zeros(0).dtype
        return jax.random.normal(key, shape, dtype=dtype)

    @staticmethod
    def beta(key, a, b, shape, dtype=None):
        dtype = dtype or jnp.zeros(0).dtype
        return jax.random.beta(key, a, b, shape, dtype=dtype)

    @staticmethod
    def gamma(key, a, shape, scale=1.0, dtype=None):
        dtype = dtype or jnp.zeros(0).dtype
        return jax.random.gamma(key, a, shape, dtype=dtype) * scale

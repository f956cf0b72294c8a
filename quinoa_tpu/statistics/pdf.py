"""PDF (histogram) estimation from particle ensembles.

Counterpart of the reference's UniPDF/BiPDF/TriPDF sparse-map estimators
(src/Statistics/UniPDF.hpp etc., merged across chares by PDFReducer): here
the histogram is a *dense fixed-extent* bin array filled with one
scatter-add — the cross-shard merge is the psum XLA inserts for the
sharded sum, replacing the custom Charm++ reducer.

Extents may be given (like the reference's user-specified extents) or
derived host-side from the data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class UniPDF:
    binsize: float
    lo: float
    counts: np.ndarray  # (nbins,)

    @property
    def nsamples(self) -> int:
        return int(self.counts.sum())

    def density(self) -> np.ndarray:
        return self.counts / (self.nsamples * self.binsize)


@dataclasses.dataclass
class BiPDF:
    binsize: Tuple[float, float]
    lo: Tuple[float, float]
    counts: np.ndarray  # (nx, ny)


@dataclasses.dataclass
class TriPDF:
    binsize: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    counts: np.ndarray  # (nx, ny, nz)


def _bin_index(x, lo, binsize, nbins):
    i = jnp.floor((x - lo) / binsize).astype(jnp.int32)
    return jnp.clip(i, 0, nbins - 1)


def histogram(samples, lo, binsize, nbins):
    """Dense n-D histogram of samples (npar, ndim) with fixed extents."""
    ndim = samples.shape[1]
    flat = jnp.zeros((int(np.prod(nbins)),), dtype=jnp.int32)
    idx = jnp.zeros(samples.shape[0], dtype=jnp.int32)
    stride = 1
    for d in range(ndim - 1, -1, -1):
        idx = idx + stride * _bin_index(samples[:, d], lo[d], binsize[d], nbins[d])
        stride *= int(nbins[d])
    flat = flat.at[idx].add(1)
    return flat.reshape(tuple(int(n) for n in nbins))


def estimate_pdf(
    particles,
    offsets,
    term,
    binsize: Sequence[float],
    extents: Optional[Sequence[Tuple[float, float]]] = None,
    central: Optional[Sequence[bool]] = None,
):
    """Estimate a 1/2/3-variate PDF of the variables in `term`.

    term : ((depvar, comp), ...) with 1-3 entries.
    binsize : bin width per dimension (like the reference's user request).
    extents : optional (lo, hi) per dimension; derived from data if absent
              (host-side sync).
    central : per-dimension flags — True samples the FLUCTUATION
              value - <value> (central PDF of a lowercase deck variable,
              Statistics::accumulateCenPDF:364-416), False the raw value.
    """
    cols = jnp.stack(
        [particles[:, offsets[v[0]] + v[1]] for v in term], axis=1
    )
    if central is not None and any(central):
        mask = jnp.asarray([1.0 if c else 0.0 for c in central],
                           dtype=cols.dtype)
        cols = cols - mask[None, :] * cols.mean(axis=0, keepdims=True)
    ndim = cols.shape[1]
    if ndim not in (1, 2, 3):
        raise ValueError("PDF must be uni/bi/tri-variate")

    if extents is None:
        lo = np.asarray(cols.min(axis=0))
        hi = np.asarray(cols.max(axis=0))
        extents = list(zip(lo.tolist(), hi.tolist()))

    los, nbins = [], []
    for d in range(ndim):
        lo_d, hi_d = extents[d]
        # snap extents to bin boundaries like the reference (bin id = floor)
        lo_d = np.floor(lo_d / binsize[d]) * binsize[d]
        n = max(1, int(np.ceil((hi_d - lo_d) / binsize[d] + 1e-12)) + 1)
        los.append(float(lo_d))
        nbins.append(n)

    counts = np.asarray(histogram(cols, los, list(binsize), nbins))

    if ndim == 1:
        return UniPDF(binsize=binsize[0], lo=los[0], counts=counts)
    if ndim == 2:
        return BiPDF(binsize=tuple(binsize), lo=tuple(los), counts=counts)
    return TriPDF(binsize=tuple(binsize), lo=tuple(los), counts=counts)

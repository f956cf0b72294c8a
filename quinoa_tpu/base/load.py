"""Load distribution with virtualization (tk::linearLoadDistributor).

The reference's key overdecomposition knob (LoadDistributor.cpp:23-90):
given virtualization u in [0,1], total load, and the number of processing
elements, compute the chunk size and number of work units

    chunksize = (1 - u) * load/npe + u * 1      (interpolating between
    one-chunk-per-PE and one-unit-per-item)     u=0 ... u=1

Here the "work units" are the per-device element blocks the partitioner
produces; virtualization > 0 maps to multiple mesh chunks resident per
device (the vmap-over-chunks batching axis, SURVEY.md §2.15).
"""

from __future__ import annotations

from typing import Tuple


def linear_load_distributor(
    virtualization: float, load: int, npe: int
) -> Tuple[int, int]:
    """Return (chunksize, nchare) like the reference: chunksize
    interpolates linearly between load/npe (u=0) and 1 (u=1); nchare is
    the number of chunks covering the load (remainder folded into the
    last chunk by the caller)."""
    if not 0.0 <= virtualization <= 1.0:
        raise ValueError("virtualization must be in [0,1]")
    if load < 1 or npe < 1:
        raise ValueError("positive load and npe required")
    n = load / npe
    chunksize = int((1.0 - virtualization) * n + virtualization * 1.0)
    chunksize = max(chunksize, 1)
    nchare = max(load // chunksize, 1)
    return chunksize, nchare

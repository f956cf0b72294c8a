"""Parallel layer: mesh partitioning, sharding, and halo exchange.

Counterpart of the reference's Charm++ orchestration
(src/Inciter/Partitioner.cpp, Sorter.cpp, the comrhs/comlhs/comaec/... p2p
exchanges of DiagCG/DistFCT, and Zoltan2 geometric partitioning): a static
host-side partition of elements over a `jax.sharding.Mesh`, per-shard padded
tables, and node-buffer combines (`psum`/`pmax`/`pmin` over the shard axis)
at exactly the points where the reference exchanged messages.
"""

def host_scalar(x):
    """Host value of a time-marching scalar that SPMD states carry as an
    (S,) shard-axis array (one copy per device)."""
    import numpy as np

    return np.asarray(x).ravel()[0]


from .partition import morton_partition, rcb_partition, partition_elements
from .shard import ShardedCG, build_cg_shards
from .spmd import SPMDDiagCGSolver
from .dg_shard import ShardedDG, build_dg_shards
from .dg_spmd import SPMDDGSolver
from .alecg_spmd import ShardedALECG, build_alecg_shards, SPMDALECGSolver

__all__ = [
    "morton_partition",
    "rcb_partition",
    "partition_elements",
    "ShardedCG",
    "build_cg_shards",
    "SPMDDiagCGSolver",
    "ShardedDG",
    "build_dg_shards",
    "SPMDDGSolver",
    "ShardedALECG",
    "build_alecg_shards",
    "SPMDALECGSolver",
]

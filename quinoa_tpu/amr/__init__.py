"""h-adaptive mesh refinement.

Counterpart of the reference's AMR kernel (src/Inciter/AMR/, ~5.1k LoC:
mesh_adapter, tet_store, edge_store, refinement classes 1:2/1:4/1:8 with
compatibility locking) and the Refiner chare (src/Inciter/Refiner.cpp):
edge-tag -> compatibility closure -> template subdivision -> solution
transfer, implemented as vectorized host-side (re)mesh events — refining
triggers a rebuild of the static device tables, the array-program analog of the
reference's migration+resize path (SURVEY.md §5.7).

Derefinement (derefine_mesh) collapses fully-flagged sibling groups back
to their parent, subject to conformity locks iterated to a fixed point —
the reference's derefinement_algorithm counterpart — with exactly
conservative DG transfer and subset CG transfer.
"""

from .refine import (
    compatible_tags, refine_mesh, uniform_refine, RefineMap,
    derefine_mesh, transfer_cg_derefine, transfer_dg_derefine,
)
from .error import edge_errors, tag_edges_by_error, tag_edges_by_coords

__all__ = [
    "compatible_tags",
    "refine_mesh",
    "uniform_refine",
    "RefineMap",
    "derefine_mesh",
    "transfer_cg_derefine",
    "transfer_dg_derefine",
    "edge_errors",
    "tag_edges_by_error",
    "tag_edges_by_coords",
]

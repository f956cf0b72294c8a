"""Device-side compute primitives (JAX/XLA).

The unstructured-mesh analog of an ML framework's op library: gather-based
assembly, quadrature/basis tables, Riemann fluxes, and equations of state.
Everything is jit-safe, static-shape, dtype-generic, and feature-major
(component axes lead, the long entity axis is the contiguous one).
"""

from .assembly import (
    build_nsup,
    gather_nodes,
    assemble_add,
    assemble_max,
    assemble_min,
)

__all__ = [
    "build_nsup",
    "gather_nodes",
    "assemble_add",
    "assemble_max",
    "assemble_min",
]

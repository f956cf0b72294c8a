"""inciter — parallel unstructured-tet shock hydrodynamics drivers.

Array-program counterpart of the reference's src/Inciter/ orchestration layer:
the Charm++ chare state machines (Transporter, DiagCG, DG, DistFCT, ...)
become pure jitted step functions over static geometry pytrees, driven by a
plain Python time loop (or lax.scan for benchmarks).
"""

from .diagcg import DiagCGSolver, CGState
from .diagnostics import Diagnostics

__all__ = ["DiagCGSolver", "CGState", "Diagnostics"]

"""quinoa_tpu — an accelerator-native adaptive computational fluid dynamics
framework.

A ground-up JAX/XLA re-design of the capabilities of Quinoa
(LANL's Charm++ adaptive CFD suite, see /root/reference):

- ``inciter``: unstructured-tet shock hydrodynamics with continuous-Galerkin
  (Taylor-Galerkin + flux-corrected transport) and discontinuous-Galerkin
  (P0/P1/P2, p-adaptive) spatial operators, h-adaptive mesh refinement.
- ``walker``: time integration of large ensembles of stochastic differential
  equations with online moment and PDF estimation.
- ``rngtest``: statistical test batteries for counter-based parallel RNGs.
- ``meshconv``: tetrahedral mesh file-format conversion.

Architecture stance (not a port): one SPMD XLA program per solver replaces
the reference's Charm++ dynamic task graph.  Mesh chunks are padded dense
tables (inpoel [E,4], CSR connectivity, halo gather indices) built host-side
once per (re)partition; every hot loop is a jitted/segment-op/Pallas kernel;
halo exchange is `psum`/`ppermute` over a `jax.sharding.Mesh` instead of
point-to-point chare messages.
"""

__version__ = "0.1.0"

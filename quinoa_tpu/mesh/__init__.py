"""Unstructured tetrahedral mesh core.

Array-program counterpart of the reference's ``src/Mesh/`` (UnsMesh.hpp,
DerivedData.hpp): a plain-array mesh container plus derived-connectivity
generators producing the padded dense tables the device kernels consume.
"""

from .unsmesh import UnsMesh
from .boxmesh import box_tet_mesh
from .derived import (
    gen_esup,
    gen_psup,
    gen_edsup,
    gen_inpoed,
    gen_esuel,
    gen_faces,
)
from .geometry import tet_geometry, nodal_volumes, node_gradients

__all__ = [
    "UnsMesh",
    "box_tet_mesh",
    "gen_esup",
    "gen_psup",
    "gen_edsup",
    "gen_inpoed",
    "gen_esuel",
    "gen_faces",
    "tet_geometry",
    "nodal_volumes",
    "node_gradients",
]

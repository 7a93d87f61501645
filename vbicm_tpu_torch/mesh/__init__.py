from .cooks import cooks_membrane_mesh
from .feap import MeshData, renumber_mesh
from .solid3d import beam_hex8_mesh, cube_hex8_mesh

__all__ = ["MeshData", "beam_hex8_mesh", "cooks_membrane_mesh", "cube_hex8_mesh",
           "renumber_mesh"]

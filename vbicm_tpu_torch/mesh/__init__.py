from .cooks import cooks_membrane_mesh
from .feap import MeshData

__all__ = ["MeshData", "cooks_membrane_mesh"]

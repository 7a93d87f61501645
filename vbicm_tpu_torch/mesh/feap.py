"""Mesh container (counterpart of ``vbicm_tpu/mesh/feap.py``).

Plain NumPy arrays, all node and element indices 0-based. The FEAP text
reader and writer are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Parsed mesh. All node/element indices are 0-based."""

    coords: np.ndarray  # (nnodes, space_dim) float64
    conn: np.ndarray  # (nele, max_ele_node) int32, 0-based node ids
    bc_nodes: np.ndarray  # (nbc,) int32
    bc_flags: np.ndarray  # (nbc, max_node_dof) int32 (1 = fixed)
    load_nodes: np.ndarray  # (nload,) int32
    load_vals: np.ndarray  # (nload, max_node_dof) float64
    disp_nodes: np.ndarray  # (ndisp,) int32
    disp_vals: np.ndarray  # (ndisp, max_node_dof) float64
    space_dim: int = 2
    max_node_dof: int = 2
    max_ele_node: int = 4

    @property
    def nnodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nele(self) -> int:
        return int(self.conn.shape[0])

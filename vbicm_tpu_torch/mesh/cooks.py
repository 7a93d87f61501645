"""Cook's-membrane quad4 mesh generator (counterpart of
``vbicm_tpu/mesh/cooks.py``).

Corners (0,0), (48,44), (48,60), (0,44); nodes numbered x-fastest from the
bottom edge; the left edge clamped; a total shear of 50 in +y on the right
edge, lumped uniformly with half weights at the two corner nodes. For
nx=20, ny=10 this is the reference's ``Armero_cooksm_20x10.txt``.
"""
from __future__ import annotations

import numpy as np

from .feap import MeshData

_L = 48.0
_H1 = 44.0
_H2 = 60.0
_TOTAL_SHEAR = 50.0


def cooks_membrane_mesh(nx: int = 20, ny: int = 10) -> MeshData:
    """Build an (nx x ny)-element quad4 mesh of Cook's membrane."""
    xi = np.linspace(0.0, 1.0, nx + 1)
    eta = np.linspace(0.0, 1.0, ny + 1)
    Xi, Eta = np.meshgrid(xi, eta)  # (ny+1, nx+1), x fastest
    x = _L * Xi
    y_bot = _H1 * Xi
    y_top = _H1 + (_H2 - _H1) * Xi
    y = y_bot + (y_top - y_bot) * Eta
    coords = np.stack([x.ravel(), y.ravel()], axis=1)  # node id = r*(nx+1)+c

    r, c = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n0 = (r * (nx + 1) + c).ravel()
    conn = np.stack([n0, n0 + 1, n0 + nx + 2, n0 + nx + 1], axis=1).astype(np.int32)

    bc_nodes = np.arange(ny + 1, dtype=np.int32) * (nx + 1)
    bc_flags = np.ones((ny + 1, 2), dtype=np.int32)

    load_nodes = (np.arange(ny + 1, dtype=np.int32) * (nx + 1)) + nx
    fy = np.full(ny + 1, _TOTAL_SHEAR / ny)
    fy[0] *= 0.5
    fy[-1] *= 0.5
    load_vals = np.stack([np.zeros(ny + 1), fy], axis=1)

    return MeshData(
        coords=coords,
        conn=conn,
        bc_nodes=bc_nodes,
        bc_flags=bc_flags,
        load_nodes=load_nodes,
        load_vals=load_vals,
        disp_nodes=np.zeros((0,), dtype=np.int32),
        disp_vals=np.zeros((0, 2), dtype=np.float64),
    )

"""Structured 3-D hex8 mesh generators (counterpart of
``vbicm_tpu/mesh/solid3d.py``).

All outputs are :class:`~vbicm_tpu_torch.mesh.feap.MeshData` with
``space_dim = max_node_dof = 3`` and 8-node trilinear hexahedra, node order
bottom quad CCW then top quad CCW (the sign order of ``ops.shape``'s
``_HEX_*`` constants). Node id = (k*(ny+1) + j)*(nx+1) + i.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .feap import MeshData


def beam_hex8_mesh(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 10.0,
    ly: float = 1.0,
    lz: float = 1.0,
    tip_force: tuple = (0.0, 0.0, -1.0),
) -> MeshData:
    """Cantilever box beam [0,lx]x[0,ly]x[0,lz] on an nx x ny x nz hex grid.

    The x=0 face is fully fixed; ``tip_force`` is the TOTAL force applied as
    the consistent nodal load of a uniform traction on the x=lx face
    (trilinear faces: each boundary face contributes area/4 to its 4 nodes).
    """
    if min(nx, ny, nz) < 1:
        raise ValueError("need at least one element per direction")
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)

    def nid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    nnodes = (nx + 1) * (ny + 1) * (nz + 1)
    coords = np.zeros((nnodes, 3))
    for k in range(nz + 1):
        for j in range(ny + 1):
            for i in range(nx + 1):
                coords[nid(i, j, k)] = (xs[i], ys[j], zs[k])

    conn = np.zeros((nx * ny * nz, 8), dtype=np.int32)
    e = 0
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                conn[e] = [
                    nid(i, j, k), nid(i + 1, j, k),
                    nid(i + 1, j + 1, k), nid(i, j + 1, k),
                    nid(i, j, k + 1), nid(i + 1, j, k + 1),
                    nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
                ]
                e += 1

    # clamp the x=0 face (all 3 dofs)
    bc_nodes = np.array(
        [nid(0, j, k) for k in range(nz + 1) for j in range(ny + 1)],
        dtype=np.int32,
    )
    bc_flags = np.ones((bc_nodes.shape[0], 3), dtype=np.int32)

    # consistent nodal load of a uniform traction on the x=lx face: each of
    # the ny*nz boundary faces spreads its share equally over its 4 corners
    w = np.zeros(nnodes)
    for k in range(nz):
        for j in range(ny):
            for n in (
                nid(nx, j, k), nid(nx, j + 1, k),
                nid(nx, j, k + 1), nid(nx, j + 1, k + 1),
            ):
                w[n] += 0.25
    w /= w.sum()
    load_nodes = np.nonzero(w)[0].astype(np.int32)
    load_vals = w[load_nodes, None] * np.asarray(tip_force, dtype=np.float64)[None, :]

    return MeshData(
        coords=coords,
        conn=conn,
        bc_nodes=bc_nodes,
        bc_flags=bc_flags,
        load_nodes=load_nodes,
        load_vals=load_vals,
        disp_nodes=np.zeros((0,), dtype=np.int32),
        disp_vals=np.zeros((0, 3), dtype=np.float64),
        space_dim=3,
        max_node_dof=3,
        max_ele_node=8,
    )


def cube_hex8_mesh(n: int = 2, l: float = 1.0) -> MeshData:
    """Cube on an n^3 grid with no BCs or loads (a patch-test fixture;
    boundary conditions are set per test by replacing MeshData fields)."""
    m = beam_hex8_mesh(n, n, n, l, l, l, tip_force=(0.0, 0.0, 0.0))
    return dataclasses.replace(
        m,
        bc_nodes=np.zeros((0,), dtype=np.int32),
        bc_flags=np.zeros((0, 3), dtype=np.int32),
        load_nodes=np.zeros((0,), dtype=np.int32),
        load_vals=np.zeros((0, 3), dtype=np.float64),
    )

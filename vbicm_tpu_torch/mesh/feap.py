"""Mesh container and FEAP-style text mesh reader and writer (counterpart
of ``vbicm_tpu/mesh/feap.py``).

The format of the reference's ``Armero_cooksm_20x10.txt``: a two-line header
``nnodes nele ? space_dim max_node_dof max_ele_node`` followed by sections
``COORdinates ALL``, ``ELEMents ALL``, ``BOUNdary conditions``, ``FORCe
conditions`` and optionally ``DISPlacement conditions``. Plain NumPy arrays,
all node and element indices 0-based (the file's are 1-based).
"""
from __future__ import annotations

import dataclasses
import re

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


def renumber_mesh(mesh: MeshData, seed: int) -> MeshData:
    """The same mesh with its nodes and its elements renumbered by random
    permutations drawn from ``seed``: an unstructured numbering (the dof
    map then follows no grid) of identical elements. Each element keeps its
    local node order."""
    rng = np.random.default_rng(seed)
    new_id = rng.permutation(mesh.nnodes).astype(np.int32)  # old node -> new node
    coords = np.empty_like(mesh.coords)
    coords[new_id] = mesh.coords
    conn = new_id[mesh.conn][rng.permutation(mesh.nele)]
    return dataclasses.replace(mesh, coords=coords, conn=conn, bc_nodes=new_id[mesh.bc_nodes],
                               load_nodes=new_id[mesh.load_nodes],
                               disp_nodes=new_id[mesh.disp_nodes])


def _seek_section(lines, start, name):
    """Return index just after the line whose stripped text == name, else None."""
    for i in range(start, len(lines)):
        if lines[i].strip() == name:
            return i + 1
    return None


def _read_block(lines, start, dtype):
    """Read consecutive non-blank lines as rows of numbers."""
    rows = []
    i = start
    while i < len(lines):
        t = lines[i].strip()
        if not t:
            break
        rows.append(np.array(t.split(), dtype=dtype))
        i += 1
    return (np.stack(rows, axis=0) if rows else np.zeros((0,), dtype=dtype)), i


# sections this parser understands; anything else headed by an alphabetic
# line is rejected loudly rather than silently skipped
_KNOWN_SECTIONS = (
    "COORdinates ALL",
    "ELEMents ALL",
    "BOUNdary conditions",
    "FORCe conditions",
    "DISPlacement conditions",
    "Parameters",  # trailing documentation block in the shipped mesh; ignored
)


def _check_unknown_sections(lines):
    """Fail loudly on section headers this parser does not understand: a
    silently skipped EDGE/PRESsure/TEMPerature block would otherwise make a
    quietly wrong model."""
    in_params = False
    for ln, raw in enumerate(lines[2:], start=3):
        t = raw.strip()
        if not t:
            continue
        if t in _KNOWN_SECTIONS:
            in_params = t == "Parameters"
            continue
        if in_params:
            continue  # free-form documentation
        # data rows start with a number; anything alphabetic is a header
        if re.match(r"^[A-Za-z]", t):
            raise ValueError(
                f"{ln}: unknown section or stray text {t[:40]!r} — supported "
                f"sections: {', '.join(_KNOWN_SECTIONS[:-1])}"
            )


def read_feap_mesh(path: str) -> MeshData:
    """Parse a FEAP-style text mesh into 0-based arrays. Every element
    family of the format is read (3-, 4-, 8-, 9-, 12- and 16-node), also
    those this package cannot build a model of yet."""
    with open(path, "r") as f:
        lines = f.readlines()

    if len(lines) < 2:
        raise ValueError(f"{path}: truncated FEAP file")
    header = np.array(lines[1].split(), dtype=np.float64)
    if header.shape[0] < 6:
        raise ValueError(
            f"{path}: header must be 'nnodes nele ? space_dim max_node_dof "
            f"max_ele_node', got {lines[1]!r}"
        )
    nnodes = int(header[0])
    nele = int(header[1])
    space_dim = int(header[3])
    max_node_dof = int(header[4])
    max_ele_node = int(header[5])
    if nnodes <= 0 or nele <= 0:
        raise ValueError(f"{path}: nonpositive nnodes/nele in header")
    if max_ele_node not in (3, 4, 8, 9, 12, 16):
        raise ValueError(f"{path}: unsupported max_ele_node {max_ele_node}")
    _check_unknown_sections(lines)

    i = _seek_section(lines, 2, "COORdinates ALL")
    if i is None:
        raise ValueError("COORdinates ALL section not found")
    coord_rows = []
    for k in range(nnodes):
        coord_rows.append(np.array(lines[i + k].split(), dtype=np.float64))
    coord_raw = np.stack(coord_rows, axis=0)  # (nnodes, 2 + space_dim): id, flag, x, y
    order = np.argsort(coord_raw[:, 0].astype(np.int64))
    coords = np.ascontiguousarray(coord_raw[order, 2 : 2 + space_dim])

    i = _seek_section(lines, i + nnodes, "ELEMents ALL")
    if i is None:
        raise ValueError("ELEMents ALL section not found")
    conn = np.zeros((nele, max_ele_node), dtype=np.int32)
    for k in range(nele):
        row = np.array(lines[i + k].split(), dtype=np.int64)
        conn[int(row[0]) - 1] = row[3 : 3 + max_ele_node] - 1  # skip id, flag, part

    j = _seek_section(lines, i + nele, "BOUNdary conditions")
    if j is not None:
        bdata, _ = _read_block(lines, j, np.int64)
    else:
        bdata = np.zeros((0, 2 + max_node_dof), dtype=np.int64)
    if bdata.size:
        bc_nodes = (bdata[:, 0] - 1).astype(np.int32)
        bc_flags = bdata[:, 2 : 2 + max_node_dof].astype(np.int32)
    else:
        bc_nodes = np.zeros((0,), dtype=np.int32)
        bc_flags = np.zeros((0, max_node_dof), dtype=np.int32)

    j = _seek_section(lines, i + nele, "FORCe conditions")
    if j is not None:
        ldata, _ = _read_block(lines, j, np.float64)
    else:
        ldata = np.zeros((0,), dtype=np.float64)
    if ldata.size:
        # node id 0 = placeholder row (all-zero loads); drop it
        ldata = ldata[ldata[:, 0] >= 1]
    if ldata.size:
        load_nodes = (ldata[:, 0].astype(np.int64) - 1).astype(np.int32)
        load_vals = ldata[:, 2 : 2 + max_node_dof].astype(np.float64)
    else:
        load_nodes = np.zeros((0,), dtype=np.int32)
        load_vals = np.zeros((0, max_node_dof), dtype=np.float64)

    j = _seek_section(lines, i + nele, "DISPlacement conditions")
    if j is not None:
        ddata, _ = _read_block(lines, j, np.float64)
    else:
        ddata = np.zeros((0,), dtype=np.float64)
    if ddata.size:
        disp_nodes = (ddata[:, 0].astype(np.int64) - 1).astype(np.int32)
        disp_vals = ddata[:, 2 : 2 + max_node_dof].astype(np.float64)
    else:
        disp_nodes = np.zeros((0,), dtype=np.int32)
        disp_vals = np.zeros((0, max_node_dof), dtype=np.float64)

    # index sanity: a malformed file should fail here, not as a garbage solve
    if conn.min() < 0 or conn.max() >= nnodes:
        raise ValueError(f"{path}: element connectivity references nodes "
                         f"outside [1, {nnodes}]")
    for name, ids in (("BOUNdary", bc_nodes), ("FORCe", load_nodes),
                      ("DISPlacement", disp_nodes)):
        if ids.size and (ids.min() < -1 or ids.max() >= nnodes):
            raise ValueError(f"{path}: {name} row references a node outside "
                             f"[1, {nnodes}]")

    return MeshData(
        coords=coords,
        conn=conn,
        bc_nodes=bc_nodes,
        bc_flags=bc_flags,
        load_nodes=load_nodes,
        load_vals=load_vals,
        disp_nodes=disp_nodes,
        disp_vals=disp_vals,
        space_dim=space_dim,
        max_node_dof=max_node_dof,
        max_ele_node=max_ele_node,
    )


def write_feap_mesh(path: str, mesh: MeshData) -> None:
    """Write a MeshData in the FEAP-style text format that
    :func:`read_feap_mesh` (and the reference's ``get_input_data``) reads.
    Floats are written with 17 significant digits, so that a float64 reads
    back to the same bits (the JAX package writes 16)."""
    L = []
    L.append("FEAP * * exported by vbicm_tpu_torch\n")
    L.append(
        f"{mesh.nnodes:10d}{mesh.nele:10d}{1:10d}{mesh.space_dim:10d}"
        f"{mesh.max_node_dof:10d}{mesh.max_ele_node:10d}\n"
    )
    L.append("\n")
    L.append("COORdinates ALL\n")
    for i, xy in enumerate(mesh.coords, start=1):
        row = " ".join(f"{v: .16E}" for v in xy)
        L.append(f"{i:10d} 0 {row}\n")
    L.append("\n")
    L.append("ELEMents ALL\n")
    for e, nodes in enumerate(mesh.conn, start=1):
        row = " ".join(f"{int(n) + 1:d}" for n in nodes)
        L.append(f"{e:10d} 0 1 {row}\n")
    L.append("\n")
    L.append("BOUNdary conditions\n")
    for n, flags in zip(mesh.bc_nodes, mesh.bc_flags):
        row = " ".join(str(int(fl)) for fl in flags)
        L.append(f"{int(n) + 1:10d} 0 {row}\n")
    L.append("\n")
    L.append("FORCe conditions\n")
    if mesh.load_nodes.size:
        for n, vals in zip(mesh.load_nodes, mesh.load_vals):
            row = " ".join(f"{v: .16E}" for v in vals)
            L.append(f"{int(n) + 1:10d} 0 {row}\n")
    else:
        L.append("         0 0 " + " ".join(["0.0"] * mesh.max_node_dof) + "\n")
    L.append("\n")
    if mesh.disp_nodes.size:
        L.append("DISPlacement conditions\n")
        for n, vals in zip(mesh.disp_nodes, mesh.disp_vals):
            row = " ".join(f"{v: .16E}" for v in vals)
            L.append(f"{int(n) + 1:10d} 0 {row}\n")
        L.append("\n")
    with open(path, "w") as f:
        f.writelines(L)

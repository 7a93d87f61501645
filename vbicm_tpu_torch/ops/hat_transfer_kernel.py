"""Tensor-product hat transfers on structured grids: the CUDA kernels'
wrapper and the plain PyTorch version (the transfers of
``ops.multigrid.make_grid_transfer_nd``).

On a grid of ``cells_coarse`` coarse cells an axis (slowest first), refined
``ratio`` times an axis, with ``ndof_node`` dofs a node adjacent, the
prolongation P applies each axis's 1-D hat matrix (``ops.multigrid.
hat_matrix``) to a batch of coarse vectors, the slowest axis first; the
restriction applies the transposed matrices, the fastest axis first, so
R = P^T exactly. The plain version is those dense products; the kernels
(``csrc/hat_transfer.cu``, ``hat_prolong_kernel`` and
``hat_restrict_kernel``) compute the same sums as chains over each axis's
two (prolongation) or 2 ratio - 1 (restriction) nonzero taps, in the plain
version's order of axes and taps, with the weights computed from the
indices. On CPU tensors :func:`hat_transfer` runs the plain version; on CUDA
tensors it launches a kernel or raises.

The two-level preconditioner's pair, :func:`hat_restrict_prec` and
:func:`hat_prolong_prec` (``hat_restrict_prec_kernel``,
``hat_prolong_prec_kernel``), are the same transfers with the rest of the
additive cycle folded in (``ops.multigrid.make_two_level_preconditioner``):
the fine free mask and the coarse free dofs on the restriction, the embed,
the mask and the ``omega D^-1 r`` smoothing on the prolongation, in the
composition's arithmetic, bit for bit. They take CUDA tensors only: their
plain version is that composition, the preconditioner's plain form.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import _build

SMEM_BUDGET = 52 * 1024  # bytes a restriction block aims for (four blocks an SM)
SMEM_MAX = 227 * 1024  # bytes a block may have on an H100
PROLONG_BYTES = 16 * 1024  # fine values a prolongation block writes, at most


def grid_nodes(cells_coarse, ratio: int):
    """(fine nodes, coarse nodes) an axis, slowest first."""
    return ([c * ratio + 1 for c in cells_coarse], [c + 1 for c in cells_coarse])


def hat_transfer_reference(x, mats, cells_coarse, ratio: int, *, adjoint: bool):
    """Plain PyTorch version: the prolongation (``adjoint=False``, x the
    (B, ndof_node * prod(coarse nodes)) coarse vectors, ``mats`` the 1-D hat
    matrices (fine, coarse) an axis) or the restriction (``adjoint=True``, x
    fine, ``mats`` their transposes), one batched matrix product an axis, in
    x's dtype."""
    nf, nc = grid_nodes(cells_coarse, ratio)
    B = x.shape[0]
    t = x
    if not adjoint:
        for k, p in enumerate(mats):
            # axes before k are fine already, axes after k still coarse
            t = torch.matmul(p, t.reshape(B * int(np.prod(nf[:k])), nc[k], -1))
    else:
        for k in reversed(range(len(mats))):
            # axes before k are fine still, axes after k coarse already
            t = torch.matmul(mats[k], t.reshape(B * int(np.prod(nf[:k])), nf[k], -1))
    return t.reshape(B, -1)


def _row_words(nodes: int, ndof_node: int) -> int:
    """Values a row of ``nodes`` nodes takes in a block's shared memory: an
    odd number of slots, a slot a node for 2 dofs and a value for 3
    (csrc/hat_transfer.cu, ``row_words``)."""
    return 2 * (nodes | 1) if ndof_node == 2 else (ndof_node * nodes) | 1


def smem_bytes(cells_coarse, ratio: int, ndof_node: int, itemsize: int, *, tz=1, ty=1,
               lines=None) -> int:
    """Shared memory of a restriction block of ``tz`` x ``ty`` coarse
    (z-planes, y-rows), or, given ``lines``, of a prolongation block of
    that many fine x lines (csrc/hat_transfer.cu, ``restrict_words``,
    ``prolong_words``)."""
    nf, nc = grid_nodes(cells_coarse, ratio)
    if lines is not None:
        return (lines * _row_words(nc[-1], ndof_node) + ratio + 1) * itemsize
    nz = nf[0] if len(nf) == 3 else 1
    wz = min(nz, ratio * tz + ratio - 1)
    wy = min(nf[-2], ratio * ty + ratio - 1)
    words = wz * wy * (_row_words(nf[-1], ndof_node) + _row_words(nc[-1], ndof_node))
    if len(nf) == 3:
        words += wz * ty * _row_words(nc[-1], ndof_node)
    return (words + ratio + 1) * itemsize


@dataclasses.dataclass(frozen=True)
class HatPlan:
    """A grid's launches: restriction blocks of ``tz`` coarse z-planes (1 on
    a 2-D grid) x ``ty`` coarse y-rows x every coarse x node of one sample,
    numbered (sample, z tile, y tile) with the y tile fastest; prolongation
    blocks of ``lines`` consecutive fine x lines of one sample, numbered
    (sample, band); each with its blocks a launch and shared-memory bytes a
    block."""

    tz: int
    ty: int
    lines: int
    restrict_blocks: int
    restrict_smem: int
    prolong_blocks: int
    prolong_smem: int


def _even_tiles(n: int, most: int) -> int:
    """The tile of at most ``most`` that splits n into the fewest, most
    even tiles."""
    tiles = -(-n // most)
    return -(-n // tiles)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, cells_coarse: tuple, ratio: int, ndof_node: int, itemsize: int, *,
                tz=None, ty=None, lines=None) -> HatPlan:
    """The tiles of the transfers of (B, grid) in ``itemsize``-byte values.

    The restriction takes a whole sample a block where two such blocks fit
    an SM (no halo lines then), else the largest tile whose block stays
    within ``SMEM_BUDGET`` (y-rows first, then z-planes), evened out over
    the grid, and at least one coarse row (one plane) up to ``SMEM_MAX``.
    The prolongation takes as many fine x lines as write ``PROLONG_BYTES``.
    ``tz``, ``ty`` and ``lines`` force a tile. tools/hat_tiles.py times
    the tiles on the card (PERF.md). Raises ``ValueError`` where even the
    least tile is too large for a block."""
    naxes = len(cells_coarse)
    if naxes not in (2, 3) or ndof_node not in (2, 3) or ratio < 2 or B <= 0 \
            or min(cells_coarse) < 1:
        raise ValueError(f"hat transfers: B={B}, cells {tuple(cells_coarse)}, ratio {ratio}, "
                         f"{ndof_node} dofs a node")
    nf, nc = grid_nodes(cells_coarse, ratio)
    cz = nc[0] if naxes == 3 else 1
    nlines = math.prod(nf[:-1])

    def smem(tz_, ty_):
        return smem_bytes(cells_coarse, ratio, ndof_node, itemsize, tz=tz_, ty=ty_)

    if smem(1, 1) > SMEM_MAX:
        raise ValueError(f"a grid line of {nf[-1]} nodes is too long for the hat-transfer "
                         f"kernel's block ({smem(1, 1)} bytes of shared memory)")
    if tz is None and ty is None and smem(cz, nc[-2]) <= SMEM_MAX // 2:
        tz, ty = cz, nc[-2]
    if ty is None:
        ty = 1
        while ty < nc[-2] and smem(tz or 1, ty + 1) <= SMEM_BUDGET:
            ty += 1
        ty = _even_tiles(nc[-2], ty)
    if tz is None:
        tz = 1
        if ty == nc[-2]:
            while tz < cz and smem(tz + 1, ty) <= SMEM_BUDGET:
                tz += 1
        tz = _even_tiles(cz, tz)
    if lines is None:
        lines = max(1, min(nlines, PROLONG_BYTES // (nf[-1] * ndof_node * itemsize)))
    return HatPlan(tz, ty, lines,
                   B * -(-cz // tz) * -(-nc[-2] // ty), smem(tz, ty),
                   B * -(-nlines // lines),
                   smem_bytes(cells_coarse, ratio, ndof_node, itemsize, lines=lines))


@functools.lru_cache(maxsize=None)
def _sizes(cells_coarse: tuple, ratio: int, ndof_node: int):
    """(fine, coarse) values a sample, or None for a grid the kernels do not
    take."""
    if len(cells_coarse) not in (2, 3) or ndof_node not in (2, 3) or ratio < 2 \
            or min(cells_coarse) < 1:
        return None
    nf, nc = grid_nodes(cells_coarse, ratio)
    return ndof_node * math.prod(nf), ndof_node * math.prod(nc)


def free_slots(free_dof, n_coarse: int):
    """(n_coarse,) int32 on ``free_dof``'s device: each coarse dof's index in
    ``free_dof`` (the coarse solve's order of its unknowns), -1 at a
    support; the table of the preconditioner's pair."""
    free = torch.as_tensor(free_dof).cpu().long()
    slots = torch.full((int(n_coarse),), -1, dtype=torch.int32)
    slots[free] = torch.arange(free.numel(), dtype=torch.int32)
    return slots.to(torch.as_tensor(free_dof).device)


def _checked_sizes(who: str, cells_coarse: tuple, ratio: int, ndof_node: int):
    sizes = _sizes(cells_coarse, ratio, ndof_node)
    if sizes is None:
        raise ValueError(f"{who}: cells {cells_coarse}, ratio {ratio}, {ndof_node} dofs a node; "
                         "the kernels take 2 or 3 axes, 2 or 3 dofs a node and a ratio >= 2")
    return sizes


def _check_shape(who: str, name: str, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} {tuple(t.shape)}; expected {tuple(shape)}")


def _check_slots(who: str, slots, n_c: int, nfree: int):
    if slots.dtype != torch.int32:
        raise TypeError(f"{who}: slots {slots.dtype}; expected torch.int32 (free_slots)")
    _check_shape(who, "slots", slots, (n_c,))
    if not 0 <= nfree <= n_c:
        raise ValueError(f"{who}: nfree {nfree} outside [0, {n_c}]")


def _grid_args(cells_coarse: tuple, ratio: int, ndof_node: int):
    """(naxes, ndof, r, cz, cy, cx) of a C entry point (cz = 0 in 2-D)."""
    czyx = (0, *cells_coarse) if len(cells_coarse) == 2 else cells_coarse
    return (len(cells_coarse), ndof_node, ratio, *czyx)


def hat_transfer(x, mats, cells_coarse, ratio: int, ndof_node: int, *, adjoint: bool,
                 plan=None):
    """The prolongation (``adjoint=False``: x coarse (B, ndof_node *
    prod(c + 1))) or the restriction (``adjoint=True``: x fine (B, ndof_node
    * prod(c * ratio + 1))) of :func:`hat_transfer_reference`.

    CPU tensors run :func:`hat_transfer_reference` on ``mats``. CUDA tensors
    run a kernel with :func:`launch_plan`'s tiles (``plan`` forces one):
    float32 or float64, contiguous, aligned to two values for 2 dofs a node,
    2 or 3 axes, 2 or 3 dofs a node, any ratio >= 2. Returns the other grid's
    vectors in x's dtype.

    Counter ``hat_transfer.launches`` (``utils.trace``): the kernels'
    launches, both directions.
    """
    if x.device.type == "cpu":
        return hat_transfer_reference(x, mats, cells_coarse, ratio, adjoint=adjoint)
    cells_coarse = tuple(cells_coarse)
    sizes = _checked_sizes("hat_transfer", cells_coarse, ratio, ndof_node)
    n_in, n_out = sizes if adjoint else sizes[::-1]
    if x.ndim != 2 or x.shape[1] != n_in:
        raise ValueError(f"hat_transfer: x {tuple(x.shape)}; expected (B, {n_in})")
    # 2 dofs a node: the kernels read a node's pair as one load
    device = _build.check_operands("hat_transfer", ("x",), (x,), floats=1,
                                   align=(2 * x.element_size() if ndof_node == 2 else 0,))
    dtype = x.dtype
    B = x.shape[0]
    out = torch.empty((B, n_out), dtype=dtype, device=device)
    if B > 0:
        if plan is None:
            plan = launch_plan(B, cells_coarse, ratio, ndof_node, x.element_size())
        if adjoint:
            name, tail = "hat_restrict", (plan.tz, plan.ty)
        else:
            name, tail = "hat_prolong", (plan.lines,)
        _build.launch(name, dtype, device,
                      (x.data_ptr(), out.data_ptr(), B,
                       *_grid_args(cells_coarse, ratio, ndof_node), *tail),
                      lambda: f"(B={B}, cells {cells_coarse}, ratio {ratio}, {ndof_node} dofs a "
                              f"node, {plan}, {dtype})", "hat_transfer")
    return out


def hat_restrict_prec(r, mask, slots, nfree: int, cells_coarse, ratio: int, ndof_node: int, *,
                      plan=None):
    """The preconditioner's restriction: R (r mask) at the coarse free dofs,
    (B, nfree) in the order of ``slots`` (:func:`free_slots`: (n_c,) int32,
    each coarse dof's index among the ``nfree`` free ones or -1; the kernel
    trusts it). r: fine (B, n_f); mask: the fine free mask (n_f,) in r's
    dtype.

    One launch of ``hat_restrict_prec_kernel`` with :func:`launch_plan`'s
    tiles, on CUDA operands as :func:`hat_transfer` takes them (r and mask
    aligned to two values for 2 dofs a node), or raise; CPU tensors raise
    too (the plain version is ``ops.multigrid.make_two_level_preconditioner``'s
    plain form). Counted in ``hat_transfer_prec.launches``."""
    who = "hat_restrict_prec"
    cells_coarse = tuple(cells_coarse)
    n_f, n_c = _checked_sizes(who, cells_coarse, ratio, ndof_node)
    if r.ndim != 2:
        raise ValueError(f"{who}: r {tuple(r.shape)}; expected (B, {n_f})")
    B = r.shape[0]
    _check_shape(who, "r", r, (B, n_f))
    _check_shape(who, "mask", mask, (n_f,))
    _check_slots(who, slots, n_c, nfree)
    align = 2 * r.element_size() if ndof_node == 2 else 0
    device = _build.check_operands(who, ("r", "mask", "slots"), (r, mask, slots), floats=2,
                                   align=(align, align))
    out = torch.empty((B, nfree), dtype=r.dtype, device=device)
    if B > 0:
        if plan is None:
            plan = launch_plan(B, cells_coarse, ratio, ndof_node, r.element_size())
        _build.launch("hat_restrict_prec", r.dtype, device,
                      (r.data_ptr(), mask.data_ptr(), slots.data_ptr(), out.data_ptr(), nfree, B,
                       *_grid_args(cells_coarse, ratio, ndof_node), plan.tz, plan.ty),
                      lambda: f"(B={B}, cells {cells_coarse}, ratio {ratio}, {ndof_node} dofs a "
                              f"node, {nfree} free coarse dofs, {plan}, {r.dtype})",
                      "hat_transfer_prec")
    return out


def hat_prolong_prec(z_free, slots, r, diag_inv, mask, omega: float, cells_coarse, ratio: int,
                     ndof_node: int, *, plan=None):
    """The preconditioner's prolongation: z = omega diag_inv (r mask) +
    P(z_c) mask, z_c the compact coarse vectors ``z_free`` (B, nfree)
    embedded with zeros at the supports through ``slots`` (as in
    :func:`hat_restrict_prec`). r and diag_inv: fine (B, n_f); mask (n_f,);
    all one dtype; omega multiplies as PyTorch multiplies a tensor by a
    Python float (rounded to the dtype).

    One launch of ``hat_prolong_prec_kernel`` on CUDA operands (r, diag_inv
    and mask aligned to two values for 2 dofs a node), or raise; CPU
    tensors raise too. Counted in ``hat_transfer_prec.launches``."""
    who = "hat_prolong_prec"
    cells_coarse = tuple(cells_coarse)
    n_f, n_c = _checked_sizes(who, cells_coarse, ratio, ndof_node)
    if z_free.ndim != 2:
        raise ValueError(f"{who}: z_free {tuple(z_free.shape)}; expected (B, nfree)")
    B, nfree = z_free.shape
    _check_shape(who, "r", r, (B, n_f))
    _check_shape(who, "diag_inv", diag_inv, (B, n_f))
    _check_shape(who, "mask", mask, (n_f,))
    _check_slots(who, slots, n_c, nfree)
    align = 2 * r.element_size() if ndof_node == 2 else 0
    device = _build.check_operands(who, ("z_free", "r", "diag_inv", "mask", "slots"),
                                   (z_free, r, diag_inv, mask, slots), floats=4,
                                   align=(0, align, align, align))
    z = torch.empty((B, n_f), dtype=r.dtype, device=device)
    if B > 0:
        if plan is None:
            plan = launch_plan(B, cells_coarse, ratio, ndof_node, r.element_size())
        _build.launch("hat_prolong_prec", r.dtype, device,
                      (z_free.data_ptr(), slots.data_ptr(), r.data_ptr(), diag_inv.data_ptr(),
                       mask.data_ptr(), float(omega), z.data_ptr(), nfree, B,
                       *_grid_args(cells_coarse, ratio, ndof_node), plan.lines),
                      lambda: f"(B={B}, cells {cells_coarse}, ratio {ratio}, {ndof_node} dofs a "
                              f"node, {nfree} free coarse dofs, {plan}, {r.dtype})",
                      "hat_transfer_prec")
    return z

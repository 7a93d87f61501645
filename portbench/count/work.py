"""Bytes and operations the cells' operations need at their inputs.

Each count is of the operation, not of a kernel that computes it: every
input read once and every output written once, operations as the
mathematics needs them (a stencil's nonzero coefficients, a transfer's
nonzero weights, separable where it is separable). Where the work depends
on the data, as a CG loop whose lanes stop at their own iteration, a lane
counts only the iterations it needs and a shared operand is read once per
batched call while some lane needs the call. The counts are therefore
lower bounds of what any implementation moves and computes, and the least
time they give (:func:`least_time_s`) is a time no implementation beats.

Operations on matrices (the spectral apply, the hat transfers) are held
to the tensor cores' rate at the operands' accuracy
(3xTF32 for float32, FP64 DMMA for float64); everything else to the CUDA
cores'.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Work:
    op: str  # "stencil", "spectral", "transfer", "vector"
    nbytes: float
    flops: float
    unit: str  # a key of count.peaks


def _unit(itemsize: int, matrix: bool) -> str:
    if matrix:
        return "tf32x3_tc" if itemsize == 4 else "fp64_tc"
    return "fp32" if itemsize == 4 else "fp64"


def least_time_s(works: Iterable[Work], peaks: dict, op: str = None) -> float:
    """Sum over the works (of ``op`` only, if given) of the larger of bytes
    over the memory rate and operations over the unit's peak."""
    return sum(max(w.nbytes / peaks["hbm_bytes_per_s"], w.flops / peaks[w.unit])
               for w in works if op is None or w.op == op)


def stencil(lanes, calls, ndof, nnz, itemsize, combine=True) -> Work:
    """``K(c) u`` (or one part, ``combine=False``) on ``lanes`` vectors of
    ``ndof`` in ``calls`` batched calls: the ``nnz`` nonzero coefficients
    once a call, each lane's u in, q out and two coefficients; an FMA per
    coefficient a lane, and the two parts' combine (3 a dof)."""
    nbytes = (calls * nnz + lanes * (2 * ndof + 2)) * itemsize
    flops = lanes * (2 * nnz + (3 * ndof if combine else 0))
    return Work("stencil", nbytes, flops, _unit(itemsize, False))


def spectral(lanes, calls, n, itemsize, coords) -> Work:
    """``x = V diag(1 / (c0 g + c1)) V^T b`` at size n: V and g once a call,
    each lane's b and coefficients in, x out (and the eigen-coordinates a
    where the caller keeps them); two products and the scale."""
    nbytes = (calls * (n * n + n) + lanes * (2 + (3 if coords else 2) * n)) * itemsize
    return Work("spectral", nbytes, lanes * (4 * n * n + 3 * n), _unit(itemsize, True))


def hat_nnz(cells: int, ratio: int) -> int:
    """Nonzero weights of the 1-D hat prolongation from cells + 1 coarse to
    cells * ratio + 1 fine nodes: one at a fine node on a coarse one, two
    elsewhere."""
    nc, nf = cells + 1, cells * ratio + 1
    return nc + 2 * (nf - nc)


def hat_transfer(lanes, calls, cells_c: Sequence[int], ratio, itemsize, ndof_node=2) -> Work:
    """One restriction or prolongation between the 2-D or 3-D grids of
    ``cells_c`` coarse cells (slowest axis first: (ny_c, nx_c) or (nz_c,
    ny_c, nx_c)) and ``ratio`` times as many: each lane's fine and coarse
    vectors once, the 1-D weights once a call; a multiply-add per nonzero
    weight, applied axis by axis in the cheapest order (an axis's pass
    costs its weights times the other axes' sizes, coarse where they have
    had their pass)."""
    fine = [c * ratio + 1 for c in cells_c]
    coarse = [c + 1 for c in cells_c]
    z = [hat_nnz(c, ratio) for c in cells_c]
    nbytes = (lanes * ndof_node * (math.prod(fine) + math.prod(coarse)) + calls * sum(z)) * itemsize

    def cost(order):
        sizes, total = list(fine), 0
        for a in order:
            total += z[a] * math.prod(sizes[:a] + sizes[a + 1:])
            sizes[a] = coarse[a]
        return total

    per = 2 * ndof_node * min(map(cost, itertools.permutations(range(len(cells_c)))))
    return Work("transfer", nbytes, lanes * per, _unit(itemsize, True))


def vector(lanes, n, reads, writes, flops_per, itemsize) -> Work:
    """Elementwise work on ``lanes`` vectors of n: ``reads`` vectors in,
    ``writes`` out, ``flops_per`` operations an entry."""
    return Work("vector", lanes * n * (reads + writes) * itemsize, lanes * n * flops_per,
                _unit(itemsize, False))


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """The shapes of a two-level PCG on a refined structured grid (Cook's
    2-D, the box 3-D): fine ``ndof`` (free dofs and supports), the fine
    operator's nonzeros by part, coarse ``cells_c`` (slowest axis first:
    (ny_c, nx_c) or (nz_c, ny_c, nx_c)) at ``ratio``, the coarse solve's
    free-dof size, the dofs a node."""

    ndof: int
    nnz_parts: tuple
    cells_c: tuple
    ratio: int
    n_coarse: int
    ndof_node: int = 2

    @property
    def nnz(self):
        return sum(self.nnz_parts)


def cg_run(g: TwoLevel, iters: np.ndarray, itemsize: int) -> List[Work]:
    """One PCG run whose lanes needed ``iters`` iterations: a matvec and the
    vector updates an iteration, the additive preconditioner (restrict,
    coarse solve, prolong, Jacobi and sum) at the start and an iteration.
    The updates: p.Kp, x += a p, r -= a Kp, r.z, p = z + b p, r.r (11
    vectors read, 3 written, 12 operations an entry)."""
    iters = np.asarray(iters, dtype=np.int64)
    lanes, total, most = iters.size, int(iters.sum()), int(iters.max(initial=0))
    if lanes == 0:
        return []
    pl, pc = total + lanes, most + 1
    return [
        stencil(total, most, g.ndof, g.nnz, itemsize),
        hat_transfer(pl, pc, g.cells_c, g.ratio, itemsize, g.ndof_node),
        spectral(pl, pc, g.n_coarse, itemsize, coords=False),
        hat_transfer(pl, pc, g.cells_c, g.ratio, itemsize, g.ndof_node),
        vector(pl, g.ndof, 3, 1, 3, itemsize),
        vector(total, g.ndof, 11, 3, 12, itemsize),
    ]


def two_level_solve(g: TwoLevel, runs: Sequence[np.ndarray], cg_itemsize=4,
                    itemsize=8) -> List[Work]:
    """A refined solve: its CG runs (the first, then one a refinement) in
    the CG's precision and, between them, each refinement's residual
    b - K(c) x and update x += dx in the answer's."""
    works = []
    for k, iters in enumerate(runs):
        lanes = len(iters)
        if k > 0:
            works += [stencil(lanes, 1, g.ndof, g.nnz, itemsize),
                      vector(lanes, g.ndof, 2, 1, 1, itemsize),
                      Work("vector", lanes * g.ndof * (2 * itemsize + cg_itemsize),
                           lanes * g.ndof, _unit(itemsize, False))]
        works += cg_run(g, iters, cg_itemsize)
    return works


def two_level_coefficient_cotangent(g: TwoLevel, lanes, itemsize=8) -> List[Work]:
    """The backward's coefficient cotangent -w.K_p u, each part alone."""
    works = []
    for nnz_p in g.nnz_parts:
        works += [stencil(lanes, 1, g.ndof, nnz_p, itemsize, combine=False),
                  vector(lanes, g.ndof, 2, 0, 2, itemsize)]
    return works

"""Batched hex8-box affine stencil matvec: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``vbicm_tpu/ops/stencil3d_pallas.py``).

For a batch of samples s on the (NZ, NY, NX) node grid of a structured hex8
box, ``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]``. The kernel
(``csrc/stencil3d_affine.cu``) reads the operator node-major
(:func:`pack_w_nodes_3d`: per (z, y) row and neighbour row, the 54
coefficients each node uses, from the JAX package's 198 dof-interleaved
planes of :func:`pack_w_interleaved_3d`); the plain version reads the
unpacked block tables W (2, NZ, NY, NX, 3, 3, 3, 3, 3) of ``ops.stencil3d``,
so a fault in the packing cannot hide in both. On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build

_PLANES = 198  # 2 parts x 9 (dz, dy) rows x 11 lane offsets
_GROUP = 20  # a neighbour node's 18 coefficients (2 parts x 3 lanes x 3 dofs), padded
# values a node's coefficients take a neighbour row, by itemsize: the layout
# pack_w_nodes_3d writes, which the kernel reports back (launch_plan_3d checks)
PITCH = {4: 60, 8: 62}


@dataclasses.dataclass(frozen=True)
class Stencil3dPlan:
    """The kernel's tiling for one (B, NZ, NY, NX3): a block per grid row
    and tile of ``groups`` x ``samples`` samples, each thread one node of
    the row and ``samples`` samples; ``threads`` a block, ``blocks`` a
    launch, ``smem_bytes`` of shared memory a block (a ring of staged u rows
    of the tile's samples and the coefficients they meet)."""

    samples: int
    groups: int
    threads: int
    blocks: int
    smem_bytes: int


def plan_tiling_3d(B: int, NZ: int, NY: int, NX3: int, fit) -> Stencil3dPlan:
    """The tiling of a matvec at (B, NZ, NY, NX3).

    ``fit(g)`` is what the built kernel takes for ``g`` sample groups a
    block: (threads a block, shared-memory bytes a block, blocks an SM holds
    at once, samples a thread, ...), or None where it cannot
    (:func:`launch_plan_3d` asks the library). The groups are those that
    keep the most warps at work on an SM: the warps it holds, times the
    share of the tiles' groups that hold a sample; the most groups on a tie,
    as a block reads its coefficients once per tile. tools/stencil_tiles.py
    times every candidate on the card (PERF.md): at 64x16x16 seven groups of
    8 float32 samples (15 warps, one block an SM) are the fastest, at 32x8x8
    three (four blocks of 4 warps) tie with the best. Raises ``ValueError``
    for a grid row too long for one block."""
    if B <= 0 or NZ <= 0 or NY <= 0 or NX3 <= 0 or NX3 % 3:
        raise ValueError(f"launch_plan_3d: B={B}, NZ={NZ}, NY={NY}, NX3={NX3}")
    first = fit(1)
    if first is None:
        raise ValueError(f"a grid row of {NX3} lanes is too long for the 3-D stencil kernel")
    samples = first[3]
    ngroups = -(-B // samples)
    best = None
    for g in range(1, ngroups + 1):
        f = first if g == 1 else fit(g)
        if f is None:  # more groups take more threads and shared memory
            break
        threads, smem, per_sm = f[:3]
        busy = max(1, per_sm) * threads // 32 * ngroups / (-(-ngroups // g) * g)
        if best is None or (busy, g) > best[0]:
            best = ((busy, g), g, threads, smem)
    _, groups, threads, smem = best
    return Stencil3dPlan(samples, groups, threads, NZ * NY * -(-B // (groups * samples)), smem)


_PLANS = {}


def launch_plan_3d(B: int, NZ: int, NY: int, NX3: int, dtype, device) -> Stencil3dPlan:
    """:func:`plan_tiling_3d` with the built kernel's answers on the CUDA
    ``device`` for ``dtype`` (float32 or float64), kept for later calls.
    Raises ``RuntimeError`` if the kernel reads another coefficient pitch
    than :func:`pack_w_nodes_3d` writes."""
    key = (B, NZ, NY, NX3, dtype, device)
    plan = _PLANS.get(key)
    if plan is None:
        fn = _build.entry("stencil3d_affine_fit", dtype)
        with torch.cuda.device(device):
            def fit(g):
                return _build.kernel_fit(fn, 5, NX3, g)

            first = fit(1)
            itemsize = torch.finfo(dtype).bits // 8
            if first is not None and first[4] != PITCH[itemsize]:
                raise RuntimeError(f"the 3-D stencil kernel reads a coefficient pitch of "
                                   f"{first[4]}, pack_w_nodes_3d writes {PITCH[itemsize]}")
            plan = plan_tiling_3d(B, NZ, NY, NX3, fit)
        _PLANS[key] = plan
    return plan


def pack_w_interleaved_3d(W) -> np.ndarray:
    """(2, NZ, NY, NX, 3, 3, 3, 3, 3) block tables -> (NZ*NY, 198, 3NX)
    planes: plane (p*9 + dz*3 + dy)*11 + (delta + 5), lane 3x + a, holds
    W[p, z, y, x, dz, dy, dx, a, b] for the one (dx, b) with
    delta = 3(dx - 1) + b - a. The JAX package's packing without its TPU
    padding (198 -> 200 rows, lanes to a multiple of 128)."""
    W = np.asarray(W)
    P, NZ, NY, NX = W.shape[:4]
    if P != 2:
        raise ValueError(f"the stencil kernel takes 2 affine parts, got {P}")
    wt = np.zeros((NZ * NY, _PLANES, 3 * NX))
    for p in range(P):
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    for a in range(3):
                        for b in range(3):
                            kk = (p * 9 + dz * 3 + dy) * 11 + 3 * (dx - 1) + b - a + 5
                            wt[:, kk, a::3] = W[p, :, :, :, dz, dy, dx, a, b].reshape(NZ * NY, NX)
    return wt


def pack_w_nodes_3d(W, itemsize: int) -> np.ndarray:
    """(2, NZ, NY, NX, 3, 3, 3, 3, 3) block tables -> the kernel's
    node-major (NZ*NY, 9, NX, PITCH[itemsize]) coefficients: entry
    [z*NY + y, dz*3 + dy, x, dx*20 + (p*3 + a)*3 + b] is W[p, z, y, x, dz,
    dy, dx, a, b], the coefficient of node x's dof a on dof b of node
    (x+dx-1, y+dy-1, z+dz-1); the rest is zero padding. The same values as
    plane (p*9 + dz*3 + dy)*11 + 3 dx + b - a + 2 at lane 3x + a of
    :func:`pack_w_interleaved_3d`."""
    W = np.asarray(W)
    P, NZ, NY, NX = W.shape[:4]
    if P != 2:
        raise ValueError(f"the stencil kernel takes 2 affine parts, got {P}")
    groups = np.transpose(W, (1, 2, 4, 5, 3, 6, 0, 7, 8)).reshape(NZ * NY, 9, NX, 3, 18)
    out = np.zeros((NZ * NY, 9, NX, PITCH[itemsize]), dtype=W.dtype)
    for dx in range(3):
        out[..., dx * _GROUP:dx * _GROUP + 18] = groups[..., dx, :]
    return out


def stencil3d_part_reference(Wp, u):
    """``K_p u`` for one part's tables Wp (NZ, NY, NX, 3, 3, 3, 3, 3),
    batched over u (B, 3*NZ*NY*NX): the 27 block offsets as plain PyTorch,
    in u's dtype."""
    NZ, NY, NX = Wp.shape[:3]
    B = u.shape[0]
    up = torch.nn.functional.pad(u.reshape(B, NZ, NY, NX, 3), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                t = torch.einsum("zyxab,szyxb->szyxa", Wp[:, :, :, dz, dy, dx],
                                 up[:, dz:dz + NZ, dy:dy + NY, dx:dx + NX])
                acc = t if acc is None else acc + t
    return acc.reshape(B, -1)


def stencil3d_affine_reference(W, coeffs, u):
    """Plain PyTorch version: ``sum_p c_p K_p u`` on the unpacked tables W
    (2, NZ, NY, NX, 3, 3, 3, 3, 3), batched over u (B, 3*NZ*NY*NX), in u's
    dtype."""
    c = coeffs.to(u.dtype)
    q = None
    for p in range(W.shape[0]):
        qp = c[:, p:p + 1] * stencil3d_part_reference(W[p], u)
        q = qp if q is None else q + qp
    return q


def stencil3d_affine_matvec(W, w_planes, coeffs, u):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    W: (2, NZ, NY, NX, 3, 3, 3, 3, 3) block tables, the plain version's
    operand; w_planes: (NZ*NY, 9, NX, PITCH[itemsize]) node-major
    coefficients (:func:`pack_w_nodes_3d`), the kernel's, 16-byte aligned;
    coeffs (B, 2); u (B, 3*NZ*NY*NX). CPU tensors run
    :func:`stencil3d_affine_reference` on W; CUDA tensors, all float32 or all
    float64, run the kernel on w_planes with :func:`launch_plan_3d`'s
    tiling (every tiling gives the same bits), and W, which may stay on the
    host, gives only the grid's shape. Returns q in u's dtype.

    Counter ``stencil3d_affine.launches`` (``utils.trace``): the kernel's
    launches.
    """
    if u.device.type == "cpu":
        return stencil3d_affine_reference(W, coeffs, u)
    device = _build.check_operands("stencil3d_affine_matvec", ("w_planes", "coeffs", "u"),
                                   (w_planes, coeffs, u), floats=3, align=(16,))
    dtype = u.dtype
    NZ, NY, NX = W.shape[1:4]
    NX3 = 3 * NX
    B = u.shape[0]
    if (tuple(w_planes.shape) != (NZ * NY, 9, NX, PITCH[u.element_size()])
            or coeffs.shape != (B, 2) or u.shape != (B, NZ * NY * NX3)):
        raise ValueError(f"stencil3d_affine_matvec: shapes W {tuple(W.shape)}, w_planes "
                         f"{tuple(w_planes.shape)}, coeffs {tuple(coeffs.shape)}, "
                         f"u {tuple(u.shape)}")
    q = torch.empty_like(u)
    if B > 0:
        plan = launch_plan_3d(B, NZ, NY, NX3, dtype, device)
        _build.launch("stencil3d_affine", dtype, device,
                      (w_planes.data_ptr(), coeffs.data_ptr(), u.data_ptr(), q.data_ptr(),
                       B, NZ, NY, NX3, plan.groups),
                      lambda: f"(B={B}, NZ={NZ}, NY={NY}, NX3={NX3}, {plan}, {dtype})")
    return q

"""Batched structured-grid affine stencil matvec: the CUDA kernel's wrapper
and its plain PyTorch version (counterpart of
``vbicm_tpu/ops/stencil_pallas.py``).

For a batch of samples s on the (NY, NX) node grid of a structured quad4
mesh, ``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]``. The kernel
(``csrc/stencil_affine.cu``) reads the operator as 42 dof-interleaved
coefficient planes (:func:`pack_w_interleaved`); the plain version reads the
unpacked block tables W (2, NY, NX, 3, 3, 2, 2) of ``ops.stencil``, so a
fault in the packing cannot hide in both. On CPU tensors the wrapper runs the
plain version; on CUDA tensors it launches the kernel or raises.

A launch splits the (band of R grid rows, sample) pairs into equal runs, a
block each, and a thread takes one node of one row (:func:`launch_plan`).
``rows_per_block`` forces R (the counterpart of
``stencil_affine_matvec_pallas_mr``'s rows per program); every R and run
gives the same bits. What a block of a tiling takes (threads, shared memory)
and how many of them an SM holds are the built kernel's answers on the card
(``vbicm_stencil_affine_fit_*``), not numbers kept here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build

_ROWS = 3  # rows a band when not forced (at most the rows a block takes at once)
_WAVE = 3  # blocks an SM at most in the one wave a launch aims for
_LONG_RUN = 64  # (band, sample) pairs a block beyond which a lone small block takes two waves


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """The kernel's tiling for one (B, NY, NX2): bands of ``rows`` grid rows
    (the last band the rest), ``rows_at_once`` of them computed at a time
    (sub-bands when fewer than ``rows``), each block a run of ``run``
    consecutive (band, sample) pairs, band-major, each thread one node of
    one row; ``threads`` a block, ``blocks`` a launch, ``smem_bytes`` of
    shared memory a block."""

    rows: int
    rows_at_once: int
    run: int
    threads: int
    blocks: int
    smem_bytes: int


def plan_tiling(B: int, NY: int, NX2: int, fit, sms: int, rows_per_block=None) -> StencilPlan:
    """The tiling of a matvec at (B, NY, NX2) on a card of ``sms`` SMs.

    ``fit(rt)`` is what the built kernel takes to compute ``rt`` rows at
    once: (threads a block, shared-memory bytes a block, blocks an SM holds
    at once), or None where it cannot (:func:`launch_plan` asks the
    library). R = ``rows_per_block`` if given, else ``_ROWS`` as far as a
    block takes them at once, and at most the grid; a block computes as many
    of its rows at once as it takes. The (band, sample) pairs are split into
    equal runs for one wave of at most ``_WAVE`` blocks an SM, as many as an
    SM holds; where a block is alone on its SM with fewer than 8 warps and
    the runs would pass ``_LONG_RUN`` pairs, into two waves.
    tools/stencil_tiles.py times every candidate on the card (PERF.md): at
    160x80 one block an SM (float32, 3 rows a band, 16 warps) is the
    fastest, a second wave costs each block a second pipeline start; in
    float64 (one row, 6 warps a block) two waves beat one at B = 256 (runs
    of 158 pairs) and lose at B = 8 and 16 (runs of 5 and 10). Raises
    ``ValueError`` for a grid row too long for one block."""
    if B <= 0 or NY <= 0 or NX2 <= 0 or NX2 % 2:
        raise ValueError(f"launch_plan: B={B}, NY={NY}, NX2={NX2}")
    if fit(1) is None:
        raise ValueError(f"a grid row of {NX2} lanes is too long for the stencil kernel")

    def most_rows(limit):
        rt = limit
        while rt > 1 and fit(rt) is None:
            rt -= 1
        return rt

    rows = min(_ROWS if rows_per_block is None else rows_per_block, NY)
    if rows_per_block is None:
        rows = most_rows(rows)
    rows_at_once = most_rows(rows)
    threads, smem, per_sm = fit(rows_at_once)
    pairs = -(-NY // rows) * B
    blocks = sms * min(_WAVE, max(1, per_sm))
    if per_sm <= 1 and threads < 256 and pairs > _LONG_RUN * blocks:
        blocks *= 2
    run = -(-pairs // blocks)
    return StencilPlan(rows, rows_at_once, run, threads, -(-pairs // run), smem)


_PLANS = {}


def launch_plan(B: int, NY: int, NX2: int, dtype, device, rows_per_block=None) -> StencilPlan:
    """:func:`plan_tiling` with the built kernel's answers on the CUDA
    ``device`` for ``dtype`` (float32 or float64), kept for later calls."""
    key = (B, NY, NX2, dtype, device, rows_per_block)
    plan = _PLANS.get(key)
    if plan is None:
        fn = _build.entry("stencil_affine_fit", dtype)
        with torch.cuda.device(device):
            plan = plan_tiling(B, NY, NX2, lambda rt: _build.kernel_fit(fn, 3, NX2, rt),
                               torch.cuda.get_device_properties(device).multi_processor_count,
                               rows_per_block)
        _PLANS[key] = plan
    return plan


def pack_w_interleaved(W) -> np.ndarray:
    """(2, NY, NX, 3, 3, 2, 2) block tables -> (NY, 42, 2NX) planes: plane
    (p*3 + dy)*7 + (delta + 3), lane 2x + a, holds the sum over (dx, b) with
    2(dx-1) + b - a = delta of W[p, y, x, dy, dx, a, b]. The JAX package's
    packing without its TPU padding (42 -> 48 rows, lanes to 128)."""
    W = np.asarray(W)
    P, NY, NX = W.shape[:3]
    if P != 2:
        raise ValueError(f"the stencil kernel takes 2 affine parts, got {P}")
    wt = np.zeros((NY, 42, 2 * NX))
    for p in range(P):
        for dy in range(3):
            for dx in range(3):
                for a in range(2):
                    for b in range(2):
                        kk = (p * 3 + dy) * 7 + 2 * (dx - 1) + b - a + 3
                        wt[:, kk, a::2] += W[p, :, :, dy, dx, a, b]
    return wt


def stencil_part_reference(Wp, u):
    """``K_p u`` for one part's tables Wp (NY, NX, 3, 3, 2, 2), batched over
    u (B, 2*NY*NX): the 9 block offsets as plain PyTorch, in u's dtype."""
    NY, NX = Wp.shape[:2]
    B = u.shape[0]
    up = torch.nn.functional.pad(u.reshape(B, NY, NX, 2), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("yxab,syxb->syxa", Wp[:, :, dy, dx], up[:, dy:dy + NY, dx:dx + NX])
            acc = t if acc is None else acc + t
    return acc.reshape(B, -1)


def stencil_affine_reference(W, coeffs, u):
    """Plain PyTorch version: ``sum_p c_p K_p u`` on the unpacked tables W
    (2, NY, NX, 3, 3, 2, 2), batched over u (B, 2*NY*NX), in u's dtype."""
    c = coeffs.to(u.dtype)
    q = None
    for p in range(W.shape[0]):
        qp = c[:, p:p + 1] * stencil_part_reference(W[p], u)
        q = qp if q is None else q + qp
    return q


def stencil_affine_matvec(W, w_planes, coeffs, u, rows_per_block=None):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    W: (2, NY, NX, 3, 3, 2, 2) block tables (the plain version's operand);
    w_planes: (NY, 42, 2NX) packed planes (the kernel's); coeffs (B, 2);
    u (B, 2*NY*NX). CPU tensors run :func:`stencil_affine_reference` on W;
    CUDA tensors, all float32 or all float64, each aligned to two of its
    values, run the kernel on w_planes with :func:`launch_plan`'s tiling,
    ``rows_per_block`` grid rows a block if given (None: the plan's), all
    bitwise equal. Returns q (B, 2*NY*NX) in u's dtype.

    Counters (``utils.trace``): ``stencil_affine.launches``, the launches
    with the plan's rows or one row; ``stencil_affine_rows.launches``, those
    with a forced ``rows_per_block`` > 1.
    """
    if rows_per_block is not None and not (isinstance(rows_per_block, int)
                                           and rows_per_block >= 1):
        raise ValueError(f"rows_per_block must be None or a positive int, got {rows_per_block!r}")
    if u.device.type == "cpu":
        return stencil_affine_reference(W, coeffs, u)
    NY, planes, NX2 = w_planes.shape
    B = u.shape[0]
    if planes != 42 or NX2 % 2 or coeffs.shape != (B, 2) or u.shape != (B, NY * NX2):
        raise ValueError(f"stencil_affine_matvec: shapes w_planes {tuple(w_planes.shape)}, "
                         f"coeffs {tuple(coeffs.shape)}, u {tuple(u.shape)}")
    pair = 2 * u.element_size()
    device = _build.check_operands("stencil_affine_matvec", ("w_planes", "coeffs", "u"),
                                   (w_planes, coeffs, u), floats=3, align=(pair, pair, pair))
    dtype = u.dtype
    q = torch.empty_like(u)
    if B > 0:
        plan = launch_plan(B, NY, NX2, dtype, device, rows_per_block)
        _build.launch("stencil_affine", dtype, device,
                      (w_planes.data_ptr(), coeffs.data_ptr(), u.data_ptr(), q.data_ptr(), B, NY,
                       NX2, plan.rows, plan.rows_at_once, plan.run),
                      lambda: f"(B={B}, NY={NY}, NX2={NX2}, {plan}, {dtype})",
                      None if rows_per_block is None or rows_per_block == 1
                      else "stencil_affine_rows")
    return q

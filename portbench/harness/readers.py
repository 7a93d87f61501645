"""The per-layer metrics' readers, one function a quantity. Each metric file
``metrics/<name>.py`` binds one of them as its ``read(ctx)``; a cell kind's
suffix (``.train``, ``.datagen``) names the same quantity read in another
kind of cell. A reader that finds nothing to read returns None.

``ctx`` is a ``runners.Context``: the profiled stretch's device trace, its
units (train steps, datagen chunks) and their time, their counted work,
the chip's peaks and the CG counts of their solves.
"""
from __future__ import annotations

import numpy as np

from portbench.count.work import least_time_s


def cg_iters(ctx):
    """Mean float32 CG iterations a solve (all its CG runs, the
    refinement's included) over the lanes of the profiled solves, from the
    solver's own counter ``last_cg_iters``."""
    if not ctx.cg_solves:
        return None
    return float(np.mean(np.concatenate([np.sum(runs, axis=0) for runs in ctx.cg_solves])))


def _family_ms(ctx, fam):
    t = ctx.trace.family_s(fam)
    return 1e3 * t / ctx.units if t > 0 and ctx.units else None


def cublas_ms(ctx):
    """Device milliseconds a unit in cuBLAS GEMM and GEMV kernels (the
    two-level preconditioner's hat transfers)."""
    return _family_ms(ctx, "cuBLAS GEMM")


def elementwise_ms(ctx):
    """Device milliseconds a unit in the elementwise family (the CG's
    vector updates; the MLP's and the loss's are a sliver)."""
    return _family_ms(ctx, "elementwise")


def device_idle(ctx):
    """The device's idle share of the profiled stretch: 1 - the union of
    the device operations' intervals over the stretch's wall time."""
    if not ctx.trace.device_ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def launches_per_unit(ctx):
    """Device operations (kernels, copies, sets) a unit launches."""
    if not ctx.trace.device_ops or not ctx.units:
        return None
    return len(ctx.trace.device_ops) / ctx.units


def _roofline(ctx, op, fam):
    t = ctx.trace.family_s(fam)
    if t <= 0 or ctx.peaks is None:
        return None
    return 100.0 * least_time_s(ctx.works, ctx.peaks, op) / t


def stencil_roofline(ctx):
    """The fine-grid operator's share of its roofline: the least time of
    the stencil work the profiled solves needed (count.work, from their CG
    counts) over the stencil kernel's device time."""
    return _roofline(ctx, "stencil", "stencil kernel")


def stencil3d_roofline(ctx):
    """The box's fine-grid operator's share of its roofline: the least time
    of the 3-D stencil work the profiled solves needed (its nonzero
    coefficients, ``fem_box.build_problem``'s ``nnz_parts``) over the 3-D
    stencil kernel's device time."""
    return _roofline(ctx, "stencil", "stencil3d kernel")


def spectral_roofline(ctx):
    """The coarse spectral solve's share of its roofline: the least time of
    the spectral applies the profiled solves needed over the spectral
    kernel's device time (its launches and the split's combine)."""
    return _roofline(ctx, "spectral", "spectral kernel")


def mfu(ctx):
    """The whole unit's share of the chip's peak: the least time of the
    solve work the profiled units counted (every CG iteration's matvec,
    transfers, coarse solve and vector updates, forward and adjoint, and
    the refinements) over the units' time (host clock between two device
    synchronisations, the profiler on). The MLP and the stress recovery are
    left out, so it is a lower bound."""
    if not ctx.works or ctx.peaks is None or not ctx.trace.device_ops or ctx.units_s <= 0:
        return None
    return 100.0 * least_time_s(ctx.works, ctx.peaks) / ctx.units_s

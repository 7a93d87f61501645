"""Spans and counters of the port's layers, for a profiler and for readers.

``span(name)`` labels a stretch of the program for ``torch.profiler``: with
spans on it is ``torch.profiler.record_function(name)``, which the profiler
records on the host and mirrors onto the device's timeline, so the kernels a
span launches can be given to it; with spans off (the default) it is one
shared no-op context after a single flag check. Turn spans on for a block
with ``enabled()``; ``utils.timing.profile_trace`` does so for its block.
``SPANS`` names every span the package opens.

``count(name, n)`` adds to a host integer counter; counters are always on,
never read the device, and are read with ``counters()`` (a snapshot).
Readers take the difference of two snapshots. The package's counters:
``host.sync.datagen_readback`` (``prob/datagen.py``, the chunks' reads),
``pcg.steps.fused`` and ``pcg.steps.plain`` (``ops/solve.py::pcg``, its loop
steps through the CG update kernels or the plain version),
``prec.calls.fused`` and ``prec.calls.plain`` (``ops/multigrid.py``, the
two-level preconditioner's calls through its fused transfer kernels or the
plain composition),
``cg_update.launches`` (``ops/cg_update_kernel.py``, the kernels' launches:
two a fused loop step) and the other kernels' ``<entry>.launches``, counted
by ``_build.launch``: ``spectral_apply`` (applies, one a call),
``stencil_affine`` and ``stencil_affine_rows`` (a forced ``rows_per_block``
> 1), ``stencil3d_affine``, ``element_affine``, ``stencil_mxu``,
``hat_transfer`` (both directions), ``hat_transfer_prec`` (the two-level
preconditioner's fused pair, both directions) and ``fma_probe``.

``by_span``, ``span_idle`` and ``span_table`` give a recorded trace's
kernels and idle gaps to the spans (``tools/profile_scaled_torch.py``).
"""
from __future__ import annotations

import collections
import contextlib
import heapq
import threading

import torch

# every span of the package, from the trainer down to the preconditioner
SPANS = ("train.step", "train.loss", "train.backward", "train.optimizer", "fh",
         "solve.forward", "solve.adjoint", "solve.cotangent", "cg.run", "refine.residual",
         "cg.matvec", "cg.update", "cg.check", "prec", "prec.restrict", "prec.coarse",
         "prec.prolong", "datagen.chunk", "datagen.readback")

_spans_on = False
_OFF = contextlib.nullcontext()
_counts: dict = {}
_lock = threading.Lock()


def span(name: str):
    """A context labelling its block ``name`` for the profiler while spans
    are on; a shared no-op otherwise."""
    if not _spans_on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def enabled(on: bool = True):
    """Spans on (or off) for the block, then back as they were."""
    global _spans_on
    before, _spans_on = _spans_on, on
    try:
        yield
    finally:
        _spans_on = before


def count(name: str, n: int = 1):
    """Add ``n`` (a host integer) to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter."""
    with _lock:
        return dict(_counts)


# ----------------------------------------------------------------------
# attribution of a recorded trace. Host events ("ops") are tuples (name,
# thread, start, end, correlation id, linked correlation id): those named in
# SPANS are the spans, those with a linked id the runtime calls
# (cudaLaunchKernel, ...), the others the operators. Device events
# ("kernels") are (name, start, end, correlation id, linked correlation id).


def _merged(intervals):
    """The union of [start, end) intervals as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    return sum(e - s for s, e in _merged(intervals))


def _innermost(spans, queries):
    """For each query (t, key): the latest-starting span (start, end, id)
    with start < t < end, or None; nested spans make it the innermost."""
    spans = sorted(spans)
    out, heap, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(spans) and spans[i][0] < t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out[key] = heap[0][2] if heap else None
    return out


def _owner(spans, queries):
    """The innermost span around each query (t, thread, key) on the
    query's own thread; where that thread has none open (autograd's device
    thread outside the solves' backward, working for the thread blocked in
    ``backward()``), the innermost open on any thread."""
    by_thread = collections.defaultdict(list)
    for sp in spans:
        by_thread[sp[3]].append(sp[:3])
    qs = collections.defaultdict(list)
    for t, tid, key in queries:
        qs[tid].append((t, key))
    out = {}
    for tid, q in qs.items():
        out.update(_innermost(by_thread.get(tid, []), q))
    stray = [(t, key) for t, _, key in queries if out[key] is None]
    out.update(_innermost([sp[:3] for sp in spans], stray))
    return out


def by_span(ops, kernels, names=SPANS):
    """Each kernel's program span and the path of spans around it.

    A kernel's correlation id gives the runtime call that launched it (its
    start is the launch); its linked id the operator or span that was
    innermost on the launching thread. The kernel belongs to the innermost
    span open around the launch on that thread (:func:`_owner`). Returns,
    for each kernel, the tuple of span names from the outermost to its own
    (empty: none)."""
    spans = [(o[2], o[3], k, o[1]) for k, o in enumerate(ops) if o[0] in names]
    runtime = {o[4]: o for o in ops if o[5]}
    frontend = {o[4]: o for o in ops if not o[5]}
    queries = []
    for k, (_, _, _, corr, linked) in enumerate(kernels):
        call, owner = runtime.get(corr), frontend.get(linked)
        t = call[2] if call is not None else owner[2] if owner is not None else None
        if t is not None:
            queries.append((t, owner[1] if owner is not None else None, k))
    owners = _owner(spans, queries)
    parents = _owner(spans, [(sp[0], sp[3], sp[2]) for sp in spans])
    paths = []
    for k in range(len(kernels)):
        path, s = [], owners.get(k)
        while s is not None:
            path.append(ops[s][0])
            s = parents[s]
        paths.append(tuple(reversed(path)))
    return paths


def span_idle(ops, kernels, names=SPANS):
    """The idle time between kernels (the union of their intervals), summed
    by the innermost span open on any thread at each gap's middle."""
    busy = _merged((k[1], k[2]) for k in kernels)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    spans = [(o[2], o[3], k) for k, o in enumerate(ops) if o[0] in names]
    where = _innermost(spans, [((s + e) / 2, g) for g, (s, e) in enumerate(gaps)])
    out = collections.defaultdict(float)
    for g, (s, e) in enumerate(gaps):
        out[ops[where[g]][0] if where[g] is not None else "(none)"] += e - s
    return dict(out)


def span_table(kernels, paths, steps):
    """(table, layers): device ms and launches a step by span, "self_ms" in
    the span innermost and "total_ms" anywhere inside it ("(none)": in no
    span); and a step's hat transfers (``prec.restrict`` and
    ``prec.prolong``), CG vector work (``cg.update``), device time outside
    every ``solve.*`` span, and the share in no span."""
    per = collections.defaultdict(lambda: [0.0, 0.0, 0])
    outside = 0.0
    for (_, t0, t1, _, _), path in zip(kernels, paths):
        own = per[path[-1] if path else "(none)"]
        own[0] += t1 - t0
        own[2] += 1
        for name in set(path):
            per[name][1] += t1 - t0
        if not any(n.startswith("solve.") for n in path):
            outside += t1 - t0
    per["(none)"][1] = per["(none)"][0]
    ms = lambda us: us / 1e3 / steps  # noqa: E731
    total = sum(v[0] for v in per.values())
    table = {k: {"self_ms": ms(v[0]), "total_ms": ms(v[1]), "launches": v[2] / steps}
             for k, v in sorted(per.items(), key=lambda kv: -kv[1][1])}
    layers = {"transfer_ms": ms(per["prec.restrict"][1] + per["prec.prolong"][1]),
              "cg_vector_ms": ms(per["cg.update"][1]), "outside_solve_ms": ms(outside),
              "no_span_share": per["(none)"][0] / total if total else None}
    return table, layers

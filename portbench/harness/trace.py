"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device operations (kernels, copies, sets) by name and by family,
the device-busy time (the union of their intervals), and the idle gaps
labelled by what the host was doing.

The family table and the busy-interval union are those of the port's
``tools/profile_scaled_torch.py``, copied so that the yardstick stays with
the benchmark. No trace file is written: the events are reduced in memory.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import time
from typing import List, Tuple

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("element kernel", ("element_affine",)),
    ("stencil3d kernel", ("stencil3d_affine_kernel",)),
    ("stencil kernel", ("stencil_affine_kernel",)),
    ("spectral kernel", ("spectral_apply_kernel", "spectral_combine_kernel")),
    ("cuBLAS GEMM", ("gemm", "gemv", "cutlass", "xmma", "Kernel2")),
    ("reduction", ("reduce",)),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "fill")),
    ("copy", ("copy", "Memcpy", "Memset", "memcpy", "memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclasses.dataclass
class Trace:
    """Device operations and host events of one profiled stretch, times in
    microseconds on the profiler's clock; ``window_s`` the host-clock length
    of the stretch, between two device synchronisations."""

    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device_ops]) / 1e6

    def family_s(self, fam: str) -> float:
        return sum(e - s for n, s, e in self.device_ops if family(n) == fam) / 1e6

    def top_ops(self, k=10):
        by = collections.defaultdict(float)
        for n, s, e in self.device_ops:
            by[n[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """The idle time between device operations, summed by the innermost
        host event running at each gap's middle (``python`` where none)."""
        busy = merged([(s, e) for _, s, e in self.device_ops])
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
        host = sorted(self.host_ops, key=lambda ev: ev[1])
        by = collections.defaultdict(float)
        heap, i = [], 0
        for m, length in mids:
            while i < len(host) and host[i][1] <= m:
                heapq.heappush(heap, (-host[i][1], host[i][2], host[i][0]))
                i += 1
            while heap and heap[0][1] <= m:
                heapq.heappop(heap)
            by[heap[0][2] if heap else "python"] += length / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Profiled:
    """``with Profiled(torch, sync, host) as p: ...`` profiles the block
    between two synchronisations; ``p.trace`` is its :class:`Trace` after
    the block. Without ``host`` only the device's activity is recorded: the
    host's events cost it tens of microseconds an operation, which would
    turn a device-bound step host-bound."""

    def __init__(self, torch, sync, host: bool):
        self.torch, self.sync, self.host, self.trace = torch, sync, host, None

    def __enter__(self):
        torch = self.torch
        cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host or not cuda else []
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        dev = self.torch.autograd.DeviceType
        device_ops, host_ops = [], []
        for ev in self.prof.events():
            if ev.device_type == dev.CUDA and not ev.is_user_annotation:
                device_ops.append((ev.name, ev.time_range.start, ev.time_range.end))
            elif ev.device_type == dev.CPU:
                host_ops.append((ev.name, ev.time_range.start, ev.time_range.end))
        self.trace = Trace(device_ops, host_ops, window)
        return False


@contextlib.contextmanager
def span(torch, name: str):
    """A span of the benchmark's own, around a call into a layer."""
    with torch.profiler.record_function(name):
        yield

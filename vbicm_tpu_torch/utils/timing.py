"""Timing helpers with the device's asynchronous semantics (counterpart of
``vbicm_tpu/utils/timing.py``).

PyTorch returns before the GPU finishes, so a host clock without a
synchronise measures the enqueue. ``benchmark_fn`` times CUDA work with CUDA
events after warm-up calls, and CPU work with the host clock.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Any, Callable, Dict, Optional

import torch

from . import trace


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.seconds``.
    With a CUDA ``device`` it synchronises it on entry and exit, so that the
    seconds cover the device work enqueued inside."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self._t0
        return False


def _device_of(args, kwargs) -> torch.device:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def benchmark_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1, repeats: int = 1,
                 device: Optional[torch.device] = None, **kwargs) -> Dict[str, Any]:
    """Steady-state time of ``fn(*args, **kwargs)``: ``warmup`` calls, then
    ``repeats`` runs of ``iters`` calls each; ``mean_s`` is the best run's
    time a call. On a CUDA device (``device``, else the first tensor
    argument's) each run is timed with CUDA events around the launches; on
    the CPU with the host clock."""
    device = torch.device(device) if device is not None else _device_of(args, kwargs)
    cuda = device.type == "cuda"
    for _ in range(max(1, warmup)):
        fn(*args, **kwargs)
    best = float("inf")
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn(*args, **kwargs)
            stop.record()
            torch.cuda.synchronize(device)
            dt = start.elapsed_time(stop) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args, **kwargs)
            dt = (time.perf_counter() - t0) / iters
        best = min(best, dt)
    return {"mean_s": best, "per_sec": 1.0 / best, "iters": iters, "repeats": repeats,
            "device": str(device), "clock": "cuda_events" if cuda else "host"}


def graph_time_s(fn: Callable, reps: int = 20, replays: int = 10) -> float:
    """Device seconds a call of ``fn`` takes on the current CUDA device:
    ``reps`` calls (after three warm-up calls on a side stream) captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so that
    no host time (Python, launches) enters. ``fn`` must be capturable: only
    CUDA work on the current stream, no synchronisation."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / (reps * replays)


@contextlib.contextmanager
def profile_trace(path: Optional[str] = None):
    """``torch.profiler`` over the block (CPU activity, and CUDA when a GPU
    is present), with the program's spans on (``utils.trace``); yields the
    profiler, whose ``events()`` and ``key_averages()`` give the time by
    kernel, and writes a Chrome trace to ``path`` on exit when one is
    given."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, trace.enabled():
        yield prof
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(path)


def card_line() -> str:
    """The first GPU's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``): the line every time on the card
    is kept beside."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]

"""Roofline accounting on the port's device (counterpart of
``vbicm_tpu/utils/roofline.py``).

The peaks are data-sheet values keyed on ``torch.cuda.get_device_name``:
the NVIDIA H100 SXM's HBM rate, its CUDA-core FP32 and FP64 rates and its
dense (no sparsity) tensor-core TF32, BF16 and FP64 rates. The CPU gets a
nominal entry that keeps the fields defined in tests; a share computed
against it is no device metric. The JAX module's ``compiled_costs`` reads
XLA's cost model and has no counterpart here: callers count the flops and
bytes of a call from its shapes.

A share of a peak above 1 cannot happen on the device: it means that the
flops or bytes were over-counted or the time under-measured. ``mfu_fields``
then writes the share as ``None`` with ``<name>_implausible: True`` beside
it, so that an impossible number is never recorded as a result.
"""
from __future__ import annotations

from typing import Optional

import torch

# data-sheet peaks: bytes/s of device memory, flop/s by unit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM
        "hbm_bytes_per_s": 3.35e12,
        "fp32": 67e12,
        "fp64": 34e12,
        "tf32_tc": 494.7e12,
        "bf16_tc": 989.4e12,
        "fp64_tc": 67e12,
    },
    "cpu": {  # nominal, keeps the fields defined off the card
        "hbm_bytes_per_s": 50e9,
        "fp32": 1e12,
        "fp64": 0.5e12,
        "tf32_tc": 1e12,
        "bf16_tc": 1e12,
        "fp64_tc": 0.5e12,
    },
}


def device_peaks(device: Optional[torch.device] = None) -> dict:
    """The peaks of ``device`` (default: CUDA device 0 when there is one,
    else the CPU). Raises ``ValueError`` for a GPU with no entry: a wrong
    peak would make every share wrong."""
    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cpu":
        return PEAKS["cpu"]
    name = torch.cuda.get_device_name(device)
    for key, peaks in PEAKS.items():
        if name.startswith(key):
            return peaks
    raise ValueError(f"no data-sheet peaks for {name!r}; known: {sorted(PEAKS)}")


def least_time_s(nbytes: float, flops: float, unit: str, device=None):
    """``(seconds, bound_by)``: the least time for the work, the larger of
    ``nbytes`` over the memory rate and ``flops`` over the ``unit``'s peak;
    ``bound_by`` is ``"bytes"`` or ``"operations"``."""
    peaks = device_peaks(device)
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = flops / peaks[unit]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share_fields(name: str, value: float) -> dict:
    """``{name: value}``, or ``{name: None, name_implausible: True}`` when
    the share of a peak is above 1."""
    return {name: None, f"{name}_implausible": True} if value > 1.0 else {name: value}


def mfu_fields(flops_per_iter, bytes_per_iter, iters_per_sec, device=None,
               unit: str = "bf16_tc") -> dict:
    """Benchmark fields: achieved TFLOP/s and its share of the ``unit``'s
    peak (``mfu_vs_<unit>``), achieved GB/s and its share of the memory rate
    (``hbm_utilization``). Flops and bytes are the caller's count for one
    iteration; a missing count leaves its fields out. A share above 1 is
    ``None`` with ``<name>_implausible: True``."""
    peaks = device_peaks(device)
    out = {}
    if flops_per_iter:
        achieved = flops_per_iter * iters_per_sec
        out["flops_per_iter"] = float(flops_per_iter)
        out["achieved_tflops"] = achieved / 1e12
        out.update(share_fields(f"mfu_vs_{unit}", achieved / peaks[unit]))
    if bytes_per_iter:
        rate = bytes_per_iter * iters_per_sec
        out["bytes_per_iter"] = float(bytes_per_iter)
        out["achieved_hbm_gbs"] = rate / 1e9
        out.update(share_fields("hbm_utilization", rate / peaks["hbm_bytes_per_s"]))
    return out

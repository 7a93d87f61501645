"""FMA-ceiling probe: the CUDA kernel's wrapper and its plain PyTorch
version (counterpart of ``vpu_peak_kernel`` in
``examples/stencil_kernel_study.py``).

For a (B, NY*XLP) and b (B, XLP), block y of the output is ``f^nfma`` of
a's block y with ``f(v) = v*b + b``: one chain of dependent multiply-adds an
element, with no table reads and no shifted slices. The kernel
(``csrc/fma_probe.cu``) contracts each step to one FMA; the plain version
rounds the product and the sum apart, so the two agree to a few roundings a
step (the chain contracts when |b| < 1). On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build


def fma_probe_flops(B: int, NY: int, XLP: int, nfma: int) -> float:
    """Flops of one probe call: a multiply and an add a step an element."""
    return 2.0 * nfma * B * NY * XLP


def fma_peak_probe_reference(a, b, nfma: int):
    """Plain PyTorch version, in a's dtype."""
    B, XLP = b.shape
    acc = a.reshape(B, -1, XLP)
    bb = b[:, None, :]
    for _ in range(nfma):
        acc = acc * bb + bb
    return acc.reshape(a.shape)


def fma_peak_probe(a, b, nfma: int):
    """``f^nfma`` blockwise (see the module docstring) for a (B, NY*XLP),
    b (B, XLP), both float32 or both float64. CPU tensors run
    :func:`fma_peak_probe_reference`; CUDA tensors the kernel.

    Counter ``fma_probe.launches`` (``utils.trace``): the kernel's
    launches.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return fma_peak_probe_reference(a, b, nfma)
    if b.dim() != 2 or a.dim() != 2 or a.shape[0] != b.shape[0] or a.shape[1] % b.shape[1]:
        raise ValueError(f"fma_peak_probe: shapes a {tuple(a.shape)}, b {tuple(b.shape)}; "
                         "need a (B, NY*XLP) and b (B, XLP)")
    if nfma < 0:
        raise ValueError(f"fma_peak_probe: nfma must be >= 0, got {nfma}")
    device = _build.check_operands("fma_peak_probe", ("a", "b"), (a, b), floats=2)
    B, XLP = b.shape
    NY = a.shape[1] // XLP
    out = torch.empty_like(a)
    if a.numel() > 0:
        _build.launch("fma_probe", a.dtype, device,
                      (a.data_ptr(), b.data_ptr(), out.data_ptr(), B, NY, XLP, nfma),
                      lambda: f"(B={B}, NY={NY}, XLP={XLP}, nfma={nfma}, {a.dtype})")
    return out

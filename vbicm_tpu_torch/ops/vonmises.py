"""The reference's von Mises recovery (counterpart of
``vbicm_tpu/ops/vonmises.py``).

vm = sqrt(0.5 * || P6 @ sig6 ||^2), with P6 the 9-space symmetric deviatoric
projector restricted to rows/columns [s11, s22, s33, s21, s32, s31]. Only one
of each shear pair survives the restriction, so this is not the textbook
sqrt(3 J2); it is the quantity the reference trains and validates on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _pdevs9() -> np.ndarray:
    """9x9 deviatoric projector P = I_sym - (1/3) I (x) I on row-major tensors."""
    eye9 = np.zeros((9, 9))
    for i in range(3):
        for j in range(3):
            r = 3 * i + j
            eye9[r, 3 * i + j] += 0.5
            eye9[r, 3 * j + i] += 0.5
    vol = np.zeros((9, 9))
    for r in (0, 4, 8):
        for c in (0, 4, 8):
            vol[r, c] = 1.0 / 3.0
    return eye9 - vol


_IDX6 = np.array([0, 4, 8, 3, 7, 2])
PDEVS6 = _pdevs9()[np.ix_(_IDX6, _IDX6)]


@functools.lru_cache(maxsize=None)
def _pdevs6(dtype, device) -> torch.Tensor:
    """PDEVS6 on ``device``, made once: a copy from the host at every call
    would synchronise the device with the host (once a step of a sampler)."""
    return torch.as_tensor(PDEVS6, dtype=dtype, device=device)


def von_mises_reference(sig6):
    """Reference-convention von Mises: sqrt(0.5 * sum((PDEVS6 @ sig6)^2)).

    sig6: (..., 6) stress [s11, s22, s33, t12, t23, t31].
    """
    s = sig6 @ _pdevs6(sig6.dtype, sig6.device).T
    return torch.sqrt(0.5 * torch.sum(s * s, dim=-1))

"""Constitutive basis and stress recovery (counterpart of
``vbicm_tpu/ops/element.py``, plane strain and the 3-D solid).

Isotropic elasticity is affine in the Lame parameters, C(E, nu) =
lam * C_LAM + mu * C_MU, so the element stiffness splits into two
theta-independent parts built once at model build. Voigt order
[e11, e22, gamma12] in plane strain, [e11, e22, e33, g12, g23, g31]
(engineering shears) for the solid; stress is stored as
[s11, s22, s33, t12, t23, t31].
"""
from __future__ import annotations

import numpy as np
import torch

C_LAM3 = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
C_MU3 = np.array([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 1.0]])

C_LAM6 = np.zeros((6, 6))
C_LAM6[:3, :3] = 1.0
C_MU6 = np.diag([2.0, 2.0, 2.0, 1.0, 1.0, 1.0])


def lame_from_Ev(E, v):
    """Lame parameters (lam, mu) from Young's modulus / Poisson ratio."""
    lam = v * E / ((1.0 + v) * (1.0 - 2.0 * v))
    mu = 0.5 * E / (1.0 + v)
    return lam, mu


def material_coeffs(stype: int, E, v):
    """Affine coefficients (c0, c1) for K = c0*K_p0 + c1*K_p1: (lam, mu)
    for plane strain (stype 2) and the 3-D solid (stype 4), the sections
    this package builds so far."""
    if stype in (2, 4):
        return lame_from_Ev(E, v)
    raise NotImplementedError(f"stype {stype}")


def stress6_plane_strain(eps3, lam, mu):
    """Full 6-component stress from in-plane strain (plane strain).

    eps3: (..., 3) = [e11, e22, gamma12]; lam, mu broadcast against
    eps3[..., 0]. s33 = lam*(e11+e22) is carried even though e33 = 0.
    """
    e11 = eps3[..., 0]
    e22 = eps3[..., 1]
    g12 = eps3[..., 2]
    tr = e11 + e22
    s11 = lam * tr + 2.0 * mu * e11
    s22 = lam * tr + 2.0 * mu * e22
    s33 = lam * tr
    t12 = mu * g12
    zero = torch.zeros_like(s11)
    return torch.stack([s11, s22, s33, t12, zero, zero], dim=-1)


def stress6_3d(eps6, lam, mu):
    """Full 3-D isotropic stress from the 6-strain (engineering shears):
    s_i = lam*tr(e) + 2*mu*e_i, t_ij = mu*g_ij. lam, mu broadcast against
    eps6[..., 0]."""
    if isinstance(lam, torch.Tensor):
        lam, mu = lam[..., None], mu[..., None]
    tr = (eps6[..., 0] + eps6[..., 1] + eps6[..., 2])[..., None]
    return torch.cat([lam * tr + 2.0 * mu * eps6[..., :3], mu * eps6[..., 3:]], dim=-1)

"""Gauss quadrature tables (counterpart of ``vbicm_tpu/ops/quadrature.py``).

Static NumPy tables used at model build. Point ordering matches the
reference's tables (corner order (-,-),(+,-),(+,+),(-,+)), because the probe
configuration addresses quadrature points by index.
"""
from __future__ import annotations

import numpy as np

_LR = np.array([-1, 1, 1, -1, 0, 1, 0, -1, 0], dtype=np.float64)
_LZ = np.array([-1, -1, 1, 1, -1, 0, 1, 0, 0], dtype=np.float64)
_LW = np.array([25, 25, 25, 25, 40, 40, 40, 40, 64], dtype=np.float64)

_SQTP6 = np.sqrt(0.6)
_SQT13 = 1.0 / np.sqrt(3.0)
_FIVE9 = 5.0 / 9.0
_EIGHT9 = 8.0 / 9.0


def gauss1d(order: int):
    """1-D Gauss-Legendre points/weights on [-1, 1], orders 1..5."""
    if not 1 <= order <= 5:
        raise ValueError(f"illegal 1-D quadrature order {order}")
    pts, wts = np.polynomial.legendre.leggauss(order)
    return pts.astype(np.float64), wts.astype(np.float64)


def int2d(order: int):
    """2-D quadrature for quads; returns (points (lint,2), weights (lint,)).

    Orders 1..5 are tensor Gauss rules; order 0 is the 5-point special rule.
    """
    if order == 0:
        g = _SQTP6
        pts = np.stack([g * _LR[:4], g * _LZ[:4]], axis=1)
        pts = np.concatenate([pts, np.zeros((1, 2))], axis=0)
        wts = np.concatenate([np.full(4, _FIVE9), [2.8 * _EIGHT9]])
        return pts, wts
    if order == 1:
        return np.zeros((1, 2)), np.array([4.0])
    if order == 2:
        g = _SQT13
        pts = np.stack([g * _LR[:4], g * _LZ[:4]], axis=1)
        return pts, np.ones(4)
    if order == 3:
        g = _SQTP6
        pts = np.stack([g * _LR, g * _LZ], axis=1)
        return pts, _LW / 81.0
    if order in (4, 5):
        # the reference fills x fastest within y, each 1-D axis DESCENDING;
        # leggauss is ascending, so reverse to keep index-addressed probes on
        # the same physical points
        p1, w1 = gauss1d(order)
        p1, w1 = p1[::-1], w1[::-1]
        P = np.array([[p1[k], p1[j]] for j in range(order) for k in range(order)])
        W = np.array([w1[j] * w1[k] for j in range(order) for k in range(order)])
        return P, W
    raise ValueError(f"illegal 2-D quadrature order {order}")


def int3d(order: int):
    """3-D quadrature for hexes; returns (points (lint,3), weights (lint,)).

    Orders 1..5 are tensor Gauss rules (x fastest, ascending). The negative
    orders are the reference's special rules: ``-9``, 8 points at
    (+-g, +-g, +-g), g = sqrt(0.6), weight 5/9 each, plus the centroid at
    weight 30/29; ``-4``, the 4-point degree-2 rule on alternating corners
    scaled by 1/sqrt(3), weight 2 each.
    """
    if order == -9:
        g = _SQTP6
        corners = np.stack([g * _LR[:4], g * _LZ[:4], np.full(4, g)], axis=1)
        P = np.concatenate([corners, corners * np.array([1.0, 1.0, -1.0]), np.zeros((1, 3))],
                           axis=0)
        W = np.concatenate([np.full(8, _FIVE9), [30.0 / 29.0]])
        return P, W
    if order == -4:
        g = _SQT13
        P = g * np.array([[-1, -1, -1], [1, 1, -1], [1, -1, 1], [-1, 1, 1]], dtype=np.float64)
        return P, np.full(4, 2.0)
    if not 1 <= order <= 5:
        raise ValueError(f"illegal 3-D quadrature order {order}")
    p1, w1 = gauss1d(order)
    P = np.array([[p1[k], p1[j], p1[i]]
                  for i in range(order) for j in range(order) for k in range(order)])
    W = np.array([w1[i] * w1[j] * w1[k]
                  for i in range(order) for j in range(order) for k in range(order)])
    return P, W


def quadr2d(intp: int, nel: int):
    """Rule dispatch mirroring the reference's ``quadr2d``."""
    order = min(5, intp)
    if order == 0:
        order = 2 if nel == 4 else (3 if nel <= 9 else 4)
    return int2d(order)

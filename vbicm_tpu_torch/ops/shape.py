"""Element shape-function constants (counterpart of ``vbicm_tpu/ops/shape.py``,
hex8 only).

Corner signs of the trilinear 8-node hexahedron, bottom quad CCW then top
quad CCW: (-,-,-), (+,-,-), (+,+,-), (-,+,-), (-,-,+), (+,-,+), (+,+,+),
(-,+,+). N_i = (1 + xi_i xi)(1 + eta_i eta)(1 + zeta_i zeta) / 8.
"""
import numpy as np

_HEX_XI = np.array([-1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0])
_HEX_ETA = np.array([-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0])
_HEX_ZETA = np.array([-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0])


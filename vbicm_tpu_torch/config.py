"""Configuration dataclasses (counterpart of ``vbicm_tpu/config.py``).

Same fields and defaults as the JAX package, so a configuration written for
one package means the same thing in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MaterialCard:
    """Isotropic elastic material."""

    E: float = 20.0
    v: float = 0.3
    mat_type: int = 1  # 1 = elastic isotropic

    @property
    def lam(self) -> float:
        return self.v * self.E / ((1.0 + self.v) * (1.0 - 2.0 * self.v))

    @property
    def mu(self) -> float:
        return 0.5 * self.E / (1.0 + self.v)


@dataclasses.dataclass(frozen=True)
class SectionCard:
    """Element section. stype: 1 = plane stress, 2 = plane strain, 3 =
    axisymmetric, 4 = the 3-D solid (hex8 meshes; ``thk`` unused). etype:
    1 = quadrilateral (2-D). This package builds stype 2 (quad4) and 4."""

    intp: int = 2  # Gauss order per direction (2 -> 2x2 rule)
    thk: float = 10.0
    etype: int = 1
    stype: int = 2
    eform: int = 1


@dataclasses.dataclass(frozen=True)
class ThetaMap:
    """theta -> (E, nu):

        E  = exp(theta_std[0] * t0 + theta_mean[0])
        nu = 0.5 * sigmoid(theta_std[1] * t1 + theta_mean[1])
    """

    theta_mean: Tuple[float, float] = (float(np.log(20.0)), 0.0)
    theta_std: Tuple[float, float] = (0.1, 0.015)


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Observation / probe configuration.

    y = nodal displacement (ux, uy) at ``node_id`` (1-based), h = reference-
    convention von Mises stress at element ``ele_id`` (1-based), quadrature
    points ``nipt_id`` (1-based). ``sig_e`` / ``sig_eta`` are noise
    *variances*.
    """

    y_dim: int = 2
    theta_dim: int = 2
    z_dim: int = 2
    sig_e: float = 1.0e-1
    sig_eta: float = 3.0e-3
    node_id: int = 231
    ele_id: int = 12
    nipt_id: Tuple[int, ...] = (1, 3)
    theta_map: ThetaMap = dataclasses.field(default_factory=ThetaMap)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Two-step VI training hyperparameters.

    ``pairing``: "cross" scores every y of a batch against every posterior
    sample of the batch (the reference's broadcast); "per_sample" scores
    each y against its own samples only. ``lr_decay_mode``: "reference"
    reproduces the reference's check of a not-yet-written history slot (it
    fires iff the loss ``lr_patience`` epochs ago was negative); "fixed"
    decays when the loss rose over the window.

    ``scan_epochs`` and ``scan_chunk`` change how the JAX package dispatches
    an epoch, not its update sequence; this package runs a Python loop for
    either value. With ``ckpt_chunk`` they set, as there, how often a bundle
    is written inside an epoch: every ``scan_chunk`` batches (when
    ``scan_epochs`` and the epoch has more than one full batch).
    ``ckpt_every`` > 0 writes checkpoints every that many epochs (else
    ``num_epochs // 5``); ``clip_grad_norm`` clips the gradients' global
    norm before Adam; ``resample_e`` draws fresh base draws for every batch
    instead of the dataset's fixed ``e_data``; ``posterior`` is
    "meanfield", "fullcov" or "flow" (``flow_couplings`` coupling layers,
    scales bounded by ``flow_s_cap``).
    """

    num_neuron: int = 20
    num_layers1: int = 3
    num_layers2: int = 3
    alpha: float = 1.0e-7
    lr: float = 1.0e-3
    flg_lr_decay: bool = True
    lr_patience: int = 5
    decay_rate: float = 0.9
    batch_size: int = 64
    num_epoch1: int = 200
    num_epoch2: int = 200
    pairing: str = "cross"
    lr_decay_mode: str = "reference"
    seed: int = 0
    scan_epochs: bool = True
    scan_chunk: int = 0
    ckpt_every: int = 0
    ckpt_chunk: bool = False
    clip_grad_norm: float | None = None
    resample_e: bool = False
    posterior: str = "meanfield"
    flow_couplings: int = 4
    flow_s_cap: float = 3.0

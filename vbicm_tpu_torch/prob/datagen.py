"""Dataset generation for the FEM inverse problem (counterpart of
``vbicm_tpu/prob/datagen.py``).

Draw theta ~ N(0, I), push the batch through the batched observation
operator in chunks, add measurement and prediction noise, and draw the fixed
reparameterization seeds ``e_data``. Random numbers come from a CPU
``torch.Generator``, so a seed gives the same dataset on every device. The
HDF5 save and load are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class MeasurementDataset:
    y_data: np.ndarray  # (n_sam, d_y)
    z_data: np.ndarray  # (n_sam, d_z)
    log_z_data: np.ndarray  # (n_sam, d_z)
    e_data: np.ndarray  # (ne_sam, d_theta) fixed reparameterization seeds
    y_mean: np.ndarray  # (1, d_y)
    y_std: np.ndarray
    z_mean: np.ndarray
    z_std: np.ndarray
    theta_data: Optional[np.ndarray] = None  # (n_sam, d_theta) latent truth

    @property
    def n_sam(self) -> int:
        return int(self.y_data.shape[0])

    @property
    def ne_sam(self) -> int:
        return int(self.e_data.shape[0])


def standardize(x, mean, std):
    """(x - mean) / std (reference ``standardize_data``)."""
    return (x - mean) / std


def generate_data_fem(
    generator: torch.Generator,
    batch_fh: Callable,
    *,
    n_sam: int,
    ne_sam: int,
    device,
    d_y: int = 2,
    d_z: int = 2,
    d_theta: int = 2,
    sig_e: float = 1e-1,
    sig_eta: float = 3e-3,
    chunk: Optional[int] = None,
    dtype=torch.float64,
) -> MeasurementDataset:
    """Generate the (y, z) dataset through the batched FEM map.

    batch_fh: ``thetas (B, d_theta) -> (y (B, d_y), h (B, d_z))`` on
    ``device``; ``chunk`` bounds the batch of one call.
    """
    theta = torch.randn((n_sam, d_theta), generator=generator, dtype=dtype)
    err = math.sqrt(sig_e) * torch.randn((n_sam, d_y), generator=generator, dtype=dtype)
    eta = math.sqrt(sig_eta) * torch.randn((n_sam, d_z), generator=generator, dtype=dtype)
    e_data = torch.randn((ne_sam, d_theta), generator=generator, dtype=dtype)

    step = n_sam if chunk is None else chunk
    fs, hs = [], []
    with torch.no_grad():
        for i in range(0, n_sam, step):
            f_i, h_i = batch_fh(theta[i : i + step].to(device))
            fs.append(f_i.cpu())
            hs.append(h_i.cpu())
    y = (torch.cat(fs) + err).numpy()
    z = (torch.cat(hs) + eta).numpy()
    if (z <= 0.0).any():
        # z = h + eta goes nonpositive when the noise rivals the stress
        # signal; log(z) would store NaNs, so clamp and say so
        nbad = int((z <= 0.0).sum())
        floor = float(z[z > 0.0].min()) if (z > 0.0).any() else 1e-12
        warnings.warn(
            f"{nbad} z samples were nonpositive after adding noise "
            f"(sig_eta={sig_eta}); clamped to {floor:.3e} before log"
        )
        z = np.where(z > 0.0, z, floor)

    return MeasurementDataset(
        y_data=y,
        z_data=z,
        log_z_data=np.log(z),
        e_data=e_data.numpy(),
        y_mean=y.mean(axis=0, keepdims=True),
        y_std=y.std(axis=0, keepdims=True),
        z_mean=z.mean(axis=0, keepdims=True),
        z_std=z.std(axis=0, keepdims=True),
        theta_data=theta.numpy(),
    )

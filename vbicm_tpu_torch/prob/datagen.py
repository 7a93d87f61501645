"""Dataset generation for the FEM inverse problem (counterpart of
``vbicm_tpu/prob/datagen.py``).

Draw theta ~ N(0, I), push the batch through the batched observation
operator in chunks, add measurement and prediction noise, and draw the fixed
reparameterization seeds ``e_data``. Random numbers come from a CPU
``torch.Generator``, so a seed gives the same dataset on every device.

Dataset files: HDF5 in the reference's field layout (needs ``h5py``, imported
when a file is read or written), or a ``.npz`` of the same fields, which
needs no package beyond numpy; the path's suffix picks the form.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.trace import count, span


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
    ``device``; ``chunk`` bounds the batch of one call. Spans
    (``utils.trace``): ``datagen.chunk`` a chunk, holding
    ``datagen.readback``, its two reads to the host.
    """
    theta = torch.randn((n_sam, d_theta), generator=generator, dtype=dtype)
    err = math.sqrt(sig_e) * torch.randn((n_sam, d_y), generator=generator, dtype=dtype)
    eta = math.sqrt(sig_eta) * torch.randn((n_sam, d_z), generator=generator, dtype=dtype)
    e_data = torch.randn((ne_sam, d_theta), generator=generator, dtype=dtype)

    step = n_sam if chunk is None else chunk
    fs, hs = [], []
    with torch.no_grad():
        for i in range(0, n_sam, step):
            with span("datagen.chunk"):
                f_i, h_i = batch_fh(theta[i : i + step].to(device))
                count("host.sync.datagen_readback", 2)
                with span("datagen.readback"):
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


_FIELDS = ("y_data", "z_data", "log_z_data", "e_data", "y_mean", "y_std", "z_mean", "z_std")


def _is_npz(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".npz"


def _h5py():
    try:
        import h5py
    except ImportError as ex:
        raise ImportError("an HDF5 dataset file needs the h5py package; without it, use a "
                          "'.npz' path") from ex
    return h5py


def save_dataset(ds: MeasurementDataset, path: str) -> None:
    """Write ``ds``: a ``.npz`` path gets its fields as numpy arrays, any
    other path the reference's HDF5 field layout (``y_scaled_data`` and
    ``z_scaled_data`` hold the raw data, as the reference writes them)."""
    fields = {k: getattr(ds, k) for k in _FIELDS}
    if ds.theta_data is not None:
        fields["theta_data"] = ds.theta_data
    if _is_npz(path):
        np.savez(path, **fields)
        return
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f[k] = v
        f["y_scaled_data"] = ds.y_data  # reference quirk: raw, not scaled
        f["z_scaled_data"] = ds.z_data  # reference quirk


def load_dataset(path: str) -> MeasurementDataset:
    """Read a dataset written by :func:`save_dataset`, by the JAX package's
    or by the reference. A MATLAB-format HDF5 file (the reference's
    ``hdf5storage``) marks each dataset with a ``MATLAB_class`` attribute and
    stores it transposed; such 2-D datasets are transposed back."""
    if _is_npz(path):
        with np.load(path, allow_pickle=False) as z:
            fields = {k: z[k] for k in z.files}
        if "log_z_data" not in fields:
            fields["log_z_data"] = np.log(fields["z_data"])
        return MeasurementDataset(**{k: fields[k] for k in _FIELDS},
                                  theta_data=fields.get("theta_data"))
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        def get(k):
            d = f[k]
            a = np.asarray(d)
            if a.ndim == 2 and "MATLAB_class" in d.attrs:
                a = a.T
            return a

        y = get("y_data")
        z = get("z_data")
        return MeasurementDataset(
            y_data=y,
            z_data=z,
            log_z_data=get("log_z_data") if "log_z_data" in f else np.log(z),
            e_data=get("e_data"),
            y_mean=np.asarray(f["y_mean"]).reshape(1, -1),
            y_std=np.asarray(f["y_std"]).reshape(1, -1),
            z_mean=np.asarray(f["z_mean"]).reshape(1, -1),
            z_std=np.asarray(f["z_std"]).reshape(1, -1),
            theta_data=get("theta_data") if "theta_data" in f else None,
        )


def cached_dataset(path: str, key: dict, make: Callable[[], MeasurementDataset], *,
                   reuse: bool):
    """A dataset cache for examples that resume: with ``reuse`` and a file at
    ``path`` (a ``.npz``) written for the same ``key`` (e.g. the seed, the
    sizes and the mesh), its dataset; else ``make()``'s, written to ``path``
    with ``key``. Returns (dataset, whether it was read from the file)."""
    key_s = json.dumps(key, sort_keys=True)
    if reuse and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            cached_key = str(z["cache_key"]) if "cache_key" in z.files else None
        if cached_key == key_s:
            return load_dataset(path), True
        print(f"{path} was written for {cached_key}, not {key_s}; generating anew")
    ds = make()
    fields = {k: getattr(ds, k) for k in _FIELDS}
    if ds.theta_data is not None:
        fields["theta_data"] = ds.theta_data
    np.savez(path, cache_key=np.array(key_s), **fields)
    return ds, False

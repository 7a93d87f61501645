"""The port's FEAP mesh reader and writer and its dataset files against the
JAX package's (CPU): every mesh fixture parsed alike, each package's mesh
file read back by the other, HDF5 datasets both ways bitwise, the ``.npz``
form and the reference's MATLAB-transposed layout."""
import dataclasses
import glob
import os
import sys

import h5py
import numpy as np
import pytest

from vbicm_tpu.mesh.feap import read_feap_mesh as jax_read_feap_mesh
from vbicm_tpu.mesh.feap import write_feap_mesh as jax_write_feap_mesh
from vbicm_tpu.prob.datagen import MeasurementDataset as JaxMeasurementDataset
from vbicm_tpu.prob.datagen import load_dataset as jax_load_dataset
from vbicm_tpu.prob.datagen import save_dataset as jax_save_dataset
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
from vbicm_tpu_torch.mesh.feap import read_feap_mesh, write_feap_mesh
from vbicm_tpu_torch.prob.datagen import MeasurementDataset, load_dataset, save_dataset

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "cooksm_*.txt")))
MESH_FIELDS = ("coords", "conn", "bc_nodes", "bc_flags", "load_nodes", "load_vals",
               "disp_nodes", "disp_vals")
DATA_FIELDS = ("y_data", "z_data", "log_z_data", "e_data", "y_mean", "y_std", "z_mean",
               "z_std", "theta_data")


def _assert_meshes_equal(a, b):
    for k in MESH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("space_dim", "max_node_dof", "max_ele_node"):
        assert getattr(a, k) == getattr(b, k), k


def test_every_feap_fixture_parses_as_in_jax():
    assert len(FIXTURES) >= 5
    for path in FIXTURES:
        _assert_meshes_equal(read_feap_mesh(path), jax_read_feap_mesh(path))


@pytest.mark.parametrize("mesh_name", ["fixtures", "cooks_20x10", "hex8_4x2x2"])
def test_feap_files_cross_read_losslessly(tmp_path, mesh_name):
    """The port's file read by JAX's reader gives the mesh back exactly (17
    significant digits); JAX's file (16 digits, within 1e-15 of the mesh)
    reads in the port exactly as in JAX."""
    if mesh_name == "fixtures":
        meshes = [read_feap_mesh(p) for p in FIXTURES]
    elif mesh_name == "cooks_20x10":
        meshes = [cooks_membrane_mesh(20, 10)]
    else:
        meshes = [beam_hex8_mesh(4, 2, 2, tip_force=(0.0, 0.0, -0.02))]
    for k, mesh in enumerate(meshes):
        ours, theirs = tmp_path / f"port_{k}.txt", tmp_path / f"jax_{k}.txt"
        write_feap_mesh(str(ours), mesh)
        jax_write_feap_mesh(str(theirs), mesh)
        _assert_meshes_equal(jax_read_feap_mesh(str(ours)), mesh)
        _assert_meshes_equal(read_feap_mesh(str(ours)), mesh)
        from_jax = read_feap_mesh(str(theirs))
        _assert_meshes_equal(from_jax, jax_read_feap_mesh(str(theirs)))
        for field in ("coords", "load_vals", "disp_vals"):
            np.testing.assert_allclose(getattr(from_jax, field), getattr(mesh, field), rtol=1e-15)


def test_feap_reader_rejects_unknown_sections(tmp_path):
    path = tmp_path / "bad.txt"
    write_feap_mesh(str(path), cooks_membrane_mesh(4, 2))
    with open(path, "a") as f:
        f.write("PRESsure conditions\n1 0 1.0\n")
    with pytest.raises(ValueError, match="unknown section"):
        read_feap_mesh(str(path))


def _dataset(cls, with_theta=True):
    rng = np.random.default_rng(4)
    y, z = rng.normal(size=(7, 2)), np.exp(rng.normal(size=(7, 2)))
    return cls(y_data=y, z_data=z, log_z_data=np.log(z), e_data=rng.normal(size=(4, 2)),
               y_mean=y.mean(0, keepdims=True), y_std=y.std(0, keepdims=True),
               z_mean=z.mean(0, keepdims=True), z_std=z.std(0, keepdims=True),
               theta_data=rng.normal(size=(7, 2)) if with_theta else None)


def _assert_datasets_equal(a, b):
    for k in DATA_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert x.shape == y.shape and np.array_equal(x, y), k


def test_jax_hdf5_dataset_loads_bitwise_in_the_port(tmp_path):
    path = str(tmp_path / "jax.h5")
    ds = _dataset(JaxMeasurementDataset)
    jax_save_dataset(ds, path)
    _assert_datasets_equal(load_dataset(path), ds)


@pytest.mark.parametrize("with_theta", [True, False])
def test_port_hdf5_dataset_loads_bitwise_in_jax(tmp_path, with_theta):
    path = str(tmp_path / "port.h5")
    ds = _dataset(MeasurementDataset, with_theta)
    save_dataset(ds, path)
    _assert_datasets_equal(jax_load_dataset(path), ds)
    with h5py.File(path, "r") as f:  # the reference's quirk: raw data under "scaled"
        assert np.array_equal(f["y_scaled_data"], ds.y_data)
        assert np.array_equal(f["z_scaled_data"], ds.z_data)


@pytest.mark.parametrize("with_theta", [True, False])
def test_npz_dataset_round_trip(tmp_path, with_theta):
    path = str(tmp_path / "data.npz")
    ds = _dataset(MeasurementDataset, with_theta)
    save_dataset(ds, path)
    _assert_datasets_equal(load_dataset(path), ds)


def test_matlab_transposed_hdf5_is_read_back(tmp_path):
    """A file in the reference's hdf5storage layout: 2-D datasets stored
    transposed with a ``MATLAB_class`` attribute, no ``log_z_data``."""
    path = str(tmp_path / "matlab.h5")
    ds = _dataset(MeasurementDataset)
    with h5py.File(path, "w") as f:
        for k in ("y_data", "z_data", "e_data", "theta_data"):
            f[k] = getattr(ds, k).T
            f[k].attrs["MATLAB_class"] = np.bytes_("double")
        for k in ("y_mean", "y_std", "z_mean", "z_std"):
            f[k] = getattr(ds, k).ravel()
            f[k].attrs["MATLAB_class"] = np.bytes_("double")
    got = load_dataset(path)
    _assert_datasets_equal(got, dataclasses.replace(ds, log_z_data=np.log(ds.z_data)))
    _assert_datasets_equal(jax_load_dataset(path), got)


def test_hdf5_path_without_h5py_names_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises
    ds = _dataset(MeasurementDataset)
    with pytest.raises(ImportError, match="h5py"):
        save_dataset(ds, str(tmp_path / "x.h5"))
    with pytest.raises(ImportError, match="h5py"):
        load_dataset(str(tmp_path / "x.h5"))
    save_dataset(ds, str(tmp_path / "x.npz"))  # the .npz form needs no h5py
    _assert_datasets_equal(load_dataset(str(tmp_path / "x.npz")), ds)


def test_dataset_cache_is_keyed(tmp_path):
    """The examples' dataset cache is reused only for the key it was made
    for (the seed, sizes and mesh), and only when asked."""
    from vbicm_tpu_torch.prob.datagen import cached_dataset

    path = str(tmp_path / "cache.npz")
    made = []

    def make(seed):
        made.append(seed)
        return dataclasses.replace(_dataset(MeasurementDataset), theta_data=np.full((7, 2), seed))

    key = {"seed": 0, "n_data": 7, "ne_sam": 4, "mesh": "20x10"}
    ds, cached = cached_dataset(path, key, lambda: make(0), reuse=True)
    assert not cached and made == [0]
    again, cached = cached_dataset(path, dict(key), lambda: make(1), reuse=True)
    assert cached and made == [0]
    _assert_datasets_equal(again, ds)
    _, cached = cached_dataset(path, key, lambda: make(2), reuse=False)
    assert not cached and made == [0, 2]
    other, cached = cached_dataset(path, {**key, "mesh": "40x20"}, lambda: make(3), reuse=True)
    assert not cached and made == [0, 2, 3] and np.all(other.theta_data == 3)

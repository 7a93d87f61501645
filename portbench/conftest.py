"""Fixtures of the benchmark's CPU tests: the ``chip`` marker, and a copy of
the benchmark whose cells are cut to a size the CPU runs in seconds.

    python -m pytest portbench -q
"""
import copy
import json
import os
import shutil

import pytest

from portbench.harness import manifest

TINY_MESH = {"cooks_160x80": {"nx": 16, "ny": 8}, "box_32x8x8": {"nx": 4, "ny": 2, "nz": 2}}
TINY_TRAFFIC = {"train": dict(batch=8, ne=2, data_chunk=32, trace_max_units=1,
                               window_checks=[2, 6]),
                "datagen": dict(n_sam=64, chunk=16, trace_max_units=1)}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skipped without one")


@pytest.fixture
def chip():
    """Skips the test where there is no CUDA device (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# a window long enough on the CPU for the checked steps of a tiny train cell
# (6 steps) with other tests sharing the cores, by the traffic's kind or the
# cell's name (the box's plain 3-D stencil makes its tiny steps some three
# times as long as Cook's)
TINY_SECONDS = {"train": 5.0, "datagen": 0.5, "box32x8x8.train": 12.0}


def tiny_seconds(cell) -> float:
    return TINY_SECONDS.get(cell.name, TINY_SECONDS[cell.traffic["kind"]])


def tiny_config(config: dict, mesh: dict = None) -> dict:
    """``config`` on its tiny mesh (or on ``mesh``), its probes moved to the
    same places: Cook's top right corner and an element of the middle row;
    the box's tip corner and its root element's top fiber."""
    out = copy.deepcopy(config)
    mesh = mesh or TINY_MESH[config["name"]]
    out["mesh"].update(mesh)
    m = out["mesh"]
    nx, ny = m["nx"], m["ny"]
    probe = out["probe"]
    if "nz" in m:
        nz = m["nz"]
        probe.update(node_id=(nx + 1) * (ny + 1) * (nz + 1),
                     ele_id=((nz - 1) * ny + ny // 2) * nx + 2)
    else:
        probe.update(node_id=(nx + 1) * (ny + 1), ele_id=(ny // 2) * nx + 3)
    out["n_data"] = 64
    return out


@pytest.fixture
def tiny_bench(tmp_path):
    """(root, bench_dir) of a copy of the benchmark with its configurations
    and traffic cut to CPU size; limits, metrics and entries as they are."""
    bench_dir = tmp_path / "portbench"
    for sub in ("traffic", "workloads", "metrics", "configs"):
        shutil.copytree(os.path.join(manifest.BENCH_DIR, sub), bench_dir / sub)
    for path in (bench_dir / "configs").iterdir():
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (bench_dir / "traffic").iterdir():
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC[tr["kind"]])
        path.write_text(json.dumps(tr))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    return str(tmp_path), str(bench_dir)

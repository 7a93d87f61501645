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

TINY_MESH = {"cooks_160x80": {"nx": 16, "ny": 8}}
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
TINY_SECONDS = {"train": 2.5, "datagen": 0.5}


def tiny_config(config: dict) -> dict:
    out = copy.deepcopy(config)
    mesh = TINY_MESH[config["name"]]
    nx, ny = mesh["nx"], mesh["ny"]
    out["mesh"] = mesh
    out["probe"] = {"node_id": (nx + 1) * (ny + 1), "ele_id": (ny // 2) * nx + 3,
                    "nipt_id": config["probe"]["nipt_id"]}
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

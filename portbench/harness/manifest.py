"""Discovery by name: everything a run needs is found from ``BENCHMARK.json``
and files named after its entries.

- ``configs/<config>.json``: a configuration (the FEM problem, its solver,
  its trainer), as the cell runs it;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of one of the
  generators of ``harness.runners`` (its ``kind``);
- ``workloads/<cell>.json``: what belongs to one cell alone, the limits of
  its comparison and the readings they were set from;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

A cell, a configuration, a traffic mix or a metric is added by adding its
files and its entry, with no edit to a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, limits and metrics; ``KeyError`` for an unknown cell."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    cell_file = os.path.join(bench_dir, "workloads", name + ".json")
    limits = _load_json(cell_file)["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, ctx, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds, with its
    unit; a reader that returns None leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = metric_reader(m["name"], bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

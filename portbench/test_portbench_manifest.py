"""The manifest against the benchmark's contract, and discovery by name: a
cell, a traffic mix or a metric added as files and entries is found without
an edit to a file that is there."""
import json
import math
import os
import re

import pytest

from portbench.harness import manifest, runners

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_names_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(manifest.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    assert len({c["source"] for c in b["configs"]}) == len(b["configs"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == cells
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    assert next(m for m in b["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and _line(m["layer"])
        moves = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in moves or cell in moves["workloads"]
        assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_and_reports(cell):
    c = manifest.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert c.traffic["kind"] in runners.RUNNERS
    assert c.limits and all(v is None or (v > 0 and math.isfinite(v))
                            for v in c.limits.values())
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))


def test_an_added_cell_traffic_and_metric_are_found(tiny_bench):
    root, bench_dir = tiny_bench
    bench = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "cooks160x80.datagen_small", "config": "cooks_160x80",
                               "traffic": "datagen_small", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "solves_a_unit.datagen", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "added", "moves": "fh_solves_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "fh_solves_per_s":
            m["workloads"].append("cooks160x80.datagen_small")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(bench_dir, "traffic", "datagen_small.json"), "w") as f:
        json.dump({"kind": "datagen", "n_sam": 32, "chunk": 16, "ne": 2, "checked_chunks": 1,
                   "trace_seconds": 0.0, "trace_max_units": 1}, f)
    with open(os.path.join(bench_dir, "workloads", "cooks160x80.datagen_small.json"), "w") as f:
        json.dump({"limits": {"y_gap": 1e-6, "h_gap": 1e-6}}, f)
    with open(os.path.join(bench_dir, "metrics", "solves_a_unit.datagen.py"), "w") as f:
        f.write("def read(ctx):\n    return 16.0\n")
    cell = manifest.load_cell("cooks160x80.datagen_small", root=root, bench_dir=bench_dir)
    assert cell.traffic["n_sam"] == 32 and cell.config["mesh"] == {"nx": 16, "ny": 8}
    assert [m["name"] for m in cell.per_layer] == ["solves_a_unit.datagen"]
    assert {m["name"] for m in cell.end_to_end} == {"fh_solves_per_s", "setup_s"}
    got = manifest.read_metrics(cell, None, bench_dir=bench_dir)
    assert got == {"solves_a_unit.datagen": {"value": 16.0, "unit": "solves"}}
    with pytest.raises(KeyError):
        manifest.load_cell("no.such.cell", root=root, bench_dir=bench_dir)


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tiny_bench):
    from portbench.harness.trace import Trace

    root, bench_dir = tiny_bench
    cell = manifest.load_cell("cooks160x80.train", root=root, bench_dir=bench_dir)
    ctx = runners.Context(trace=Trace([], [], 1.0), units=3, units_s=1.0, works=[],
                          peaks=None, cg_solves=[])
    assert manifest.read_metrics(cell, ctx, bench_dir=bench_dir) == {}


def test_the_box_cell_reports_the_train_metrics_and_its_stencil():
    c = manifest.load_cell("box32x8x8.train")
    assert c.chips == 1 and c.config["solver"]["kind"] == "two_level_box3d"
    assert {m["name"] for m in c.end_to_end} == {"train_steps_per_s", "train_step_p90_ms",
                                                 "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "launches_per_step.train", "cg_iters.train", "elementwise_ms.train", "cublas_ms.train",
        "spectral_roofline.train", "stencil3d_roofline.train", "mfu.train",
        "device_idle.train", "cg_lane_util.train"}
    with open(os.path.join(manifest.BENCH_DIR, "workloads", "box32x8x8.train.json")) as f:
        readings = json.load(f)
    limits = readings["limits"]
    # every number a train cell has, the worst leaf's kept unheld beside the
    # median leaf's, and the fh's answers
    cooks = manifest.load_cell("cooks160x80.train").limits
    assert set(limits) == set(cooks) | {n + "_median" for n in cooks if n.endswith(
        ("grad_gap", "change_gap", "step_gap"))} | {"fh_y_gap"}
    assert all(limits[n] is None for n in limits if n + "_median" in limits)
    assert readings["control"] == {"solver": {"refine_residual": "split_f32"}}

"""The readers of the program's own CG loop (``cg_lane_util.*``): on fixed
lane counts, on a program that lacks the loop's arithmetic, and on a traced
tiny run of each cell kind (CPU)."""
import time

import numpy as np
import pytest

from portbench.conftest import tiny_seconds
from portbench.harness import manifest, runners
from portbench.harness.trace import Trace

LANE_UTIL = ["cg_lane_util.train", "cg_lane_util.datagen"]


def _ctx(cg_solves):
    return runners.Context(trace=Trace([], [], 1.0), units=1, units_s=1.0, works=[],
                           peaks=None, cg_solves=cg_solves)


@pytest.mark.parametrize("name", LANE_UTIL)
def test_lane_use_of_fixed_counts(name):
    # two solves: lanes needing 5 and 13 (the loop runs 16 steps), then 8 and 3 (8 steps);
    # a refinement run of 2 lanes needing 1 (8 steps)
    solves = [[np.array([5, 13]), np.array([1, 1])], [np.array([8, 3])]]
    want = 100.0 * (5 + 13 + 1 + 1 + 8 + 3) / (2 * 16 + 2 * 8 + 2 * 8)
    assert manifest.metric_reader(name)(_ctx(solves)) == pytest.approx(want, rel=1e-15)
    assert manifest.metric_reader(name)(_ctx([])) is None


@pytest.mark.parametrize("name", LANE_UTIL)
def test_a_program_without_the_loops_arithmetic_reads_nothing(name, monkeypatch):
    from vbicm_tpu_torch.ops import solve

    monkeypatch.delattr(solve, "pcg_lane_use")
    assert manifest.metric_reader(name)(_ctx([[np.array([5, 13])]])) is None


@pytest.mark.parametrize("cell", ["cooks160x80.train", "cooks160x80.datagen",
                                  "box32x8x8.train"])
def test_a_traced_tiny_run_reads_lane_use(tiny_bench, cell):
    root, bench_dir = tiny_bench
    c = manifest.load_cell(cell, root=root, bench_dir=bench_dir)
    kind = c.traffic["kind"]
    rec = runners.RUNNERS[kind](c, 2**31 + 17, tiny_seconds(c), True, "cpu",
                                time.perf_counter())
    got = manifest.read_metrics(c, rec.ctx, bench_dir=bench_dir)
    runs = [it for solve in rec.ctx.cg_solves for it in solve]
    lane = got["cg_lane_util." + kind]["value"]
    assert runs and got["cg_lane_util." + kind]["unit"] == "%"
    # the loop runs each run's slowest lane rounded up to its check every 8
    slots = sum(len(it) * -(-int(it.max()) // 8) * 8 for it in runs)
    assert 0 < lane <= 100
    assert lane == pytest.approx(100.0 * sum(int(it.sum()) for it in runs) / slots, rel=1e-15)

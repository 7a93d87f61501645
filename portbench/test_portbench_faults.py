"""Each fault a cell can have, planted under its timed path at a tiny size
on the CPU, and the cell's control make the run come out not correct (the
look for the card is skipped; the rest of the run is driven as run.py
drives it)."""
import json
import math
import os
import time

import pytest

from portbench import faults
from portbench.conftest import tiny_seconds
from portbench.harness import manifest, runners

CELLS = ["cooks160x80.train", "cooks160x80.datagen", "box32x8x8.train"]


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in (
    "unchanged", "half_batch", "altered")])
def test_a_planted_fault_is_not_correct(tiny_bench, cell, fault):
    root, bench_dir = tiny_bench
    c = manifest.load_cell(cell, root=root, bench_dir=bench_dir)
    kind = c.traffic["kind"]
    with faults.plant(kind, fault):
        rec = runners.RUNNERS[kind](c, 2**31 + 21, tiny_seconds(c), False, "cpu",
                                    time.perf_counter())
    correct, checks = runners.verdict(rec, c.limits)
    assert all(math.isfinite(v["value"]) for v in checks.values()), checks
    assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_bench, cell):
    """The control, the port's own lower-precision path of
    ``workloads/<cell>.json``, run in the port's place, comes out not
    correct (on the card at the cell's size: ``calibrate.py``)."""
    root, bench_dir = tiny_bench
    c = manifest.load_cell(cell, root=root, bench_dir=bench_dir)
    with open(os.path.join(bench_dir, "workloads", cell + ".json")) as f:
        control = json.load(f)["control"]
    kind = c.traffic["kind"]
    rec = runners.RUNNERS[kind](c, 2**31 + 77, tiny_seconds(c), False, "cpu",
                                time.perf_counter(), overrides=control)
    correct, checks = runners.verdict(rec, c.limits)
    assert all(math.isfinite(v["value"]) for v in checks.values()), checks
    assert not correct, checks


def test_a_fault_only_in_the_window_is_not_correct(tiny_bench):
    """Half of each batch left out from the first step of the window on:
    the steps run in set-up read sound, the window's checked steps do not."""
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    root, bench_dir = tiny_bench
    c = manifest.load_cell("cooks160x80.train", root=root, bench_dir=bench_dir)
    calls = []

    def make(old):
        def update(self, net, opt, y, e_data, e=None):
            calls.append(1)
            if len(calls) > c.traffic["checked_steps"]:
                y = y[: y.shape[0] // 2]
            return old(self, net, opt, y, e_data, e)
        return update

    with faults._patch(TwoStepTrainer, "update_step1", make):
        rec = runners.train(c, 2**31 + 31, tiny_seconds(c), False, "cpu",
                            time.perf_counter())
    correct, checks = runners.verdict(rec, c.limits)
    assert all(math.isfinite(v["value"]) for v in checks.values()), checks
    assert not correct, checks
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks
    for name in ("window_loss_gap", "window_grad_gap"):
        assert checks[name]["value"] > checks[name]["limit"], checks

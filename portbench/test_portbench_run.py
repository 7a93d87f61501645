"""run.py on a machine without the card, in a checkout without the port,
and a whole run of each cell on the CPU at a tiny size."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.conftest import tiny_seconds
from portbench.harness import manifest, runners

RUN = os.path.join(manifest.BENCH_DIR, "run.py")


def _run(cwd, script=RUN, workload="cooks160x80.datagen"):
    return subprocess.run([sys.executable, script, "--workload", workload, "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(manifest.ROOT)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, script=str(tmp_path / "portbench" / "run.py"))
    assert out.returncode != 0 and "vbicm_tpu_torch is not in the checkout" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["cooks160x80.train", "cooks160x80.datagen",
                                  "box32x8x8.train"])
def test_a_tiny_run_is_correct(tiny_bench, cell):
    root, bench_dir = tiny_bench
    c = manifest.load_cell(cell, root=root, bench_dir=bench_dir)
    kind = c.traffic["kind"]
    rec = runners.RUNNERS[kind](c, 2**31 + 9, tiny_seconds(c), False, "cpu",
                                time.perf_counter())
    correct, checks = runners.verdict(rec, c.limits)
    assert correct, checks
    assert rec.attempted > 0 and rec.failed == 0 and rec.memory_peak_bytes == 0
    assert set(rec.e2e) == {m["name"] for m in c.end_to_end} - {"setup_s"}
    json.dumps(checks)


@pytest.mark.chip
def test_a_cell_on_the_card(chip):
    out = subprocess.run([sys.executable, RUN, "--workload", "cooks160x80.datagen", "--seed",
                          str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"

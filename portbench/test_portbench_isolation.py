"""Nothing the benchmark runs imports JAX or the JAX package, top-level
names compared whole; the reference and the counts import nothing of the
port."""
import ast
import glob
import os
import subprocess
import sys

from portbench.harness import env, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "vbicm_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "**", "*.py"), recursive=True):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_and_counts_import_nothing_of_the_port():
    for sub in ("reference", "count"):
        for path in glob.glob(os.path.join(manifest.BENCH_DIR, sub, "*.py")):
            assert env.PROGRAM not in set(_imports(path)), path


def test_whole_names_are_compared():
    saved = dict(sys.modules)
    try:
        sys.modules["vbicm_tpu_torch.fake"] = sys
        assert "vbicm_tpu" not in env.forbidden_loaded()
        sys.modules["vbicm_tpu.fake"] = sys
        assert "vbicm_tpu" in env.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_cpu_run_of_every_runner_loads_no_jax(tiny_bench):
    """Every runner, its reference and its readers in a fresh process: no
    JAX module is loaded at the end."""
    root, bench_dir = tiny_bench
    code = f"""
import sys, time
sys.path.insert(0, {manifest.ROOT!r})
from portbench.harness import env, manifest, runners
for cell in ("cooks160x80.train", "cooks160x80.datagen"):
    c = manifest.load_cell(cell, root={root!r}, bench_dir={bench_dir!r})
    rec = runners.RUNNERS[c.traffic["kind"]](c, 5, 0.2, True, "cpu", time.perf_counter())
    manifest.read_metrics(c, rec.ctx, bench_dir={bench_dir!r})
print("loaded:", env.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded: []"

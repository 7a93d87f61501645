"""The stencil-kernel study's port on the CPU: the FMA-ceiling probe's plain
version against the JAX study's Pallas probe, ``utils/roofline`` and
``utils/timing``, and ``examples/stencil_kernel_study_torch.py`` end to end
at 12x6 through the plain versions (only when asked for the CPU)."""
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from threadpoolctl import threadpool_limits

from vbicm_tpu_torch.ops.peak_probe import (
    fma_peak_probe,
    fma_peak_probe_reference,
    fma_probe_flops,
)
from vbicm_tpu_torch.utils import roofline
from vbicm_tpu_torch.utils.roofline import device_peaks, least_time_s, mfu_fields
from vbicm_tpu_torch.utils.timing import Timer, benchmark_fn, profile_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "stencil_kernel_study_torch.py")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_plain_matches_jax_vpu_peak_kernel(monkeypatch):
    """The JAX study's probe runs in interpret mode: ``pallas_call`` is
    patched for this test only; the study's file is not changed."""
    jax_study = _load("stencil_kernel_study", os.path.join(ROOT, "examples",
                                                           "stencil_kernel_study.py"))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    B, NY, XLP, nfma = 4, 3, 128, 5
    rng = np.random.default_rng(0)
    a = rng.uniform(-0.9, 0.9, (B, NY * XLP)).astype(np.float32)
    b = rng.uniform(-0.9, 0.9, (B, XLP)).astype(np.float32)
    want = np.asarray(jax_study.vpu_peak_kernel(B, NY, XLP, nfma)(a, b))
    got = fma_peak_probe_reference(torch.as_tensor(a), torch.as_tensor(b), nfma).numpy()
    # float32 chains of 5 steps, rounded in the same or a contracted order
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_probe_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    g = torch.Generator().manual_seed(1)
    a = torch.rand((3, 2 * 16), generator=g, dtype=torch.float64) * 1.8 - 0.9
    b = torch.rand((3, 16), generator=g, dtype=torch.float64) * 1.8 - 0.9
    out = fma_peak_probe(a, b, 7)
    acc = a.reshape(3, 2, 16)
    for _ in range(7):
        acc = acc * b[:, None] + b[:, None]
    assert torch.equal(out, acc.reshape(3, 32))
    assert torch.equal(fma_peak_probe(a, b, 0), a)
    assert fma_peak_probe.launches == 0
    assert fma_probe_flops(256, 81, 384, 42) == 2 * 42 * 256 * 81 * 384


def test_probe_wrapper_refuses_tensors_off_cpu_and_cuda():
    a, b = torch.empty((2, 8), device="meta"), torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError):
        fma_peak_probe(a, b, 3)
    assert fma_peak_probe.launches == 0


def test_device_peaks(monkeypatch):
    cpu = device_peaks(torch.device("cpu"))
    assert set(cpu) == {"hbm_bytes_per_s", "fp32", "fp64", "tf32_tc", "bf16_tc", "fp64_tc"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    h100 = device_peaks(torch.device("cuda", 0))
    assert h100 == {"hbm_bytes_per_s": 3.35e12, "fp32": 67e12, "fp64": 34e12,
                    "tf32_tc": 494.7e12, "bf16_tc": 989.4e12, "fp64_tc": 67e12}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other GPU")
    with pytest.raises(ValueError):
        device_peaks(torch.device("cuda", 0))


def test_least_time_s():
    peaks = roofline.PEAKS["cpu"]
    assert least_time_s(peaks["hbm_bytes_per_s"], 0.0, "fp32", "cpu") == (1.0, "bytes")
    assert least_time_s(1.0, 2 * peaks["fp32"], "fp32", "cpu") == (2.0, "operations")


def test_mfu_fields_writes_null_and_implausible_above_one():
    peaks = roofline.PEAKS["cpu"]
    ok = mfu_fields(0.5 * peaks["fp32"], 0.25 * peaks["hbm_bytes_per_s"], 1.0, "cpu", unit="fp32")
    assert ok["mfu_vs_fp32"] == 0.5 and ok["hbm_utilization"] == 0.25
    assert not any(k.endswith("_implausible") for k in ok)
    bad = mfu_fields(2.0 * peaks["fp32"], 3.0 * peaks["hbm_bytes_per_s"], 1.0, "cpu", unit="fp32")
    assert bad["mfu_vs_fp32"] is None and bad["mfu_vs_fp32_implausible"] is True
    assert bad["hbm_utilization"] is None and bad["hbm_utilization_implausible"] is True
    assert bad["achieved_tflops"] == 2.0 * peaks["fp32"] / 1e12
    assert mfu_fields(None, None, 1.0, "cpu") == {}


def test_timing_runs_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with Timer() as t:
        x @ x
    assert t.seconds >= 0.0
    with Timer(torch.device("cpu")) as t:
        x @ x
    assert t.seconds >= 0.0
    calls = []
    r = benchmark_fn(lambda y: calls.append(1) or y @ y, x, iters=3, warmup=2, repeats=2)
    assert len(calls) == 2 + 3 * 2
    assert r["clock"] == "host" and r["device"] == "cpu" and r["iters"] == 3
    assert r["mean_s"] > 0 and r["per_sec"] == pytest.approx(1.0 / r["mean_s"])
    path = tmp_path / "trace" / "t.json"
    with profile_trace(str(path)) as prof:
        x @ x
    assert path.exists() and len(prof.key_averages()) > 0
    with profile_trace() as prof:  # no path: no trace file
        x @ x
    assert len(prof.key_averages()) > 0


def test_study_main_on_the_cpu_at_12x6(tmp_path):
    study = _load("stencil_kernel_study_torch", EXAMPLE)
    out = study.main(["--device", "cpu", "--nx", "12", "--ny", "6", "--batch", "4", "--reps", "1",
                      "--nfma-peak", "64", "--results", str(tmp_path)])
    with open(tmp_path / "summary.json") as f:
        saved = json.load(f)
    assert saved["verdict"] == json.loads(json.dumps(out["verdict"]))
    assert (saved["device"], saved["power_limit"], saved["device_type"]) == ("cpu", None, "cpu")
    assert list(saved["impls"]) == ["plain_stencil_f32", "stencil_onerow", "stencil_rows3",
                                    "stencil_rows8", "mxu_f32", "mxu_bf16x3"]
    for key, rec in saved["impls"].items():
        # relative error of norms against the float64 stencil
        assert rec["rel_err_vs_f64"] <= (5e-5 if key == "mxu_bf16x3" else 5e-6), key
        assert rec["ms"] > 0 and rec["min_bytes"] > 0
    # the port's unpadded operands: u and q in float32, the (NY, 42, 2NX) planes
    ndof = 2 * 13 * 7
    assert saved["impls"]["stencil_onerow"]["min_bytes"] == 2 * 4 * 4 * ndof + 7 * 42 * 26 * 4
    assert saved["band_flops_per_matvec"] == 2 * 4 * 7 * 42 * 26
    assert set(saved["probe"]) == {"fp32_nfma42", "fp32_nfma64", "fp64_nfma42", "fp64_nfma64"}
    assert saved["fma_ceiling_tflops"]["fp32"] == saved["probe"]["fp32_nfma64"]["tflops"]
    v = saved["verdict"]
    assert v["ridge_flops_per_byte_datasheet_fp32"] == pytest.approx(20.0)
    assert set(v["impls"]) == set(saved["impls"])


def test_study_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable, EXAMPLE, "--nx", "12", "--ny", "6", "--batch", "4"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr

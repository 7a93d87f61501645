"""The run's environment: caches at fixed paths inside the checkout, few
host threads, the look for the chips, the port's presence, and the check
that nothing loaded JAX or the JAX package."""
from __future__ import annotations

import os
import sys

from .manifest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "vbicm_tpu")
PROGRAM = "vbicm_tpu_torch"


def set_environment(root: str = ROOT) -> None:
    """Before torch is imported: the kernel caches in fixed directories of
    the checkout (the port builds its own library under ``build/`` there),
    and four host threads, so that set-up reads steadily. BENCH_RUN is
    not read."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "4"


def program_present(root: str = ROOT) -> bool:
    """Whether the port's package is in the checkout (and nowhere else is
    taken for it: the checkout goes first on the path)."""
    return os.path.isfile(os.path.join(root, PROGRAM, "__init__.py"))


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``vbicm_tpu_torch`` is not ``vbicm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def chips_missing(chips: int):
    """None when CUDA has at least ``chips`` devices, else the reason."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} devices, torch.cuda.device_count() is " \
               f"{torch.cuda.device_count()}"
    return None


def card_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f"nvidia-smi failed: {ex}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()

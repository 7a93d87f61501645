"""On-card smoke test of the PyTorch port (``vbicm_tpu_torch``) on one GPU.

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version. Then eight paths, each driven through the
entry points a user calls, with the kernels' launch counts set to 0 just
before and read just after:

- Cook's membrane 20x10 (phases 3-7): the spectral solve's adjoint, forward
  parity against the reference golden, the mixed-precision observation
  operator, dataset generation and the two-step VI trainer at the
  reference's widths (3x20 MLPs, 64 observations x 4 posterior samples per
  step, float32 apply plus one float64 refinement);
- the scaled configuration, Cook's membrane 160x80 (26,082 dofs; phases
  8-12): the stencil kernel, the two-level solve against the JAX package's
  float64 golden (tests/fixtures/scaled_160x80_golden.json), its adjoint
  against the dense solve at 40x20, and dataset generation and the two-step
  trainer through the two-level observation operator (float32 CG + one
  float64 refinement, 256 full-order solves per step-1 step; every CG loop
  step two CG update launches, none plain);
- the 3-D hex8 box (phases 13-17): the 27-point stencil kernel on grids up
  to 64x16x16 (56,355 dofs), the box two-level solve against the JAX
  package's float64 golden (tests/fixtures/scaled_3d_golden.json) for the
  trainer's 32x8x8 cantilever and the 64x16x16 solve, its adjoint against
  the dense solve at 8x4x4, and dataset generation and the two-step trainer
  at 32x8x8 (8,019 dofs; float32 CG + one float64 refinement, input
  standardization, per-sample pairing);
- the element path (phases 18-23): the element kernel on quad4, randomly
  renumbered quad4, quad4 with every element listed twice (more entries a
  dof than the kernel holds in registers) and hex8 meshes, Jacobi-PCG on matrix-free models
  against the dense solve, the element-path two-level solve at 160x80
  against the JAX golden and the stencil path, its adjoint at 40x20, and
  the scaled reduced-basis trainer (examples/train_scaled_rom_torch.py:
  the certified ROM inside the ELBO, the element-path two-level solver for
  its full-order spot check).

- the stencil-kernel study (phases 24-27): the 2-D stencil kernel with
  forced rows a band (rows_per_block 1, 2, 3, 4, 8) bitwise against its
  launch plan's rows, the banded tensor-core stencil in both precision
  modes against its plain version and the float64 stencil, the FMA-ceiling
  probe against its plain version, and
  examples/stencil_kernel_study_torch.py's main at 160x80, B = 256;
- the evaluation layer (phases 28-34), each phase with its own launch
  counts and wall time: the spectral and 3-D stencil kernels against their
  plain versions at the path's shapes (and timed); on Cook's 20x10 in
  float64 the log-posterior, its gradient and its Hessian (the spectral
  solve's double backward) at 256 thetas against the CPU run, a
  Metropolis reference chain (8 chains x 2000 steps; R-hat, ESS, and at
  most SAMPLER_SYNCS synchronizing CUDA calls in the run), HMC through the
  adjoint against Metropolis, the paper's accuracy check (the VI posterior
  trained with per-sample pairing, n = 1024, 120 + 100 epochs, against the
  chain, with tests/test_statistical.py's gates, and KLD(MCMC || VI)),
  Laplace against its CPU run, and the comparison pipeline (KLD maps and
  mean/variance fields on a 4x4 y-grid); then per-observation refinement
  through the 3-D trainer's 32x8x8 solver (150 steps, cut from the
  example's 1500);
- the rest of the trainer (phases 35-40), on Cook's 20x10 at the
  reference's widths, each phase with its spectral launches counted:
  the dense Cholesky and inverse solvers against the spectral fh (and
  timed beside it), the full-covariance and flow posteriors (3 + 3 epochs,
  steps/s beside the mean field's), exact resume from the trainer's
  checkpoints against the uninterrupted runs (printed bitwise, gated at
  1e-12), gradient clipping with resampled base draws, and the dataset's
  .npz round trip;
- the random-field family (phases 41-47, ``field_path``), each phase with
  its spectral launches and its wall time: the spectral
  kernel against its plain version at the 3-D field path's coarse size
  (n = 216), the 80x40 field solve of 256 prior fields
  (examples/train_randomfield_torch.py's operator: grid mode, the
  mean-field two-level cycle, float32 CG + one float64 refinement) against
  float64 two-level and Jacobi solves, lm mode against grid mode, two calls
  bitwise equal, CG iterations and the field matvec's time; the field
  adjoint against central differences and the field Hessian against the
  CPU run; the 2-D and 3-D field trainers at the examples' widths (n_data
  256, 2 + 2 epochs); Laplace and refinement through the 10x5 field fh, and
  the 10x5 field ROM, to the JAX tests' gates;
- the hat transfers (phase 48, ``transfer_path``): the restriction and
  prolongation kernels against their plain version on the benchmark cells'
  160x80 grid, the 3-D boxes and odd small grids at ratios 2-4, two calls
  bitwise equal, adjointness in float64, the launches of one 160x80 fh
  batch (none of the plain pair, two of the fused pair a preconditioner
  call) and device time beside the bound;
- CG's vector updates (phase 49, ``cg_update_path``): the kernel pair
  against its plain version at the cells' (256, 26,082), small, single-lane,
  odd and ragged shapes with lanes in every state (active, converged,
  frozen, NaN residual, breakdowns), two launches bitwise equal, device time
  beside the bound, pcg on the 160x80 stencil path against the plain loop
  (per-lane iterations, the solution) and two launches a loop step on an fh
  batch with its adjoint;
- the two-level preconditioner's fused pair (phase 50, ``prec_path``): the
  fused call torch.equal to the composition it replaces on the 160x80,
  ratio-2 80x40, 32x8x8 and 64x16x16 grids in float32 and float64 (also
  with the mean field's constant coefficients), five kernels a call, every
  call of a 160x80 fh batch fused with two launches of the fused pair and
  none of the plain pair, and device
  time of each kernel and of the whole call fused and composed (the 3-D
  fused call no slower).

Phase 1 fails if a spectral, stencil, quad4 element or banded kernel spills
registers; phases 2, 8, 13, 18 and 25 hold two calls of a kernel bitwise
equal; the stencil, element and banded kernels are timed by device time
(CUDA graphs) beside eager time, each with its share of its bound (the
banded kernel also with the bound of the band blocks it reads).

Prints one line per phase, the card's name and power limit, a JSON line with
the kernels' records (each with its bound: the larger of the bytes it must
move over the HBM rate and its operations over the peak rate of the unit
that runs them, the H100 SXM's data-sheet peaks of
vbicm_tpu_torch/utils/roofline.py) and, last, the ok line. Exits non-zero on any failure
and when no GPU is present.

    python3 chip_smoke.py
"""
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def launched(name, since=None):
    """Launches of the kernel ``name`` so far, its ``utils.trace`` counter
    ``<name>.launches``, less those in the snapshot ``since``."""
    from vbicm_tpu_torch.utils import trace

    key = f"{name}.launches"
    return trace.counters().get(key, 0) - (since or {}).get(key, 0)

# (B, n): the 20x10 solve (n = 440), the 160x80 paths' coarse solve (n = 1680
# free dofs of the 40x20 coarse mesh: B = 256 in the step, 8 in phase 20, 16
# in the ROM example's spot check) and the 3-D path's (n = 1200 of the
# 16x4x4 coarse box: B = 256 in the step, 512 in data generation and the
# bridge)
SHAPES = [(256, 440), (4096, 440), (5, 440), (130, 130), (20, 200), (256, 1680), (4096, 1680),
          (8, 1680), (16, 1680), (256, 1200), (512, 1200)]
MAIN_SHAPE = (256, 440)  # one step-1 batch: 64 observations x 4 samples, 440 free dofs
COARSE_SHAPE = (256, 1680)
REL_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
STENCIL_GRIDS = [(8, 4), (32, 16), (160, 80)]
STENCIL_BATCHES = [1, 5, 256, 300]
# the element kernel's batches: ragged tiles, and the 160x80 element path's
# own (8 in phase 20, 16 in the ROM example's spot check, 256 in phase 23)
ELEMENT_BATCHES = [1, 5, 8, 16, 256, 300]
STENCIL_MAIN = (160, 256)  # (nx, B) of the timed case: the step-1 batch at 160x80
# 3-D hex8 box grids (nx, ny, nz) of the kernel check; the trainer's grid
# (32x8x8) at B = 256 is the JSON line's case
BOX_GRIDS = [(4, 2, 2), (32, 8, 8), (64, 16, 16)]
BOX_MAIN = ((32, 8, 8), 256)
BOX_COARSE_SHAPE = (256, 1200)  # the 3-D coarse solve: 16x4x4, 1200 free dofs
BOX_FH_BATCHES = (64, 256)  # the timed 64x16x16 solves (bench.py's B, and B = 256)
def doubled(ke, lm):
    """Every element listed twice: dofs with up to 8 entries, twice the quad4
    kernel's register entries, so its entries read from memory run."""
    return ke.repeat(1, 2, 1, 1), lm.repeat(2, 1)


def dofs_shuffled(ke, lm):
    """The dof ids permuted from a seed: a node's two dofs no longer adjacent
    in u, so the quad4 kernel reads u one value at a time."""
    perm = torch.as_tensor(np.random.default_rng(5).permutation(int(lm.max()) + 1))
    return ke, perm.to(lm.device)[lm]


# the element kernel's meshes: (name, mesh factory, 3-D, tables) -- quad4
# Cook's, Cook's 20x10 with its nodes and elements renumbered from a seed
# (an unstructured dof map), Cook's 8x4 doubled, Cook's 20x10 with its dofs
# shuffled, hex8 boxes; ``tables`` maps the model's (ke, lm)
ELEMENT_MESHES = [("8x4", lambda m: m.cooks_membrane_mesh(8, 4), False, None),
                  ("32x16", lambda m: m.cooks_membrane_mesh(32, 16), False, None),
                  ("160x80", lambda m: m.cooks_membrane_mesh(160, 80), False, None),
                  ("20x10 renumbered",
                   lambda m: m.renumber_mesh(m.cooks_membrane_mesh(20, 10), seed=3), False, None),
                  ("8x4 doubled", lambda m: m.cooks_membrane_mesh(8, 4), False, doubled),
                  ("20x10 dofs shuffled", lambda m: m.cooks_membrane_mesh(20, 10), False,
                   dofs_shuffled),
                  ("4x2x2", lambda m: m.beam_hex8_mesh(4, 2, 2), True, None),
                  ("32x8x8", lambda m: m.beam_hex8_mesh(32, 8, 8), True, None)]
# the element kernel's timed batches at 160x80 (the element path's own and
# the step's), B = 256 the JSON line's case
ELEMENT_TIMED = (8, 16, 256)
# the study path (phases 24-27): rows_per_block values held bitwise against
# the launch plan's rows (2 and 4 do not divide NY = 81, 8 divides none of
# the grids' NY, and 4 and 8 take 160x80's bands in sub-bands), and the
# probe's (B, NY, XLP) shapes
ROWS_PER_BLOCK = (1, 2, 3, 4, 8)
PROBE_SHAPES = [(1, 3, 128), (5, 7, 128), (300, 17, 256), (256, 81, 384)]
PROBE_MAIN = (256, 81, 384)  # the study's: B = 256, NY = 81, XLP = 384
# kernel #6 against its plain version, of max|q|: the same products (bf16x3)
# or 3xTF32 against full float32 products (f32), summed in another order;
# a CPU emulation of 3xTF32 at 160x80 is 1.8e-7 from the plain version.
# Against the float64 stencil: tests/test_pallas.py's bounds.
MXU_TOL_PLAIN = 5e-6
MXU_TOL_EXACT = {"f32": 5e-6, "bf16x3": 5e-5}
# kernel #6's batches: the stencil kernel's, and 64 and 128, one and two
# whole tiles of its 64 samples
MXU_BATCHES = [1, 5, 64, 128, 256, 300]
# the evaluation path's shapes (phase 28): the spectral kernel at 20x10 in
# float64 for Laplace (B = 1), HMC (4 chains), Metropolis (8), a training
# batch (64 x 8 seeds), the posterior predictive (2000) and the comparison's
# pushes (16 y x 200); the 32x8x8 refinement's (16 samples) coarse solve and
# 3-D stencil
EVAL_SHAPES = [(1, 440), (4, 440), (8, 440), (512, 440), (2000, 440), (3200, 440)]
EVAL_TIMED = [(8, 440), (512, 440)]
REFINE_COARSE_SHAPE = (16, 1200)
REFINE_BATCH = 16
# synchronizing CUDA calls a sampler run may make (its draws' copies in and
# its result's copies out), against the thousands of steps in its loop
SAMPLER_SYNCS = 20
# the 3-D field path's coarse solve: the 8x2x2 box's 216 free dofs (B = 256
# in the step, 8 in the HMC and refinement checks, 300 a ragged batch)
FIELD_COARSE_N = 216
FIELD_COARSE_BATCHES = (1, 8, 256, 300)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def least_time(nbytes, flops, dtype=torch.float32, unit=None):
    """(bound_ms, bound_by): the least time for the work on the card, the
    larger of bytes over the HBM rate and operations over the peak rate of
    ``unit`` (default: the CUDA cores in ``dtype``), from the data-sheet
    peaks of vbicm_tpu_torch/utils/roofline.py."""
    from vbicm_tpu_torch.utils.roofline import least_time_s

    unit = unit or {torch.float32: "fp32", torch.float64: "fp64"}[dtype]
    seconds, by = least_time_s(nbytes, flops, unit, torch.device("cuda", 0))
    return seconds * 1e3, by


def spectral_least_time(B, n, dtype):
    """(function bound, tensor-core bound) of an apply at (B, n), each
    (bound_ms, bound_by): V, g, coeffs and b read once, x and a written once;
    4 B n^2 flops of products and 3 B n of the scale. The function's bound
    is on the CUDA cores of ``dtype``; the tensor cores' counts the kernel's
    own products, three TF32 ones (3xTF32) in float32, one DMMA in float64."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (n * n + n + 2 * B + 3 * B * n)
    flops = 4 * B * n * n
    if dtype == torch.float32:
        tc = least_time(nbytes, 3 * flops, unit="tf32_tc")
    else:
        tc = least_time(nbytes, flops, unit="fp64_tc")
    return least_time(nbytes, flops + 3 * B * n, dtype), tc


def spectral_times(shape, dtype, dev, card, phase, reps):
    """Phase 7 / 17: the spectral kernel at ``shape`` against its plain
    version and both bounds. Device time (graph_ms) and eager time (time_ms:
    CUDA events around Python calls, host time included where the host is
    the slower), each timed plain, kernel, kernel, plain. Returns {"device":
    (kernel ms, plain ms), "eager": (...), "bound": ..., "tc": ...}."""
    from vbicm_tpu_torch.ops.spectral_kernel import (
        launch_plan,
        spectral_apply_batched,
        spectral_apply_reference,
    )

    V, g, c, b = pencil_problem(*shape, seed=7, dtype=dtype, device=dev)
    out = {}
    for how, timer in (("device", graph_ms),
                       ("eager", lambda f: time_ms(f, warmup=reps // 10, reps=reps))):
        ms = {}
        for name in ("plain", "kernel", "kernel2", "plain2"):
            fn = spectral_apply_reference if name.startswith("plain") else spectral_apply_batched
            ms[name] = timer(lambda: fn(V, g, c, b, return_coords=True))
        out[how] = (min(ms["kernel"], ms["kernel2"]), min(ms["plain"], ms["plain2"]), ms)
    out["bound"], out["tc"] = spectral_least_time(*shape, dtype)
    plan = launch_plan(*shape, V.element_size())
    dv, eg = out["device"], out["eager"]
    print(f"[{phase} times] spectral apply (B, n)={shape} {dtype}, tile {plan.bm}x{plan.bn}, "
          f"split {plan.split} ({plan.blocks} blocks a launch): device kernel {dv[0]:.4f} ms, "
          f"plain {dv[1]:.4f} ms "
          f"({dv[2]['plain']:.4f}, {dv[2]['kernel']:.4f}, {dv[2]['kernel2']:.4f}, "
          f"{dv[2]['plain2']:.4f}); eager kernel {eg[0]:.4f} ms, plain {eg[1]:.4f} ms; bound "
          f"{out['bound'][0]:.4f} ms ({out['bound'][1]}, CUDA cores), tensor-core bound "
          f"{out['tc'][0]:.4f} ms ({out['tc'][1]}); on {card}", flush=True)
    return out


def ptxas_by_kernel(log):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v log."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def stencil_least_time(planes, c, u):
    """least_time of a stencil matvec: u and q once, the coefficient planes'
    nonzero entries once (the lane offsets that carry no coefficient, and the
    Dirichlet rows' zeros, are no work of the function), an FMA per nonzero
    coefficient per sample and the two-part combine per dof."""
    nnz = int(torch.count_nonzero(planes))
    nbytes = (2 * u.numel() + nnz + c.numel()) * u.element_size()
    return least_time(nbytes, 2 * nnz * u.shape[0] + 3 * u.numel(), u.dtype)


def stencil_fields(times, tag=""):
    """A stencil kernel's JSON fields from kernel_times' records by dtype:
    the float32 ones under their own names, the float64 ones with "_f64",
    all with ``tag`` (a shape) appended."""
    out = {}
    for dtype, dt in ((torch.float32, ""), (torch.float64, "_f64")):
        for key, value in times[dtype].items():
            out[f"{key}{dt}{tag}"] = value
    return out


def element_fields(elem):
    """The element kernel's JSON fields: the (256, 160x80) float32 record
    under its own names, float64 with "_f64", the element path's batches
    with "_b8" / "_b16", the launch plan's sample groups, and the
    renumbered mesh's device time."""
    out = {}
    for (B, dtype), t in elem["element_ms"].items():
        tag = ("" if dtype == torch.float32 else "_f64") + ("" if B == 256 else f"_b{B}")
        for key in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by", "library_ms"):
            if key in t:
                out[key + tag] = t[key]
        out["groups" + tag] = t["plan"][0]
    out["ms_renumbered"] = elem["element_ms_renumbered"]["ms"]
    return out


def assembled_csr(model, dtype):
    """The assembled K_lam, K_mu (all dofs, no masking) as CSR tensors on
    the model's device: the library yardstick's operands."""
    import scipy.sparse as sp

    lm = model.lm.cpu().numpy()
    rows = np.repeat(lm, lm.shape[1], axis=1).reshape(-1)
    cols = np.tile(lm, (1, lm.shape[1])).reshape(-1)
    out = []
    for ke in (model.ke_lam, model.ke_mu):
        K = sp.csr_matrix((ke.cpu().numpy().reshape(-1), (rows, cols)),
                          shape=(model.ndof, model.ndof))
        out.append(torch.sparse_csr_tensor(
            torch.as_tensor(K.indptr, dtype=torch.int64),
            torch.as_tensor(K.indices, dtype=torch.int64),
            torch.as_tensor(K.data, dtype=dtype), size=K.shape).to(model.device))
    return out


def library_affine(K, c, uT):
    """``K(c) u`` through cuSPARSE: two sparse products on uT (ndof, B) and
    the per-sample combine; the port never calls it."""
    return torch.sparse.mm(K[0], uT) * c[:, 0] + torch.sparse.mm(K[1], uT) * c[:, 1]


def pencil_problem(B, n, seed, dtype, device):
    """An orthonormal eigenbasis, positive eigenvalues and coefficients."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    g = np.abs(rng.normal(size=n)) + 0.1
    coeffs = np.abs(rng.normal(size=(B, 2))) + 1.0
    b = rng.normal(size=(B, n))
    return [torch.as_tensor(x, dtype=dtype, device=device).contiguous() for x in (Q, g, coeffs, b)]


def time_ms(fn, warmup=20, reps=200):
    """ms a call of ``fn`` on the card: CUDA events around ``reps`` calls
    after ``warmup``."""
    from vbicm_tpu_torch.utils.timing import benchmark_fn

    res = benchmark_fn(fn, iters=reps, warmup=warmup, device=torch.device("cuda", 0))
    return res["mean_s"] * 1e3


def graph_ms(fn, reps=20, replays=10):
    """Device ms a call of ``fn``: calls captured in a CUDA graph and
    replayed, so that no host time enters (utils/timing.py)."""
    from vbicm_tpu_torch.utils.timing import graph_time_s

    return graph_time_s(fn, reps, replays) * 1e3


def kernel_times(kernel, plain, bound, reps=100, plain_reps=5):
    """A kernel's record at one shape and dtype: device time
    (graph_ms) of the kernel and its plain version, timed plain, kernel,
    kernel, plain (the better of each pair), the kernel's eager time
    (CUDA events around Python calls, host time included), its bound and
    its share of the bound."""
    dev = {}
    for name in ("plain", "kernel", "kernel2", "plain2"):
        if name.startswith("plain"):
            dev[name] = graph_ms(plain, reps=plain_reps, replays=2)
        else:
            dev[name] = graph_ms(kernel)
    ms = min(dev["kernel"], dev["kernel2"])
    return {"ms": ms, "plain_ms": min(dev["plain"], dev["plain2"]),
            "ms_eager": time_ms(kernel, warmup=reps // 10, reps=reps),
            "bound_ms": bound[0], "bound_by": bound[1], "share_of_bound": bound[0] / ms}


def host_syncs(fn):
    """(fn(), the synchronizing CUDA calls made while it ran), counted by
    PyTorch's sync debug mode, which warns at each one."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in caught)


def wall_s(fn, reps, warmup=1):
    """Host wall seconds a call of ``fn`` under no_grad (for solves that
    synchronise with the host themselves), the card synchronised around the
    ``reps`` calls that follow ``warmup``."""
    from vbicm_tpu_torch.utils.timing import Timer

    with torch.no_grad():
        for _ in range(warmup):
            fn()
        with Timer(torch.device("cuda", 0)) as t:
            for _ in range(reps):
                fn()
    return t.seconds / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        sys.exit(2)

    from vbicm_tpu_torch import _build  # importing the package turns TF32 off
    from vbicm_tpu_torch.config import MaterialCard, ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.solve import make_spectral_affine_solver
    from vbicm_tpu_torch.ops.spectral_kernel import (
        TILES,
        spectral_apply_batched,
        spectral_apply_reference,
    )
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import fea_solution, make_fh_fun, probe_von_mises
    from vbicm_tpu_torch.utils.timing import card_line
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # 1. card and build
    _, build_s, build_log = _build.load_library()
    import re

    regs, spectral, stencils, elements, banded, spilled = [], [], [], [], [], []
    for kname, (nreg, st, ld) in ptxas_by_kernel(build_log).items():
        bk = re.search(r"stencil_mxu_kernelI.*(Bf16x3|Tf32x3)", kname)
        if bk is not None:
            label = {"Bf16x3": "bf16x3", "Tf32x3": "f32"}[bk.group(1)]
            banded.append(f"{label}: {nreg} regs, {st}+{ld} B spilled")
            if st or ld:
                spilled.append(f"banded kernel {label} spills ({st} B stored, {ld} B loaded)")
            continue
        ek = re.search(r"element_affine_(quad4_)?kernelI([fd])", kname)
        if ek is not None:
            label = (f"{'quad4' if ek.group(1) else 'hex8'} "
                     f"{'f32' if ek.group(2) == 'f' else 'f64'}")
            elements.append(f"{label}: {nreg} regs, {st}+{ld} B spilled")
            if ek.group(1) and (st or ld):
                spilled.append(f"quad4 element kernel {label} spills ({st} B stored, {ld} B "
                               "loaded)")
            continue
        m = re.search(r"spectral_apply_kernelI([fd])Li(\d+)ELi(\d+)ELi\d+ELi\d+ELb([01])ELb([01])E",
                      kname)
        c = re.search(r"spectral_combine_kernelI([fd])Lb([01])E", kname)
        sk = re.search(r"(stencil3?d?_affine)_kernelI([fd])E", kname)
        if sk is not None:
            stencils.append(f"{sk.group(1)} {'f32' if sk.group(2) == 'f' else 'f64'}: "
                            f"{nreg} regs, {st}+{ld} B spilled")
            if st or ld:
                fail(f"stencil kernel {kname} spills ({st} B stored, {ld} B loaded)")
            continue
        if m is None and c is None:
            regs.append(f"{nreg} regs / {st}+{ld} B spilled")
            continue
        if m is not None:
            vec = " vec" if m.group(5) == "1" else ""
            label = (f"{'f32' if m.group(1) == 'f' else 'f64'} {m.group(2)}x{m.group(3)} "
                     f"{'x' if m.group(4) == '1' else 'a'}{vec}")
        else:
            label = (f"{'f32' if c.group(1) == 'f' else 'f64'} combine "
                     f"{'x' if c.group(2) == '1' else 'a'}")
        spectral.append(f"{label}: {nreg} regs, {st}+{ld} B spilled")
        if st or ld:
            fail(f"spectral kernel {kname} spills ({st} B stored, {ld} B loaded)")
    # (dtype, tile, launch, 16-byte copies or not), and the split's second
    # pass by (dtype, launch)
    n_spectral = 2 * len(TILES) * 2 * 2 + 2 * 2
    if len(spectral) != n_spectral:
        fail(f"expected {n_spectral} spectral kernels in the ptxas log, found {spectral}")
    # the 2-D and the 3-D kernel, each in f32 and f64
    if len(stencils) != 2 + 2:
        fail(f"expected 4 stencil kernels (2 2-D, 2 3-D) in the ptxas log, found {stencils}")
    # quad4 and hex8, each in f32 and f64
    if len(elements) != 2 + 2:
        fail(f"expected 4 element kernels (quad4, hex8 x f32, f64) in the ptxas log, found "
             f"{elements}")
    # the banded tensor-core kernel, bf16x3 and f32
    if len(banded) != 2:
        fail(f"expected 2 banded kernels (bf16x3, f32) in the ptxas log, found {banded}")
    print(f"[1 card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel build {build_s:.2f}s; ptxas spectral (dtype, tile, launch): "
          f"{'; '.join(spectral)}; stencils: {'; '.join(stencils)}; element: "
          f"{'; '.join(elements)}; banded: {'; '.join(banded)}; other kernels: "
          f"{' | '.join(regs)}", flush=True)
    if spilled:
        fail("; ".join(spilled))

    # 2. kernel against its plain version on the card
    worst = {}
    main_abs_err = None
    pencils = {}
    for dtype in (torch.float32, torch.float64):
        for B, n in SHAPES:
            if (B, n) not in pencils:
                pencils[B, n] = pencil_problem(B, n, seed=B + n, dtype=torch.float64, device=dev)
            V, g, c, b = (t.to(dtype) for t in pencils[B, n])
            x, a = spectral_apply_batched(V, g, c, b, return_coords=True)
            x2, a2 = spectral_apply_batched(V, g, c, b, return_coords=True)
            x_only = spectral_apply_batched(V, g, c, b)
            xr, ar = spectral_apply_reference(V, g, c, b, return_coords=True)
            torch.cuda.synchronize()
            errs = (rel_err(x, xr), rel_err(a, ar), rel_err(x_only, xr))
            if not max(errs) <= REL_TOL[dtype]:
                fail(f"kernel vs plain at B={B} n={n} {dtype}: rel err x/a/x-only {errs}")
            if not (torch.equal(x, x2) and torch.equal(a, a2) and torch.equal(x, x_only)):
                fail(f"kernel at B={B} n={n} {dtype}: two calls are not bitwise equal")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), *errs)
            if dtype == torch.float32 and (B, n) == MAIN_SHAPE:
                main_abs_err = float((x - xr).abs().max())
    print(f"[2 kernel] ok: max rel err vs plain f32 {worst['torch.float32']:.3e} (tol 2e-5), "
          f"f64 {worst['torch.float64']:.3e} (tol 1e-12) over (B, n) in {SHAPES}, x and a; "
          "three calls bitwise equal", flush=True)

    # 3. adjoint through the solver: kernel + custom backward against torch
    #    autograd through the plain version, f64, Cook's pencil
    model = build_fem_model(cooks_membrane_mesh(20, 10), device=dev, dtype=torch.float64)
    solver = make_spectral_affine_solver(torch.stack([model.k_lam_ff, model.k_mu_ff]))
    rng = np.random.default_rng(3)
    lam_mu = np.stack([rng.uniform(8.0, 16.0, 256), rng.uniform(6.0, 9.0, 256)], axis=1)
    c0 = torch.as_tensor(lam_mu, dtype=torch.float64, device=dev)
    f0 = torch.as_tensor(rng.normal(size=(256, model.nfree)), dtype=torch.float64, device=dev)
    w = torch.as_tensor(rng.normal(size=(256, model.nfree)), dtype=torch.float64, device=dev)
    grads = []
    for use_kernel in (True, False):
        c = c0.clone().requires_grad_(True)
        f = f0.clone().requires_grad_(True)
        x = solver(c, f) if use_kernel else spectral_apply_reference(solver.V, solver.g, c, f)
        grads.append(torch.autograd.grad((w * x).sum(), (c, f)))
    adj_err = (rel_err(grads[0][0], grads[1][0]), rel_err(grads[0][1], grads[1][1]))
    if not max(adj_err) <= 1e-10:
        fail(f"adjoint: rel err (coeffs, f) {adj_err} > 1e-10")
    print(f"[3 adjoint] ok: grad rel err coeffs {adj_err[0]:.3e}, f {adj_err[1]:.3e} (tol 1e-10)",
          flush=True)

    # 4. forward parity against the reference golden
    with open(os.path.join(ROOT, "tests", "fixtures", "reference_golden.json")) as fh_:
        gold = json.load(fh_)[0]
    mat = MaterialCard(E=gold["E"], v=gold["v"])
    sol = fea_solution(model, mat)
    vm = probe_von_mises(model, sol.u, torch.tensor(mat.lam, dtype=torch.float64, device=dev),
                         torch.tensor(mat.mu, dtype=torch.float64, device=dev), 12, (1, 3))
    u_err = float(np.abs(sol.u[460:462].cpu().numpy() - gold["u_node231"]).max())
    vm_err = float(np.abs(vm.cpu().numpy() - gold["vm_e12_q13"]).max())
    if not max(u_err, vm_err) <= 1e-9:
        fail(f"golden: u_node231 err {u_err}, vm_e12_q13 err {vm_err} > 1e-9")
    print(f"[4 golden] ok: u_node231 {sol.u[460:462].tolist()} err {u_err:.2e}, "
          f"vm_e12_q13 {vm.tolist()} err {vm_err:.2e} (tol 1e-9)", flush=True)

    # 5. observation operator: f32 apply + 1 refinement against the f64 apply
    cfg = ProblemConfig()
    fh64 = make_fh_fun(model, cfg)
    fh32 = make_fh_fun(model, cfg, factor_dtype=torch.float32, refine_iters=1)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
    with torch.no_grad():
        y64, h64 = fh64(thetas)
        y32, h32 = fh32(thetas)
    fh_err = (rel_err(y32, y64), rel_err(h32, h64))
    if not max(fh_err) <= 1e-9:
        fail(f"fh f32+1 refinement vs f64: rel err (y, h) {fh_err} > 1e-9")
    print(f"[5 fh] ok: f32 apply + 1 refinement vs f64, rel err y {fh_err[0]:.3e}, "
          f"h {fh_err[1]:.3e} (tol 1e-9), 256 thetas", flush=True)

    # 6. the main path: dataset generation and the two-step trainer
    tcfg = TrainConfig(batch_size=64, num_epoch1=3, num_epoch2=3)
    before = launched("spectral_apply")
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh32, n_sam=1024, ne_sam=4,
                           device=dev, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=4096)
    trainer = TwoStepTrainer(model, cfg, tcfg, factor_dtype=torch.float32, refine_iters=1)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    launches = launched("spectral_apply") - before
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("predict: outputs not finite (8, 2) tensors")
    if launches <= 0:
        fail("the trainer never launched the spectral kernel")
    print(f"[6 trainer] ok: step1 losses {res.hist_step1.tolist()}, step2 losses "
          f"{res.hist_step2.tolist()}, spectral kernel launches {launches}", flush=True)

    # 7. times (records, not a claim), each beside the card's name and limit
    steps_per_epoch = math.ceil(ds.n_sam / tcfg.batch_size)
    steps_per_s = steps_per_epoch * (tcfg.num_epoch1 - 1) / sum(res.epoch_times_step1[1:])
    print(f"[7 times] step-1 train steps/s (B=64x4, f32 apply + 1 refinement, epochs 2-3): "
          f"{steps_per_s:.2f} on {card}", flush=True)
    times = {}
    for shape, reps in ((MAIN_SHAPE, 200), (COARSE_SHAPE, 100)):
        for dtype in (torch.float32, torch.float64):
            times[shape, dtype] = spectral_times(shape, dtype, dev, card, 7, reps)

    scaled = scaled_path(dev, card)
    box = box3d_path(dev, card)
    elem = element_path(dev, card)
    study = study_path(dev, card)
    evals = eval_path(dev, card, box)
    fams = trainer_path(dev, card, model, ds, thetas, fh64, steps_per_s)
    field = field_path(dev, card)
    transfer = transfer_path(dev, card)
    cgu = cg_update_path(dev, card)
    precs = prec_path(dev, card)

    times[BOX_COARSE_SHAPE, torch.float32] = box["spectral_ms"][torch.float32]
    times[BOX_COARSE_SHAPE, torch.float64] = box["spectral_ms"][torch.float64]
    field_shape = (256, FIELD_COARSE_N)
    for dtype in (torch.float32, torch.float64):
        times[field_shape, dtype] = field["spectral_ms"][dtype]
    spectral = {}  # the f32 record's fields by shape (device time), and the f64 times
    for shape, tag in ((MAIN_SHAPE, ""), (COARSE_SHAPE, "_coarse_256x1680"),
                       (BOX_COARSE_SHAPE, "_coarse_256x1200"),
                       (field_shape, f"_coarse_256x{FIELD_COARSE_N}")):
        for dtype, dt in ((torch.float32, ""), (torch.float64, "_f64")):
            t = times[shape, dtype]
            spectral.update({f"ms{dt}{tag}": t["device"][0], f"plain_ms{dt}{tag}": t["device"][1],
                             f"ms_eager{dt}{tag}": t["eager"][0],
                             f"plain_ms_eager{dt}{tag}": t["eager"][1],
                             f"bound_ms{dt}{tag}": t["bound"][0],
                             f"tc_bound_ms{dt}{tag}": t["tc"][0]})
            if not dt:
                spectral[f"bound_by{tag}"] = t["bound"][1]

    f32, f64 = torch.float32, torch.float64
    records = [{
        "name": "spectral_apply_batched",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/spectral_apply.cu",
        "replaces": "vbicm_tpu/ops/spectral_pallas.py:56",
        "launches": (launches + scaled["spectral_launches"] + box["spectral_launches"]
                     + elem["spectral_launches"] + evals["eval_20x10"]
                     + evals["refine_32x8x8"][0] + fams["fullcov"][0] + fams["flow"][0]
                     + fams["resume"] + fams["clip"] + sum(field["launches"].values())),
        "launches_by_path": {"cooks_20x10": launches,
                             "scaled_160x80": scaled["spectral_launches"],
                             "box3d_32x8x8": box["spectral_launches"],
                             "rom_160x80": elem["spectral_launches"],
                             "eval_20x10": evals["eval_20x10"],
                             "refine_32x8x8": evals["refine_32x8x8"][0],
                             "fullcov_20x10": fams["fullcov"][0],
                             "flow_20x10": fams["flow"][0],
                             "resume_20x10": fams["resume"],
                             "clip_resample_20x10": fams["clip"],
                             **field["launches"]},
        "max_abs_err": main_abs_err,
        f"max_abs_err_256x{FIELD_COARSE_N}": field["spectral_abs_err_216"],
        **{k: spectral[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no one PyTorch call computes V diag(1/d) V^T b per sample
        "tc_bound_ms": spectral["tc_bound_ms"],  # 3xTF32 on tf32_tc (f64: DMMA on fp64_tc)
        **{f"{k}_f64_{B}x{n}": evals["spectral_ms"][B, n]["device"][i]
           for B, n in EVAL_TIMED for i, k in enumerate(("ms", "plain_ms"))},
        **{k: v for k, v in spectral.items()
           if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "tc_bound_ms")},
    }, {
        "name": "stencil_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil_pallas.py:71",
        "launches": scaled["stencil_launches"] + study["onerow_launches"],
        "launches_by_path": {"scaled_160x80": scaled["stencil_launches"],
                             "stencil_study_160x80": study["onerow_launches"]},
        "max_abs_err": scaled["stencil_abs_err"],
        **stencil_fields(scaled["stencil_ms"]),
    }, {
        "name": "stencil3d_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil3d_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil3d_pallas.py:63",
        "launches": box["stencil3d_launches"] + evals["refine_32x8x8"][1],
        "launches_by_path": {"box3d_32x8x8": box["stencil3d_launches"],
                             "refine_32x8x8": evals["refine_32x8x8"][1]},
        "max_abs_err": box["stencil3d_abs_err"],
        **stencil_fields({dt: box["stencil3d_ms"][(32, 8, 8), dt] for dt in (f32, f64)}),
        **stencil_fields({dt: box["stencil3d_ms"][(64, 16, 16), dt] for dt in (f32, f64)},
                         "_64x16x16"),
        **{f"{k}_b{REFINE_BATCH}": evals["stencil3d_ms"][k]
           for k in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by")},
    }, {
        "name": "element_affine_matvec_kernel",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/element_matvec.cu",
        "replaces": "vbicm_tpu/ops/element_matvec_pallas.py:75",
        "launches": elem["element_launches"] + elem["element_fh_launches"],
        "launches_by_path": {"rom_160x80": elem["element_launches"],
                             "element_fh_160x80": elem["element_fh_launches"]},
        "max_abs_err": elem["element_abs_err"],
        **element_fields(elem),
    }]
    rows32, rows64 = study["rows_ms"][f32], study["rows_ms"][f64]
    mxu = study["mxu_ms"]
    probe = study["probe_ms"]
    records += [{
        "name": "stencil_affine_matvec_rows",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil_pallas.py:159",
        "launches": study["rows_launches"],
        "launches_by_path": {"stencil_study_160x80": study["rows_launches"]},
        "max_abs_err": study["rows_abs_err"],
        "rows_per_block": 3,
        "ms": rows32[0][3],
        "plain_ms": rows32[1],
        "bound_ms": study["stencil_bound"][0],
        "bound_by": study["stencil_bound"][1],
        # #2's function: phase 12's cuSPARSE pair
        "library_ms": scaled["stencil_ms"][f32]["library_ms"],
        "share_of_bound": study["stencil_bound"][0] / rows32[0][3],
        "ms_rows_per_block_8": rows32[0][8],
        "ms_one_row_same_call": rows32[0][1],
        "ms_plan_same_call": rows32[0][None],
        "ms_f64": rows64[0][3],
        "ms_f64_rows_per_block_8": rows64[0][8],
        "ms_f64_plan_same_call": rows64[0][None],
    }, {
        "name": "stencil_affine_matvec_mxu",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_mxu.cu",
        "replaces": "vbicm_tpu/ops/stencil_mxu.py:116",
        "launches": study["mxu_launches"],
        "launches_by_path": {"stencil_study_160x80": study["mxu_launches"]},
        "mode": "bf16x3",
        "max_abs_err": study["mxu_abs_err"]["bf16x3"],
        "ms": mxu["bf16x3"]["ms"],
        "plain_ms": mxu["bf16x3"]["plain_ms"],
        "bound_ms": mxu["bf16x3"]["bound_ms"],  # the function's (kernel #2's)
        "bound_by": mxu["bf16x3"]["bound_by"],
        "library_ms": scaled["stencil_ms"][f32]["library_ms"],
        **{f"{key}{tag}": mxu[mode][key]
           for mode, tag in (("bf16x3", ""), ("f32", "_f32"))
           for key in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by", "share_of_bound",
                       "bound_ms_band", "bound_by_band", "share_of_band_bound",
                       "bound_ms_densified", "bound_by_densified", "groups")},
        "max_abs_err_f32": study["mxu_abs_err"]["f32"],
    }, {
        "name": "fma_peak_probe",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/fma_probe.cu",
        "replaces": "examples/stencil_kernel_study.py:52",
        "launches": study["probe_launches"],
        "launches_by_path": {"stencil_study_160x80": study["probe_launches"]},
        "max_abs_err": study["probe_abs_err"],
        "nfma": 42,
        "ms": probe["fp32", 42][0],
        "plain_ms": probe["fp32", 42][1],
        "bound_ms": probe["fp32", 42][2][0],
        "bound_by": probe["fp32", 42][2][1],
        "library_ms": None,  # no PyTorch call computes the chain
        "ms_nfma4096": probe["fp32", 4096][0],
        "tflops_nfma4096": probe["fp32", 4096][3],
        "bound_ms_nfma4096": probe["fp32", 4096][2][0],
        "bound_by_nfma4096": probe["fp32", 4096][2][1],
        "ms_f64_nfma4096": probe["fp64", 4096][0],
        "tflops_f64_nfma4096": probe["fp64", 4096][3],
        "bound_ms_f64_nfma4096": probe["fp64", 4096][2][0],
    }]
    t32 = {way: transfer["ms"][TRANSFER_MAIN[0], TRANSFER_MAIN[1], f32, way]
           for way in ("restrict", "prolong")}
    t64 = {way: transfer["ms"][TRANSFER_MAIN[0], TRANSFER_MAIN[1], f64, way]
           for way in ("restrict", "prolong")}
    records.append({
        "name": "hat_transfer",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/hat_transfer.cu",
        "replaces": None,  # the JAX package's transfers are XLA convolutions
        "launches": scaled["transfer_launches"] + transfer["launches_fh"],
        "launches_by_path": {"scaled_160x80": scaled["transfer_launches"],
                             "fh_160x80": transfer["launches_fh"]},
        "max_rel_err": max(transfer["err"].values()),
        **{k: t32["restrict"][k] for k in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by",
                                           "share_of_bound")},
        "library_ms": None,  # no one PyTorch call computes a transfer
        **{f"{k}_prolong": t32["prolong"][k] for k in ("ms", "plain_ms", "ms_eager",
                                                       "share_of_bound")},
        **{f"{k}_f64": t64["restrict"][k] for k in ("ms", "plain_ms", "bound_ms")},
        **{f"{k}_prolong_f64": t64["prolong"][k] for k in ("ms", "plain_ms")},
    })
    c32 = {way: cgu["ms"][f32, way == "beta"] for way in ("alpha", "beta")}
    c64 = {way: cgu["ms"][f64, way == "beta"] for way in ("alpha", "beta")}
    records.append({
        "name": "cg_update",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/cg_update.cu",
        "replaces": None,  # the JAX package's CG updates are XLA ops
        "launches": scaled["cg_update_launches"] + cgu["fh_counters"]["cg_update.launches"],
        "launches_by_path": {"scaled_160x80": scaled["cg_update_launches"],
                             "fh_160x80_with_adjoint": cgu["fh_counters"]["cg_update.launches"]},
        "max_rel_err": max(cgu["err"].values()),
        **{k: c32["alpha"][k] for k in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by",
                                        "share_of_bound")},
        "library_ms": None,  # no one PyTorch call computes a step
        **{f"{k}_beta": c32["beta"][k] for k in ("ms", "plain_ms", "ms_eager", "bound_ms",
                                                 "share_of_bound")},
        **{f"{k}_f64": c64["alpha"][k] for k in ("ms", "plain_ms", "bound_ms")},
        **{f"{k}_beta_f64": c64["beta"][k] for k in ("ms", "plain_ms", "bound_ms")},
    })
    p32 = {way: precs["ms"][PREC_MAIN[0], PREC_MAIN[1], f32, way]
           for way in ("restrict", "prolong")}
    p64 = {way: precs["ms"][PREC_MAIN[0], PREC_MAIN[1], f64, way]
           for way in ("restrict", "prolong")}
    records.append({
        "name": "hat_transfer_prec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/hat_transfer.cu",
        "replaces": None,  # folds the preconditioner's PyTorch ops into the transfers (#8)
        "launches": scaled["prec_launches"] + precs["fh_counters"]["hat_transfer_prec.launches"],
        "launches_by_path": {"scaled_160x80": scaled["prec_launches"],
                             "fh_160x80": precs["fh_counters"]["hat_transfer_prec.launches"]},
        **{k: p32["restrict"][k] for k in ("ms", "plain_ms", "ms_eager", "bound_ms", "bound_by",
                                           "share_of_bound")},
        "library_ms": None,  # no one PyTorch call computes a transfer
        **{f"{k}_prolong": p32["prolong"][k] for k in ("ms", "plain_ms", "ms_eager", "bound_ms",
                                                       "share_of_bound")},
        **{f"{k}_f64": p64["restrict"][k] for k in ("ms", "plain_ms", "bound_ms")},
        **{f"{k}_prolong_f64": p64["prolong"][k] for k in ("ms", "plain_ms", "bound_ms")},
        **{f"call_{k}": v for k, v in precs["call_ms"][PREC_MAIN[0], PREC_MAIN[1], f32].items()},
        "call_kernels_fused": len(precs["kernels_fused"]),
        "call_kernels_composed": len(precs["kernels_composed"]),
    })
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def scaled_path(dev, card):
    """Phases 8-12: the scaled configuration (Cook's membrane 160x80)."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.ops.stencil import StencilOperator
    from vbicm_tpu_torch.ops.stencil_kernel import launch_plan, stencil_affine_reference
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    out = {}
    # 8. stencil kernel against its plain version, ragged sample tiles
    worst = {}
    for nx, ny in STENCIL_GRIDS:
        op = StencilOperator(build_fem_model(cooks_membrane_mesh(nx, ny), device=dev,
                                             dense=False), nx, ny)
        ndof = 2 * (nx + 1) * (ny + 1)
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + nx)
            u64 = torch.as_tensor(rng.normal(size=(B, ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (torch.float32, torch.float64):
                u, c = u64.to(dtype), c64.to(dtype)
                q, q2 = op.affine(c, u), op.affine(c, u)
                qr = stencil_affine_reference(op.W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"stencil kernel vs plain at {nx}x{ny} B={B} {dtype}: rel err {err}")
                if not torch.equal(q, q2):
                    fail(f"stencil kernel at {nx}x{ny} B={B} {dtype}: two calls differ")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (nx, B) == STENCIL_MAIN:
                    out["stencil_abs_err"] = float((q - qr).abs().max())
                    stencil_case = (op, c64, u64)
    print(f"[8 stencil] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12), two calls bitwise equal, "
          f"over grids {STENCIL_GRIDS} x B in {STENCIL_BATCHES}", flush=True)

    # 9. the two-level solve at 160x80 against the JAX package's f64 golden
    with open(os.path.join(ROOT, "tests", "fixtures", "scaled_160x80_golden.json")) as f:
        gold = json.load(f)
    nx, ny, r = (gold["mesh"][k] for k in ("nx", "ny", "ratio"))
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // r, ny // r), device=dev, dense=True)
    probe = gold["probe"]
    cfg = dataclasses.replace(ProblemConfig(), node_id=probe["node_id"], ele_id=probe["ele_id"],
                              nipt_id=tuple(probe["nipt_id"]))
    fhs, solvers = {}, {}
    for residual, tol in (("f64", 1e-6), ("split_f32", 1e-3)):
        solve = make_two_level_solver(model, coarse, nx // r, ny // r, r, cg_dtype=torch.float32,
                                      refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True,
                                      refine_residual=residual)
        fhs[residual], solvers[residual] = make_fh_fun(model, cfg, solve_free=solve), solve
        thetas = torch.as_tensor(gold["thetas"], dtype=torch.float64, device=dev)
        with torch.no_grad():
            y, h = fhs[residual](thetas)
            tm, ts = cfg.theta_map.theta_mean, cfg.theta_map.theta_std
            c0, c1 = lame_from_Ev(torch.exp(ts[0] * thetas[:, 0] + tm[0]),
                                  0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1]))
            u = solve(c0, c1)
            ke = torch.stack([model.ke_lam, model.ke_mu])
            b = (model.f_ext * model.free_mask).expand(u.shape[0], -1)
            res = (b - element_affine_matvec(ke, model.lm, torch.stack([c0, c1], -1), u,
                                             model.ndof)) * model.free_mask
            rel_res = float((res.norm(dim=-1) / b.norm(dim=-1)).max())
        errs = (rel_err(y, torch.as_tensor(gold["y"], dtype=torch.float64, device=dev)),
                rel_err(h, torch.as_tensor(gold["h"], dtype=torch.float64, device=dev)))
        iters = [it.tolist() for it in solve.solver.last_cg_iters]
        if not max(errs) <= tol:
            fail(f"two-level {residual} vs JAX golden: rel err (y, h) {errs} > {tol}")
        print(f"[9 two-level] ok: 160x80 f32 CG (tol 3e-3) + 1 {residual} refinement vs JAX f64 "
              f"golden, rel err y {errs[0]:.3e}, h {errs[1]:.3e} (tol {tol:g}); max relative "
              f"residual (element matvec, f64) {rel_res:.3e}; CG iterations {iters}", flush=True)

    # 10. adjoint at 40x20 (coarse 10x5) against the dense spectral solve, f64
    fine40 = build_fem_model(cooks_membrane_mesh(40, 20), device=dev, dense=True)
    coarse10 = build_fem_model(cooks_membrane_mesh(10, 5), device=dev, dense=True)
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 64), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 64), device=dev)
    wv = torch.as_tensor(rng.normal(size=(64, fine40.ndof)), device=dev) * fine40.free_mask
    vals, grads = [], []
    for solve in (make_two_level_solver(fine40, coarse10, 10, 5, 4, cg_dtype=torch.float32,
                                        refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True),
                  make_solver(fine40)):
        a, m = lam.clone().requires_grad_(True), mu.clone().requires_grad_(True)
        J = (solve(a, m) * wv).sum(-1)
        vals.append(J.detach())
        grads.append(torch.stack(torch.autograd.grad(J.sum(), (a, m)), -1))
    adj = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    if not (adj[0] <= 1e-7 and adj[1] <= 1e-6):
        fail(f"two-level adjoint vs dense at 40x20: rel err (value, grad) {adj} > (1e-7, 1e-6)")
    print(f"[10 adjoint] ok: 40x20 two-level (f32 CG + 1 f64 refinement) vs dense spectral f64, "
          f"64 probe functionals: value rel err {adj[0]:.3e} (tol 1e-7), d/d(lam, mu) "
          f"{adj[1]:.3e} (tol 1e-6)", flush=True)

    # 11. the scaled main path: dataset generation and the two-step trainer
    #     through the two-level observation operator (f64 refinement)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)
    fh = make_fh_fun(model, cfg, solve_free=solvers["f64"])
    tcfg = TrainConfig(batch_size=64, num_epoch1=2, num_epoch2=2)
    before = trace.counters()
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=2048)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    after = trace.counters()
    out["spectral_launches"] = launched("spectral_apply", before)
    out["stencil_launches"] = launched("stencil_affine", before)
    out["transfer_launches"] = launched("hat_transfer", before)
    out["prec_launches"] = launched("hat_transfer_prec", before)
    cg = {k: after.get(k, 0) - before.get(k, 0)
          for k in ("cg_update.launches", "pcg.steps.fused", "pcg.steps.plain",
                    "prec.calls.fused", "prec.calls.plain")}
    out["cg_update_launches"] = cg["cg_update.launches"]
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"scaled trainer: non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("scaled predict: outputs not finite (8, 2) tensors")
    if min(out["spectral_launches"], out["stencil_launches"], out["prec_launches"]) <= 0:
        fail(f"the scaled trainer launched spectral {out['spectral_launches']}, stencil "
             f"{out['stencil_launches']}, fused transfer {out['prec_launches']} times; all must "
             "be > 0")
    if not (cg["cg_update.launches"] > 0 and cg["pcg.steps.plain"] == 0
            and cg["cg_update.launches"] == 2 * cg["pcg.steps.fused"]):
        fail(f"the scaled datagen and trainer: CG counters {cg} (want 2 CG update launches a "
             "fused loop step, no plain step)")
    if not (cg["prec.calls.plain"] == 0 and out["transfer_launches"] == 0
            and 2 * cg["prec.calls.fused"] == out["prec_launches"]):
        fail(f"the scaled datagen and trainer: preconditioner calls {cg} for "
             f"{out['prec_launches']} fused and {out['transfer_launches']} plain transfer "
             "launches (want every call fused, two fused launches each, no plain one)")
    print(f"[11 scaled trainer] ok: 160x80, n=256 x ne_sam 4, 2 + 2 epochs at batch 64; step1 "
          f"losses {res.hist_step1.tolist()}, step2 losses {res.hist_step2.tolist()}; kernel "
          f"launches stencil {out['stencil_launches']}, spectral {out['spectral_launches']}, "
          f"transfer {out['prec_launches']} fused, {out['transfer_launches']} plain, CG update "
          f"{cg['cg_update.launches']} "
          f"({cg['pcg.steps.fused']} fused loop steps, {cg['pcg.steps.plain']} plain); "
          f"preconditioner calls {cg['prec.calls.fused']} fused, {cg['prec.calls.plain']} plain",
          flush=True)

    # 12. times (records, not a claim), each beside the card's name and limit
    steps = math.ceil(ds.n_sam / tcfg.batch_size) * (tcfg.num_epoch1 - 1)
    print(f"[12 times] scaled step-1 train steps/s (160x80, B=64x4, f32 CG + 1 f64 refinement, "
          f"epoch 2): {steps / sum(res.epoch_times_step1[1:]):.3f} on {card}", flush=True)
    op, c64, u64 = stencil_case
    out["stencil_ms"] = {}
    for dtype in (torch.float32, torch.float64):
        u, c = u64.to(dtype), c64.to(dtype)
        t = kernel_times(lambda: op.affine(c, u),
                          lambda: stencil_affine_reference(op.W[dtype], c, u),
                          stencil_least_time(op.planes[dtype], c, u))
        K, uT = assembled_csr(model, dtype), u.T.contiguous()
        lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
        if not lib_err <= REL_TOL[dtype]:
            fail(f"cuSPARSE yardstick vs stencil kernel at 160x80 {dtype}: rel err {lib_err}")
        t["library_ms"] = time_ms(lambda: library_affine(K, c, uT), warmup=5, reps=50)
        out["stencil_ms"][dtype] = t
        plan = launch_plan(u.shape[0], *op.planes[dtype].shape[::2], dtype, dev)
        print(f"[12 times] stencil matvec (B=256, 160x80) {dtype}, rows {plan.rows}, runs of "
              f"{plan.run} (band, sample) pairs, {plan.blocks} blocks: device kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager kernel "
              f"{t['ms_eager']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{100 * t['share_of_bound']:.1f} % of it; cuSPARSE yardstick (eager) "
              f"{t['library_ms']:.4f} ms (rel err {lib_err:.1e}), on {card}", flush=True)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
    for residual in ("f64", "split_f32"):
        dt = wall_s(lambda: fhs[residual](thetas), 3)
        its = torch.stack(solvers[residual].solver.last_cg_iters).double()
        print(f"[12 times] two-level fh (160x80, B=256, f32 CG + 1 {residual} refinement): "
              f"{256 / dt:.1f} solves/s ({dt * 1e3:.1f} ms a batch); CG iterations per solve "
              f"(first CG, refinement CG) mean {its.mean(1).tolist()}, max "
              f"{its.max(1).values.tolist()}, on {card}", flush=True)
    return out


def element_path(dev, card):
    """Phases 18-23: the element path (Jacobi-PCG, the element-path
    two-level solver and the reduced-basis trainer) and its kernel."""
    import dataclasses

    from vbicm_tpu_torch import mesh as meshes
    from vbicm_tpu_torch.config import ProblemConfig, SectionCard
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element_kernel import ElementOperator, launch_plan
    from vbicm_tpu_torch.rom import build_reduced_basis, make_fh_fun_rom
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver
    from vbicm_tpu_torch.utils import trace

    out = {}
    f32, f64 = torch.float32, torch.float64
    # 18. the element kernel against its plain version, ragged sample runs,
    #     two launches bitwise equal
    worst = {}
    for name, make, is3d, tables in ELEMENT_MESHES:
        m = build_fem_model(make(meshes), SectionCard(stype=4) if is3d else SectionCard(),
                            device=dev, dense=False)
        ke, lm = (tables or (lambda *a: a))(torch.stack([m.ke_lam, m.ke_mu]), m.lm)
        op = ElementOperator(ke, lm, m.ndof)
        for B in ELEMENT_BATCHES:
            rng = np.random.default_rng(B + m.ndof)
            u64 = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (f32, f64):
                u, c = u64.to(dtype), c64.to(dtype)
                q, q2 = op.affine(c, u), op.affine(c, u)
                qr = element_affine_matvec(op.ke[dtype], lm, c, u, m.ndof)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"element kernel vs plain at {name} B={B} {dtype}: rel err {err}")
                if not torch.equal(q, q2):
                    fail(f"element kernel at {name} B={B} {dtype}: two launches differ")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if (name, B, dtype) == ("160x80", 256, f32):
                    out["element_abs_err"] = float((q - qr).abs().max())
        if name == "160x80":
            timed = (m, op)
        if name == "8x4 doubled":
            most = int(torch.diff(op.row_ptr).max())
    print(f"[18 element] ok: max rel err vs plain (of max|q|) f32 {worst[f32]:.3e} (tol 2e-5), "
          f"f64 {worst[f64]:.3e} (tol 1e-12), two launches bitwise equal, over "
          f"{[n for n, _, _, _ in ELEMENT_MESHES]} x B in {ELEMENT_BATCHES} (8x4 doubled: up to "
          f"{most} entries a dof)", flush=True)

    def element_times(m, op, B, dtype, seed):
        """The kernel's record at (B, mesh): device and eager time beside the
        plain version's, its bound and its launch plan."""
        rng = np.random.default_rng(seed)
        u = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev).to(dtype)
        c = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev).to(dtype)
        err = rel_err(op.affine(c, u), element_affine_matvec(op.ke[dtype], m.lm, c, u, m.ndof))
        if not err <= REL_TOL[dtype]:
            fail(f"element kernel vs plain at the timed {m.ndof} dofs, B={B} {dtype}: "
                 f"rel err {err}")
        # u and q once, the blocks and the dof map once (not the kernel's own
        # incidence tables, which the function does not need); an FMA per
        # block entry per sample, and the two-part combine per dof
        nbytes = ((2 * u.numel() + op.ke[dtype].numel() + c.numel()) * u.element_size()
                  + 4 * op.lm.numel())
        flops = 2 * op.ke[dtype].numel() * B + 3 * u.numel()
        t = kernel_times(lambda: op.affine(c, u),
                          lambda: element_affine_matvec(op.ke[dtype], m.lm, c, u, m.ndof),
                          least_time(nbytes, flops, dtype), plain_reps=2 if B > 16 else 5)
        t["plan"] = launch_plan(B, m.ndof, op.lm.shape[1], dtype)
        return t, c, u

    m, op = timed
    out["element_ms"] = {}
    for B in ELEMENT_TIMED:
        for dtype in (f32, f64):
            t, c, u = element_times(m, op, B, dtype, seed=B + m.ndof)
            if B == 256:
                K, uT = assembled_csr(m, dtype), u.T.contiguous()
                lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
                if not lib_err <= REL_TOL[dtype]:
                    fail(f"cuSPARSE yardstick vs element kernel at 160x80 {dtype}: rel err "
                         f"{lib_err}")
                t["library_ms"] = time_ms(lambda: library_affine(K, c, uT), warmup=3, reps=20)
            out["element_ms"][B, dtype] = t
            lib = (f", cuSPARSE yardstick (eager) {t['library_ms']:.4f} ms (rel err "
                   f"{lib_err:.1e})" if B == 256 else "")
            print(f"[18 times] element matvec (B={B}, 160x80) {dtype}, plan (groups, blocks an "
                  f"SM, register entries) {t['plan']}: device kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms; eager kernel {t['ms_eager']:.4f} ms{lib}; bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['share_of_bound']:.1f} % "
                  f"of it; on {card}", flush=True)
    # what an unstructured numbering costs (a record, not a check)
    m = build_fem_model(meshes.renumber_mesh(meshes.cooks_membrane_mesh(160, 80), seed=3),
                        device=dev, dense=False)
    op = ElementOperator(torch.stack([m.ke_lam, m.ke_mu]), m.lm, m.ndof, dtypes=(f32,))
    t, _, _ = element_times(m, op, 256, f32, seed=256 + m.ndof)
    out["element_ms_renumbered"] = t
    print(f"[18 times] element matvec (B=256, 160x80 renumbered, seed 3) {f32}, plan "
          f"{t['plan']}: device kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager "
          f"kernel {t['ms_eager']:.4f} ms; bound {t['bound_ms']:.4f} ms, "
          f"{100 * t['share_of_bound']:.1f} % of it; on {card}", flush=True)

    # 19. Jacobi-PCG (make_solver on matrix-free models) against the dense
    #     spectral solve of the same mesh
    rng = np.random.default_rng(19)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 8), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 8), device=dev)
    for name, mesh, sec in (("20x10", meshes.cooks_membrane_mesh(20, 10), SectionCard()),
                            ("20x10 renumbered",
                             meshes.renumber_mesh(meshes.cooks_membrane_mesh(20, 10), seed=3),
                             SectionCard()),
                            ("hex8 8x4x4", meshes.beam_hex8_mesh(8, 4, 4), SectionCard(stype=4))):
        mf = build_fem_model(mesh, sec, device=dev, dense=False)
        ud = make_solver(build_fem_model(mesh, sec, device=dev, dense=True))(lam, mu)
        solve = make_solver(mf, cg_tol=1e-14)
        err = float((solve(lam, mu) - ud).abs().max())
        iters = int(solve.solver.last_cg_iters[0].max())
        # atol 1e-8 (tests/test_forward_parity.py:111-119) on Cook's, whose
        # max |u| is ~6; 1e-10 of max |u| on the box (max |u| ~135)
        tol = 1e-8 if sec.stype == 2 else 1e-10 * float(ud.abs().max())
        if not err <= tol:
            fail(f"Jacobi-PCG f64 vs dense at {name}: max abs err {err} > {tol:g}")
        msg = (f"[19 jacobi-pcg] ok: {name} f64 CG tol 1e-14 vs dense spectral, max abs err "
               f"{err:.2e} (tol {tol:.2g}), {iters} iterations")
        if sec.stype == 2:
            solve32 = make_solver(mf, factor_dtype=f32, refine_iters=3, cg_tol=1e-6)
            u32 = solve32(lam, mu)
            rel = float(((u32 - ud).norm(dim=-1) / ud.norm(dim=-1)).max())
            if not rel < 1e-9:
                fail(f"Jacobi-PCG f32 + 3 refinements vs dense at {name}: rel err {rel}")
            msg += (f"; f32 CG tol 1e-6 + 3 refinements rel err {rel:.2e} (tol 1e-9), "
                    f"iterations {[int(i.max()) for i in solve32.solver.last_cg_iters]}")
        print(msg, flush=True)

    # 20. the element-path two-level solve at 160x80 against the JAX golden
    #     and against the stencil path on the same thetas, the trainer's
    #     setting (f32 CG tol 3e-3, maxiter 400, one f64 refinement)
    with open(os.path.join(ROOT, "tests", "fixtures", "scaled_160x80_golden.json")) as f:
        gold = json.load(f)
    nx, ny, r = (gold["mesh"][k] for k in ("nx", "ny", "ratio"))
    model = build_fem_model(meshes.cooks_membrane_mesh(nx, ny), device=dev, dense=False)
    coarse = build_fem_model(meshes.cooks_membrane_mesh(nx // r, ny // r), device=dev, dense=True)
    probe = gold["probe"]
    cfg = dataclasses.replace(ProblemConfig(), node_id=probe["node_id"], ele_id=probe["ele_id"],
                              nipt_id=tuple(probe["nipt_id"]))
    thetas = torch.as_tensor(gold["thetas"], dtype=torch.float64, device=dev)
    y_gold, h_gold = (torch.as_tensor(gold[k], dtype=torch.float64, device=dev) for k in "yh")
    paths = {}
    for use_stencil in (False, True):
        solve = make_two_level_solver(model, coarse, nx // r, ny // r, r, cg_dtype=f32,
                                      refine_iters=1, tol=3e-3, maxiter=400,
                                      use_stencil=use_stencil)
        fh = make_fh_fun(model, cfg, solve_free=solve)
        with torch.no_grad():
            y, h = fh(thetas)
        paths[use_stencil] = {"fh": fh, "solve": solve, "y": y, "h": h,
                              "iters": [float(it.double().mean()) for it in
                                        solve.solver.last_cg_iters]}
    el, st = paths[False], paths[True]
    errs = (rel_err(el["y"], y_gold), rel_err(el["h"], h_gold))
    errs_st = (rel_err(el["y"], st["y"]), rel_err(el["h"], st["h"]))
    if not max(errs) <= 1e-6:
        fail(f"element two-level vs JAX golden: rel err (y, h) {errs} > 1e-6")
    if not max(errs_st) <= 1e-6:
        fail(f"element two-level vs stencil two-level: rel err (y, h) {errs_st} > 1e-6")
    if not all(abs(e - s) <= 0.1 * s for e, s in zip(el["iters"], st["iters"])):
        fail(f"element vs stencil mean CG iterations per run {el['iters']} vs {st['iters']}: "
             "more than 10 % apart")
    print(f"[20 element two-level] ok: 160x80 f32 CG (tol 3e-3) + 1 f64 refinement, element path "
          f"vs JAX f64 golden rel err y {errs[0]:.3e}, h {errs[1]:.3e} (tol 1e-6); vs the stencil "
          f"path y {errs_st[0]:.3e}, h {errs_st[1]:.3e} (tol 1e-6); mean CG iterations per run "
          f"element {el['iters']}, stencil {st['iters']} (within 10 %)", flush=True)

    # 21. the element-path adjoint at 40x20 (coarse 10x5) against the dense
    #     spectral solve, f64, phase 10's bounds
    fine40 = build_fem_model(meshes.cooks_membrane_mesh(40, 20), device=dev, dense=True)
    coarse10 = build_fem_model(meshes.cooks_membrane_mesh(10, 5), device=dev, dense=True)
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 64), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 64), device=dev)
    wv = torch.as_tensor(rng.normal(size=(64, fine40.ndof)), device=dev) * fine40.free_mask
    vals, grads = [], []
    for solve in (make_two_level_solver(fine40, coarse10, 10, 5, 4, cg_dtype=f32,
                                        refine_iters=1, tol=3e-3, maxiter=400),
                  make_solver(fine40)):
        a, mm = lam.clone().requires_grad_(True), mu.clone().requires_grad_(True)
        J = (solve(a, mm) * wv).sum(-1)
        vals.append(J.detach())
        grads.append(torch.stack(torch.autograd.grad(J.sum(), (a, mm)), -1))
    adj = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    if not (adj[0] <= 1e-7 and adj[1] <= 1e-6):
        fail(f"element two-level adjoint vs dense at 40x20: rel err (value, grad) {adj} > "
             "(1e-7, 1e-6)")
    print(f"[21 element adjoint] ok: 40x20 element two-level (f32 CG + 1 f64 refinement) vs "
          f"dense spectral f64, 64 probe functionals: value rel err {adj[0]:.3e} (tol 1e-7), "
          f"d/d(lam, mu) {adj[1]:.3e} (tol 1e-6)", flush=True)

    # 22. the main path: examples/train_scaled_rom_torch.py -- the certified
    #     reduced basis at 160x80, the two-step trainer through it, and the
    #     full-order spot check through the element-path two-level solver
    example = load_example("train_scaled_rom_torch")
    rom_model, rom_cfg = example.build(nx, ny, dev)
    if (rom_cfg.node_id, rom_cfg.ele_id, list(rom_cfg.nipt_id)) != \
            (probe["node_id"], probe["ele_id"], probe["nipt_id"]):
        fail(f"the ROM example's probes {rom_cfg} are not the golden's {probe}")
    tic = time.perf_counter()
    rb = build_reduced_basis(rom_model, tol=1e-10)
    rb_s = time.perf_counter() - tic
    if not rb.max_rel_residual < 1e-10:
        fail(f"reduced basis at 160x80: max relative residual {rb.max_rel_residual} >= 1e-10")
    fh_rom = make_fh_fun_rom(rom_model, rb, rom_cfg)
    with torch.no_grad():
        y, h = fh_rom(thetas)
    rom_errs = (rel_err(y, y_gold), rel_err(h, h_gold))
    if not max(rom_errs) < 1e-5:
        fail(f"ROM fh vs JAX golden: rel err (y, h) {rom_errs} >= 1e-5")
    before = trace.counters()
    summary = example.train_and_check(rom_model, rom_cfg, rb, nx, ny, n_data=256, epochs1=2,
                                      epochs2=2, seed=0, device=dev, verbose=False)
    torch.cuda.synchronize()
    out["element_launches"] = launched("element_affine", before)
    out["spectral_launches"] = launched("spectral_apply", before)
    losses = np.concatenate([summary["hist_step1"], summary["hist_step2"]])
    if not np.all(np.isfinite(losses)):
        fail(f"ROM trainer: non-finite losses: step1 {summary['hist_step1']}, step2 "
             f"{summary['hist_step2']}")
    if not summary["spot_rel_err"] < example.SPOT_TOL:
        fail(f"ROM vs element-path full-order spot check: rel err {summary['spot_rel_err']} >= "
             f"{example.SPOT_TOL}")
    if out["element_launches"] <= 0 or out["spectral_launches"] <= 0:
        fail(f"the ROM example's path launched element {out['element_launches']}, spectral "
             f"{out['spectral_launches']} times; both must be > 0")
    print(f"[22 rom] ok: 160x80 reduced basis r={rb.r}, max relative residual "
          f"{rb.max_rel_residual:.2e} (< 1e-10), built in {rb_s:.2f} s on the host; ROM fh vs JAX "
          f"golden rel err y {rom_errs[0]:.3e}, h {rom_errs[1]:.3e} (tol 1e-5); trainer n=256 x "
          f"ne_sam 4, 2 + 2 epochs: step1 losses {summary['hist_step1']}, step2 losses "
          f"{summary['hist_step2']}; spot check at 16 posterior means rel err "
          f"{summary['spot_rel_err']:.3e} (tol 1e-5), CG iterations {summary['spot_cg_iters']}; "
          f"kernel launches element {out['element_launches']}, spectral "
          f"{out['spectral_launches']}", flush=True)

    # 23. times (records, not a claim), each beside the card's name and limit
    th = torch.randn((256, 2), generator=torch.Generator().manual_seed(5),
                     dtype=torch.float64).to(dev)
    # the element path's own run: one batch
    before = launched("element_affine")
    with torch.no_grad():
        paths[False]["fh"](th)
    torch.cuda.synchronize()
    out["element_fh_launches"] = launched("element_affine") - before
    if out["element_fh_launches"] <= 0:
        fail("the element-path fh batch never launched the element kernel")
    print(f"[23 launches] element-path two-level fh (160x80, B=256), one batch: element kernel "
          f"{out['element_fh_launches']}", flush=True)
    for use_stencil in (False, True):
        fh, solve = paths[use_stencil]["fh"], paths[use_stencil]["solve"]
        dt = wall_s(lambda: fh(th), 3)
        its = torch.stack(solve.solver.last_cg_iters).double()
        run_iters = float(its.max(1).values.sum())  # the batch runs until its slowest lane stops
        print(f"[23 times] {'stencil' if use_stencil else 'element'}-path two-level fh (160x80, "
              f"B=256, f32 CG + 1 f64 refinement): {256 / dt:.1f} solves/s ({dt * 1e3:.1f} ms a "
              f"batch, {dt * 1e3 / run_iters:.3f} ms per CG iteration over {run_iters:.0f}); CG "
              f"iterations per solve (first CG, refinement CG) mean {its.mean(1).tolist()}, max "
              f"{its.max(1).values.tolist()}, on {card}", flush=True)
    dt = wall_s(lambda: fh_rom(th), 100, warmup=5)
    print(f"[23 times] ROM fh (160x80, r={rb.r}, B=256): {256 / dt:.0f} solves/s "
          f"({dt * 1e3:.3f} ms a batch), on {card}", flush=True)
    return out


def study_path(dev, card):
    """Phases 24-27: the stencil-kernel study (kernels #3, #6 and #7, and
    examples/stencil_kernel_study_torch.py at 160x80, B = 256)."""
    import tempfile

    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.peak_probe import (
        fma_peak_probe,
        fma_peak_probe_reference,
        fma_probe_flops,
    )
    from vbicm_tpu_torch.ops.stencil import StencilOperator, build_stencil_tables
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_reference
    from vbicm_tpu_torch.ops.stencil_mxu import (
        KDIM,
        MODES,
        band_flops,
        band_table_bytes,
        launch_plan,
        n_tiles,
        pack_w_bands,
        stencil_affine_matvec_mxu,
        stencil_affine_mxu_reference,
    )
    from vbicm_tpu_torch.utils import trace

    out = {}
    f32, f64 = torch.float32, torch.float64
    # 24. a forced rows_per_block against the plain version (REL_TOL) and
    #     bitwise against the launch plan's rows, on the same inputs
    before = launched("stencil_affine_rows")
    ops, tables, worst = {}, {}, {}
    for nx, ny in STENCIL_GRIDS:
        model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
        W = build_stencil_tables(model, nx, ny)
        ops[nx, ny] = op = StencilOperator(model, nx, ny, W=W)
        tables[nx, ny] = W
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + nx + 24)
            u64 = torch.as_tensor(rng.normal(size=(B, model.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (f32, f64):
                u, c = u64.to(dtype), c64.to(dtype)
                qp = stencil_affine_reference(op.W[dtype], c, u)
                q1 = op.affine(c, u)
                for rpp in ROWS_PER_BLOCK:
                    qr = op.affine(c, u, rows_per_block=rpp)
                    torch.cuda.synchronize()
                    err = rel_err(qr, qp)
                    if not err <= REL_TOL[dtype]:
                        fail(f"rows_per_block={rpp} vs plain at {nx}x{ny} B={B} {dtype}: "
                             f"rel err {err}")
                    if not torch.equal(q1, qr):
                        fail(f"rows_per_block={rpp} vs the plan's rows at {nx}x{ny} B={B} "
                             f"{dtype}: max abs diff {float((q1 - qr).abs().max())}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    if (nx, B, rpp) == (*STENCIL_MAIN, 3) and dtype == f32:
                        out["rows_abs_err"] = float((qr - qp).abs().max())
            if (nx, B) == STENCIL_MAIN:
                main_case = (c64, u64)
    rows_checked = launched("stencil_affine_rows") - before
    if rows_checked <= 0:
        fail("phase 24 launched the rows-per-block kernel no time")
    print(f"[24 rows-per-block] ok: max rel err vs plain f32 {worst[f32]:.3e} (tol 2e-5), f64 "
          f"{worst[f64]:.3e} (tol 1e-12), and bitwise equal to the plan's rows, over grids "
          f"{STENCIL_GRIDS} x B in {STENCIL_BATCHES} x rows_per_block in {ROWS_PER_BLOCK} "
          f"({rows_checked} launches)", flush=True)
    op = ops[STENCIL_MAIN[0], STENCIL_MAIN[0] // 2]
    c64, u64 = main_case
    out["rows_ms"], out["stencil_bound"] = {}, {}
    for dtype in (f32, f64):
        u, c = u64.to(dtype), c64.to(dtype)
        if dtype == f32:
            out["stencil_bound"] = stencil_least_time(op.planes[dtype], c, u)
        times = {}
        for rpp in (None, 1, 3, 8, None):  # device time; the plan's rows first and last
            ms = graph_ms(lambda rpp=rpp: op.affine(c, u, rows_per_block=rpp))
            times[rpp] = min(times.get(rpp, ms), ms)
        p_ms = graph_ms(lambda: stencil_affine_reference(op.W[dtype], c, u), reps=5, replays=2)
        out["rows_ms"][dtype] = (times, p_ms)
        print(f"[24 times] stencil matvec (B=256, 160x80) {dtype}, device time: rows_per_block "
              f"3 {times[3]:.4f} ms, 8 {times[8]:.4f} ms, 1 {times[1]:.4f} ms, the plan's "
              f"{times[None]:.4f} ms, plain {p_ms:.4f} ms; bound {out['stencil_bound'][0]:.4f} "
              f"ms ({out['stencil_bound'][1]}, f32), on {card}", flush=True)

    # 25. the banded tensor-core kernel against its plain version and the
    #     float64 stencil, both modes, two calls bitwise equal
    before = launched("stencil_mxu")
    worst = {}
    for (nx, ny), W in tables.items():
        NY, NX = ny + 1, nx + 1
        m_all = {"f32": pack_w_bands(W, "f32").to(dev),
                 "bf16x3": tuple(m.to(dev) for m in pack_w_bands(W, "bf16x3"))}
        for B in MXU_BATCHES:
            rng = np.random.default_rng(B + nx + 25)
            u64 = torch.as_tensor(rng.normal(size=(B, 2 * NY * NX)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            q64 = stencil_affine_reference(ops[nx, ny].W[f64], c64, u64)
            u, c = u64.to(f32), c64.to(f32)
            for mode in MODES:
                q = stencil_affine_matvec_mxu(m_all[mode], c, u, NY, NX, mode)
                q2 = stencil_affine_matvec_mxu(m_all[mode], c, u, NY, NX, mode)
                qp = stencil_affine_mxu_reference(m_all[mode], c, u, NY, NX, mode)
                torch.cuda.synchronize()
                errs = (rel_err(q, qp), rel_err(q.to(f64), q64))
                if not (errs[0] <= MXU_TOL_PLAIN and errs[1] <= MXU_TOL_EXACT[mode]):
                    fail(f"banded kernel {mode} at {nx}x{ny} B={B}: rel err (of max|q|) vs plain "
                         f"{errs[0]}, vs f64 {errs[1]}; bounds {MXU_TOL_PLAIN}, "
                         f"{MXU_TOL_EXACT[mode]}")
                if not torch.equal(q, q2):
                    fail(f"banded kernel {mode} at {nx}x{ny} B={B}: two calls are not bitwise "
                         "equal")
                w = worst.setdefault(mode, [0.0, 0.0])
                w[0], w[1] = max(w[0], errs[0]), max(w[1], errs[1])
                if (nx, B) == STENCIL_MAIN:
                    out.setdefault("mxu_abs_err", {})[mode] = float((q - qp).abs().max())
        if (nx, ny) == (STENCIL_MAIN[0], STENCIL_MAIN[0] // 2):
            main_tables = m_all
        del m_all
    if launched("stencil_mxu") - before <= 0:
        fail("phase 25 launched the banded kernel no time")
    print(f"[25 banded] ok: rel err (of max|q|) vs plain / vs f64 stencil: f32 (3xTF32) "
          f"{worst['f32'][0]:.3e} / {worst['f32'][1]:.3e}, bf16x3 {worst['bf16x3'][0]:.3e} / "
          f"{worst['bf16x3'][1]:.3e} (tol {MXU_TOL_PLAIN:g} / {MXU_TOL_EXACT}) over grids "
          f"{STENCIL_GRIDS} (T = 1, 1, 3) x B in {MXU_BATCHES}; two calls bitwise equal",
          flush=True)
    c64, u64 = main_case
    u, c = u64.to(f32), c64.to(f32)
    B = u.shape[0]
    NY, NX = STENCIL_MAIN[0] // 2 + 1, STENCIL_MAIN[0] + 1
    dense_flops = 3 * 2.0 * B * KDIM * 256 * NY * n_tiles(NX)
    uq_bytes = (2 * u.numel() + c.numel()) * 4
    out["mxu_ms"] = {}
    for mode, unit in (("bf16x3", "bf16_tc"), ("f32", "tf32_tc")):
        mb = main_tables[mode]
        tbytes = sum(t.numel() * t.element_size() for t in (mb if mode == "bf16x3" else (mb,)))
        band_bytes, flops = band_table_bytes(NY, NX, mode), band_flops(B, NY, NX, mode)
        band = least_time(band_bytes + uq_bytes, flops, unit=unit)
        dense = least_time(tbytes + uq_bytes, dense_flops, unit=unit)
        t = kernel_times(lambda: stencil_affine_matvec_mxu(mb, c, u, NY, NX, mode),
                         lambda: stencil_affine_mxu_reference(mb, c, u, NY, NX, mode),
                         out["stencil_bound"])
        t.update(bound_ms_band=band[0], bound_by_band=band[1],
                 share_of_band_bound=band[0] / t["ms"], bound_ms_densified=dense[0],
                 bound_by_densified=dense[1], groups=launch_plan(B, NY, NX, mode)[0])
        out["mxu_ms"][mode] = t
        print(f"[25 times] banded stencil (B=256, 160x80) {mode}, {t['groups']} sample-tile "
              f"groups: device kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager "
              f"kernel {t['ms_eager']:.4f} ms; band-block bound {band[0]:.4f} ms ({band[1]}: "
              f"{band_bytes / 1e6:.2f} MB of band blocks at 32-byte sectors + "
              f"{uq_bytes / 1e6:.2f} MB of u, q, coeffs; {flops / 1e9:.3f} GFLOP on {unit}), "
              f"{100 * t['share_of_band_bound']:.1f} % of it; the function's bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['share_of_bound']:.1f} % of "
              f"it; densified bound {dense[0]:.4f} ms ({dense[1]}: {tbytes / 1e6:.1f} MB of "
              f"tables, {dense_flops / 1e9:.2f} GFLOP), on {card}", flush=True)
    del main_tables

    # 26. the FMA-ceiling probe against its plain version, inputs in
    #     (-0.9, 0.9) so that the chain stays bounded; the kernel contracts
    #     each step to one FMA, the plain version rounds twice
    before = launched("fma_probe")
    worst = {}
    for B, NY, XLP in PROBE_SHAPES:
        g = torch.Generator().manual_seed(B + NY)
        a64 = (torch.rand((B, NY * XLP), generator=g, dtype=f64) * 1.8 - 0.9).to(dev)
        b64 = (torch.rand((B, XLP), generator=g, dtype=f64) * 1.8 - 0.9).to(dev)
        for dtype in (f32, f64):
            a, b = a64.to(dtype), b64.to(dtype)
            for nfma in (0, 5, 42):
                o = fma_peak_probe(a, b, nfma)
                r = fma_peak_probe_reference(a, b, nfma)
                torch.cuda.synchronize()
                err = rel_err(o, r)
                if not err <= REL_TOL[dtype]:
                    fail(f"probe vs plain at {(B, NY, XLP)} nfma={nfma} {dtype}: rel err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if (B, NY, XLP) == PROBE_MAIN and dtype == f32 and nfma == 42:
                    out["probe_abs_err"] = float((o - r).abs().max())
            if (B, NY, XLP) == PROBE_MAIN:
                probe_case = (a64, b64)
    if launched("fma_probe") - before <= 0:
        fail("phase 26 launched the probe no time")
    print(f"[26 probe] ok: max rel err vs plain (of max|out|) f32 {worst[f32]:.3e} (tol 2e-5), "
          f"f64 {worst[f64]:.3e} (tol 1e-12) over (B, NY, XLP) in {PROBE_SHAPES} x nfma in "
          f"(0, 5, 42)", flush=True)
    a64, b64 = probe_case
    out["probe_ms"] = {}
    for dtype, unit in ((f32, "fp32"), (f64, "fp64")):
        a, b = a64.to(dtype), b64.to(dtype)
        nbytes = (2 * a.numel() + b.numel()) * a.element_size()
        for nfma in (42, 4096):
            flops = fma_probe_flops(*PROBE_MAIN, nfma)
            k_ms = time_ms(lambda: fma_peak_probe(a, b, nfma), warmup=5, reps=50)
            p_ms = (time_ms(lambda: fma_peak_probe_reference(a, b, nfma), warmup=2, reps=10)
                    if nfma == 42 else None)
            bound = least_time(nbytes, flops, dtype)
            out["probe_ms"][unit, nfma] = (k_ms, p_ms, bound, flops / k_ms / 1e9)
            print(f"[26 times] probe {PROBE_MAIN} {dtype} nfma {nfma}: kernel {k_ms:.4f} ms "
                  f"({flops / k_ms / 1e9:.2f} TFLOP/s), plain "
                  f"{'not timed' if p_ms is None else f'{p_ms:.4f} ms'}; bound {bound[0]:.4f} ms "
                  f"({bound[1]}), on {card}", flush=True)

    # 27. the main path: examples/stencil_kernel_study_torch.py at 160x80,
    #     B = 256, into a temporary results directory
    example = load_example("stencil_kernel_study_torch")
    before = trace.counters()
    with tempfile.TemporaryDirectory() as tmp:
        summary = example.main(["--device", "cuda", "--results", tmp, "--reps", "20"])
        torch.cuda.synchronize()
        with open(os.path.join(tmp, "summary.json")) as fh:
            if json.load(fh)["verdict"] != json.loads(json.dumps(summary["verdict"])):
                fail("the study's summary.json does not hold its verdict")
    (out["onerow_launches"], out["rows_launches"], out["mxu_launches"],
     out["probe_launches"]) = (launched(k, before) for k in (
         "stencil_affine", "stencil_affine_rows", "stencil_mxu", "fma_probe"))
    if min(out["rows_launches"], out["mxu_launches"], out["probe_launches"]) <= 0:
        fail(f"the study launched rows-per-block {out['rows_launches']}, banded "
             f"{out['mxu_launches']}, probe {out['probe_launches']} times; all must be > 0")
    for key, rec in summary["impls"].items():
        bound = 5e-5 if key == "mxu_bf16x3" else 5e-6
        if not (math.isfinite(rec["ms"]) and rec["rel_err_vs_f64"] <= bound):
            fail(f"study {key}: {rec['ms']} ms, rel err (of norms) vs f64 {rec['rel_err_vs_f64']} "
                 f"> {bound}")
        print(f"[27 study] {key}: {rec['ms']:.4f} ms, rel err (of norms) vs f64 "
              f"{rec['rel_err_vs_f64']:.2e} (tol {bound:g}), {rec['band_tflops']:.3f} band TFLOP/s, "
              f"hbm share {rec.get('hbm_utilization')}, on {card}", flush=True)
    v = summary["verdict"]
    print(f"[27 study] ok: FMA ceilings {summary['fma_ceiling_tflops']} TFLOP/s; ridge "
          f"{v['ridge_flops_per_byte_measured_fp32']:.2f} flops/byte measured "
          f"({v['ridge_flops_per_byte_datasheet_fp32']:.1f} data sheet), stencil intensity "
          f"{v['stencil_band_intensity_flops_per_byte']:.2f}: bound by {v['stencil_bound_by']}; "
          f"fastest {v['fastest']}, banded beats one-row: {v['banded_beats_onerow']}; kernel "
          f"launches one-row {out['onerow_launches']}, rows {out['rows_launches']}, banded "
          f"{out['mxu_launches']}, probe {out['probe_launches']}; verdict {json.dumps(v['impls'])}",
          flush=True)
    out["study"] = summary
    return out


def box3d_path(dev, card):
    """Phases 13-17: the 3-D hex8 box (the 32x8x8 trainer and the 64x16x16
    solve)."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig, SectionCard, TrainConfig
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import launch_plan_3d, stencil3d_affine_reference
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver_box3d
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    sec = SectionCard(stype=4)
    out = {}

    # 13. the 3-D stencil kernel against its plain version, ragged tiles
    worst, ops, cases, models = {}, {}, {}, {}
    for cells in BOX_GRIDS:
        models[cells] = m = build_fem_model(beam_hex8_mesh(*cells), sec, device=dev, dense=False)
        ops[cells] = op = StencilOperator3d(m, *cells)
        W = {dt: op.W.to(dev, dt) for dt in (torch.float32, torch.float64)}  # the plain operand
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + cells[0])
            u64 = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (torch.float32, torch.float64):
                u, c = u64.to(dtype), c64.to(dtype)
                q, q2 = op.affine(c, u), op.affine(c, u)
                qr = stencil3d_affine_reference(W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"3-D stencil kernel vs plain at {cells} B={B} {dtype}: rel err {err}")
                if not torch.equal(q, q2):
                    fail(f"3-D stencil kernel at {cells} B={B} {dtype}: two calls differ")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (cells, B) == BOX_MAIN:
                    out["stencil3d_abs_err"] = float((q - qr).abs().max())
            if B == 256:
                cases[cells] = (c64, u64)
        del W
    print(f"[13 stencil3d] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12), two calls bitwise equal, "
          f"over grids {BOX_GRIDS} x B in {STENCIL_BATCHES}", flush=True)

    # 14. the box two-level solve against the JAX package's f64 golden. Two
    #     refinements are held to 1e-6 for "train" as for "bench". The
    #     trainer's own solver (one refinement, the fh phase 16 trains
    #     through) leaves ~tol^2 = 9e-6 and is held to 1e-4; the solve
    #     without refinement, which that bound must tell apart from it, is
    #     recorded.
    with open(os.path.join(ROOT, "tests", "fixtures", "scaled_3d_golden.json")) as f:
        gold = json.load(f)
    thetas = torch.as_tensor(gold["thetas"], dtype=torch.float64, device=dev)
    fhs = {}
    bounds = {1: 1e-4, 2: 1e-6}  # by refinements; the solve without one is recorded
    for name, refines, maxiter in (("train", (0, 1, 2), 400), ("bench", (2,), 1500)):
        g = gold[name]["mesh"]
        nx, ny, nz, r = g["nx"], g["ny"], g["nz"], g["ratio"]
        mesh_kw = {"lx": g["lx"], "tip_force": tuple(g["tip_force"])}
        model = build_fem_model(beam_hex8_mesh(nx, ny, nz, **mesh_kw), sec, device=dev,
                                dense=False)
        cells_c = (nx // r, ny // r, nz // r)
        coarse = build_fem_model(beam_hex8_mesh(*cells_c, **mesh_kw), sec, device=dev,
                                 dense=True)
        # the 3-D trainer's probes (examples/train_scaled_3d_torch.py)
        probe = gold[name]["probe"]
        cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=probe["node_id"],
                                  ele_id=probe["ele_id"], nipt_id=tuple(probe["nipt_id"]))
        y_gold, h_gold = (torch.as_tensor(gold[name][k], dtype=torch.float64, device=dev)
                          for k in ("y", "h"))
        for refine in refines:
            solve = make_two_level_solver_box3d(model, coarse, cells_c, r,
                                                cg_dtype=torch.float32, refine_iters=refine,
                                                tol=3e-3, maxiter=maxiter)
            fh = make_fh_fun(model, cfg, solve_free=solve)
            fhs[name, refine] = {"cfg": cfg, "fh": fh, "solve": solve}
            with torch.no_grad():
                y, h = fh(thetas)
                iters = [it.tolist() for it in solve.solver.last_cg_iters]
                tm, ts = cfg.theta_map.theta_mean, cfg.theta_map.theta_std
                c0, c1 = lame_from_Ev(torch.exp(ts[0] * thetas[:, 0] + tm[0]),
                                      0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1]))
                u = solve(c0, c1)
                ke = torch.stack([model.ke_lam, model.ke_mu])
                b = (model.f_ext * model.free_mask).expand(u.shape[0], -1)
                res = (b - element_affine_matvec(ke, model.lm, torch.stack([c0, c1], -1), u,
                                                 model.ndof)) * model.free_mask
                rel_res = float((res.norm(dim=-1) / b.norm(dim=-1)).max())
            errs = (rel_err(y, y_gold), rel_err(h, h_gold))
            bound = bounds.get(refine)
            if bound is not None and not max(errs) <= bound:
                fail(f"box two-level {name} ({nx}x{ny}x{nz}) vs JAX golden: rel err (y, h) "
                     f"{errs} > {bound:g} with {refine} refinement(s); CG iterations {iters}; "
                     f"max relative residual {rel_res:.3e}")
            print(f"[14 box3d] {'record' if bound is None else 'ok'}: {name} {nx}x{ny}x{nz} "
                  f"({model.ndof} dofs) f32 CG (tol 3e-3) + {refine} f64 refinement(s) vs JAX "
                  f"f64 golden, rel err y {errs[0]:.3e}, h {errs[1]:.3e}"
                  f"{'' if bound is None else f' (tol {bound:g})'}; max relative residual "
                  f"(element matvec, f64) {rel_res:.3e}; CG iterations per lane {iters}",
                  flush=True)

    # 15. adjoint at 8x4x4 (coarse 4x2x2, 675 dofs) against the dense solve,
    #     with two refinements as phase 14's check (one leaves ~tol^2)
    fine8 = build_fem_model(beam_hex8_mesh(8, 4, 4), sec, device=dev, dense=True)
    coarse4 = build_fem_model(beam_hex8_mesh(4, 2, 2), sec, device=dev, dense=True)
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 64), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 64), device=dev)
    wv = torch.as_tensor(rng.normal(size=(64, fine8.ndof)), device=dev) * fine8.free_mask
    vals, grads = [], []
    for solve in (make_two_level_solver_box3d(fine8, coarse4, (4, 2, 2), 2,
                                              cg_dtype=torch.float32, refine_iters=2, tol=3e-3,
                                              maxiter=400),
                  make_solver(fine8)):
        a, m = lam.clone().requires_grad_(True), mu.clone().requires_grad_(True)
        J = (solve(a, m) * wv).sum(-1)
        vals.append(J.detach())
        grads.append(torch.stack(torch.autograd.grad(J.sum(), (a, m)), -1))
    adj = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    if not (adj[0] <= 1e-7 and adj[1] <= 1e-6):
        fail(f"box two-level adjoint vs dense at 8x4x4: rel err (value, grad) {adj} > "
             "(1e-7, 1e-6)")
    print(f"[15 box3d adjoint] ok: 8x4x4 box two-level (f32 CG + 2 f64 refinements) vs dense "
          f"spectral f64, 64 probe functionals: value rel err {adj[0]:.3e} (tol 1e-7), "
          f"d/d(lam, mu) {adj[1]:.3e} (tol 1e-6)", flush=True)

    # 16. the 3-D main path: dataset generation and the two-step trainer at
    #     32x8x8 through the box two-level observation operator
    cfg, fh = fhs["train", 1]["cfg"], fhs["train", 1]["fh"]
    tcfg = TrainConfig(batch_size=64, num_epoch1=2, num_epoch2=2, lr_decay_mode="fixed",
                       pairing="per_sample")
    before = trace.counters()
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           d_y=3, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=512)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev,
                             y_norm=(ds.y_mean, ds.y_std), bridge_chunk=512)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out["spectral_launches"] = launched("spectral_apply", before)
    out["stencil3d_launches"] = launched("stencil3d_affine", before)
    out["trained"] = (cfg, fh, trainer, res, ds)  # for the refinement of eval_path
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"3-D trainer: non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("3-D predict: outputs not finite (8, 2) tensors")
    if out["spectral_launches"] <= 0 or out["stencil3d_launches"] <= 0:
        fail(f"the 3-D trainer launched spectral {out['spectral_launches']}, stencil3d "
             f"{out['stencil3d_launches']} times; both must be > 0")
    print(f"[16 box3d trainer] ok: 32x8x8, n=256 x ne_sam 4, 2 + 2 epochs at batch 64, y_norm, "
          f"per-sample pairing; step1 losses {res.hist_step1.tolist()}, step2 losses "
          f"{res.hist_step2.tolist()}; kernel launches stencil3d {out['stencil3d_launches']}, "
          f"spectral {out['spectral_launches']}", flush=True)

    # 17. times (records, not a claim), each beside the card's name and limit
    steps = math.ceil(ds.n_sam / tcfg.batch_size) * (tcfg.num_epoch1 - 1)
    print(f"[17 times] 3-D step-1 train steps/s (32x8x8, B=64x4, f32 CG + 1 f64 refinement, "
          f"epoch 2): {steps / sum(res.epoch_times_step1[1:]):.3f} on {card}", flush=True)
    out["stencil3d_ms"] = {}
    for cells in ((32, 8, 8), (64, 16, 16)):
        op = ops[cells]
        c64, u64 = cases[cells]
        for dtype in (torch.float32, torch.float64):
            u, c, W = u64.to(dtype), c64.to(dtype), op.W.to(dev, dtype)
            t = kernel_times(lambda: op.affine(c, u),
                              lambda: stencil3d_affine_reference(W, c, u),
                              stencil_least_time(op.planes[dtype], c, u))
            K, uT = assembled_csr(models[cells], dtype), u.T.contiguous()
            lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
            if not lib_err <= REL_TOL[dtype]:
                fail(f"cuSPARSE yardstick vs 3-D stencil kernel at {cells} {dtype}: rel err "
                     f"{lib_err}")
            t["library_ms"] = time_ms(lambda: library_affine(K, c, uT), warmup=3, reps=20)
            del K, uT, W
            out["stencil3d_ms"][cells, dtype] = t
            plan = launch_plan_3d(u.shape[0], cells[2] + 1, cells[1] + 1, 3 * (cells[0] + 1),
                                  dtype, dev)
            print(f"[17 times] 3-D stencil matvec (B=256, {cells[0]}x{cells[1]}x{cells[2]}) "
                  f"{dtype}, {plan.samples} samples a thread x {plan.groups} groups, "
                  f"{plan.blocks} blocks: device kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms; "
                  f"eager kernel {t['ms_eager']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), {100 * t['share_of_bound']:.1f} % of it; cuSPARSE "
                  f"yardstick (eager) {t['library_ms']:.4f} ms (rel err {lib_err:.1e}), on "
                  f"{card}", flush=True)
    out["spectral_ms"] = {dtype: spectral_times(BOX_COARSE_SHAPE, dtype, dev, card, 17, 100)
                          for dtype in (torch.float32, torch.float64)}
    refine = 2
    fh, solve = fhs["bench", refine]["fh"], fhs["bench", refine]["solve"]
    f64_ms = out["stencil3d_ms"][(64, 16, 16), torch.float64]["ms"]
    f32_ms = out["stencil3d_ms"][(64, 16, 16), torch.float32]["ms"]
    for B in BOX_FH_BATCHES:
        th = torch.randn((B, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
        dt = wall_s(lambda: fh(th), 3)
        its = torch.stack(solve.solver.last_cg_iters).double()
        share = ""
        if B == BOX_FH_BATCHES[-1]:
            share = (f"; one f64 stencil launch {f64_ms:.4f} ms vs one f32 {f32_ms:.4f} ms, the "
                     f"{refine} f64 residuals {100 * refine * f64_ms / (dt * 1e3):.3f} % of "
                     "the solve")
        print(f"[17 times] box two-level fh (64x16x16, B={B}, f32 CG + {refine} f64 "
              f"refinements): {B / dt:.1f} solves/s ({dt * 1e3:.1f} ms a batch); CG iterations "
              f"per solve (first CG, refinement CGs) mean {its.mean(1).tolist()}, max "
              f"{its.max(1).values.tolist()}{share}, on {card}", flush=True)
    return out


def eval_path(dev, card, box):
    """Phases 28-34: the evaluation layer. On Cook's 20x10 in float64 (the
    spectral kernel): the log-posterior with its gradient and Hessian against
    the plain version, a Metropolis reference chain, HMC against Metropolis,
    the paper's accuracy check of the trained VI posterior against the chain,
    Laplace against its CPU run, and the comparison pipeline; then
    per-observation refinement through the 3-D trainer's solver at 32x8x8
    (the 3-D stencil and spectral kernels). ``box`` is box3d_path's result
    (its trained 32x8x8 model). Returns the launch counts by path."""
    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.eval import comparison as cmp
    from vbicm_tpu_torch.eval.laplace import laplace_posterior
    from vbicm_tpu_torch.eval.mcmc import (
        hmc,
        make_fem_logpost,
        metropolis,
        posterior_predictive_z,
    )
    from vbicm_tpu_torch.eval.postprocess import kld_gaussian_kde, lognormal_pdf_2d
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_batched
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.refine import refine_posterior
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_reference
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import stencil3d_affine_reference

    mark = {}  # the counters at the phase's start

    def phase_start():
        torch.cuda.synchronize()
        mark.update(trace.counters())
        return time.perf_counter()

    def phase_end(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, launched("spectral_apply", mark)

    cfg = ProblemConfig()
    model = build_fem_model(cooks_membrane_mesh(20, 10), device=dev, dtype=torch.float64)
    fh = make_fh_fun(model, cfg)  # float64 apply, as the reference's MCMC
    cpu_fh = make_fh_fun(build_fem_model(cooks_membrane_mesh(20, 10), device="cpu",
                                         dtype=torch.float64), cfg)
    out = {"eval_20x10": 0}

    # 28. the kernels at the evaluation path's shapes against their plain
    #     versions, two calls bitwise equal, and timed where the path spends
    #     its launches
    checks = [(shape, torch.float64, REL_TOL[torch.float64]) for shape in EVAL_SHAPES]
    checks += [(REFINE_COARSE_SHAPE, dt, REL_TOL[dt]) for dt in (torch.float32, torch.float64)]
    worst = 0.0
    for (B, n), dtype, tol in checks:
        V, g, c, b = pencil_problem(B, n, seed=B + n + 28, dtype=dtype, device=dev)
        x, x2 = spectral_apply_batched(V, g, c, b), spectral_apply_batched(V, g, c, b)
        err = rel_err(x, spectral_apply_reference(V, g, c, b))
        if not (err <= tol and torch.equal(x, x2)):
            fail(f"spectral kernel at the evaluation shape {(B, n)} {dtype}: rel err {err} "
                 f"(tol {tol}), two calls equal {torch.equal(x, x2)}")
        worst = max(worst, err / tol)
    m3 = build_fem_model(beam_hex8_mesh(32, 8, 8), SectionCard(stype=4), device=dev, dense=False)
    op3 = StencilOperator3d(m3, 32, 8, 8)
    rng = np.random.default_rng(34)
    u64 = torch.as_tensor(rng.normal(size=(REFINE_BATCH, m3.ndof)), device=dev)
    c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (REFINE_BATCH, 2)), device=dev)
    for dtype in (torch.float32, torch.float64):
        u, c = u64.to(dtype), c64.to(dtype)
        q, q2 = op3.affine(c, u), op3.affine(c, u)
        err = rel_err(q, stencil3d_affine_reference(op3.W.to(dev, dtype), c, u))
        if not (err <= REL_TOL[dtype] and torch.equal(q, q2)):
            fail(f"3-D stencil kernel at 32x8x8, B={REFINE_BATCH} {dtype}: rel err {err}, two "
                 f"calls equal {torch.equal(q, q2)}")
    out["spectral_ms"] = {shape: spectral_times(shape, torch.float64, dev, card, 28, 100)
                          for shape in EVAL_TIMED}
    u, c, W = u64.float(), c64.float(), op3.W.to(dev, torch.float32)
    out["stencil3d_ms"] = kernel_times(lambda: op3.affine(c, u),
                                       lambda: stencil3d_affine_reference(W, c, u),
                                       stencil_least_time(op3.planes[torch.float32], c, u))
    t3 = out["stencil3d_ms"]
    print(f"[28 kernels] ok: spectral kernel vs plain at {EVAL_SHAPES} f64 and "
          f"{REFINE_COARSE_SHAPE} f32, f64 (worst {worst:.3f} of its tolerance), 3-D stencil at "
          f"32x8x8 B={REFINE_BATCH} f32, f64, two calls bitwise equal; 3-D stencil (B="
          f"{REFINE_BATCH}, 32x8x8) f32 device kernel {t3['ms']:.4f} ms, plain "
          f"{t3['plain_ms']:.4f} ms, bound {t3['bound_ms']:.4f} ms ({t3['bound_by']}) on {card}",
          flush=True)

    # 28. the log-posterior, its gradient and its Hessian (the spectral
    #     solve's double backward) at 256 thetas, card against CPU; the
    #     observation is one of a dataset generated on the card (the
    #     statistical test's: n = 1024, 8 seeds an observation)
    t0 = phase_start()
    ds = generate_data_fem(torch.Generator().manual_seed(7), fh, n_sam=1024, ne_sam=8,
                           device=dev, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=4096)
    y_obs = ds.y_data[3]
    th = np.random.default_rng(28).normal(size=(256, 2))
    derivs = {}
    for where, f in ((dev, fh), ("cpu", cpu_fh)):
        lp = make_fem_logpost(f, y_obs, cfg.sig_e)
        q = torch.tensor(th, device=where, requires_grad=True)
        val = lp(q)
        (g,) = torch.autograd.grad(val.sum(), q, create_graph=True)
        H = torch.stack([torch.autograd.grad(g[:, i].sum(), q, retain_graph=True)[0]
                         for i in range(2)], dim=1)
        derivs[str(where)] = [t.detach().cpu() for t in (val, g, H)]
    errs = [rel_err(a, b) for a, b in zip(derivs[str(dev)], derivs["cpu"])]
    dt, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    if not (errs[0] <= 1e-10 and errs[1] <= 1e-10 and errs[2] <= 1e-8) or n1 <= 0:
        fail(f"log-posterior on the card vs CPU: rel err value {errs[0]}, grad {errs[1]} "
             f"(tol 1e-10), Hessian {errs[2]} (tol 1e-8); spectral launches {n1}")
    print(f"[28 logpost] ok: Cook's 20x10 f64, 256 thetas, card vs CPU rel err value "
          f"{errs[0]:.3e}, grad {errs[1]:.3e} (tol 1e-10), Hessian {errs[2]:.3e} (tol 1e-8); "
          f"spectral launches {n1}; {dt:.2f} s (1024-point dataset included)", flush=True)

    # 29. the Metropolis reference chain at the statistical test's size
    t0 = phase_start()
    logpost = make_fem_logpost(fh, y_obs, cfg.sig_e)
    mc, syncs = host_syncs(lambda: metropolis(torch.Generator().manual_seed(9), logpost, d=2,
                                              n_samples=1500, burn=500, n_chains=8,
                                              step_size=0.6, device=dev))
    dt, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    if not (np.all(mc.rhat < 1.05) and np.all(mc.ess > 200)) or n1 <= 0 or syncs > SAMPLER_SYNCS:
        fail(f"Metropolis: R-hat {mc.rhat} (< 1.05), ESS {mc.ess} (> 200), spectral launches "
             f"{n1}, synchronizing calls {syncs} (<= {SAMPLER_SYNCS})")
    s = mc.samples.reshape(-1, 2)
    print(f"[29 metropolis] ok: 8 chains x (500 + 1500) steps, accept {mc.accept_rate:.3f}, "
          f"R-hat {mc.rhat.tolist()} (< 1.05), ESS {mc.ess.tolist()} (> 200), posterior mean "
          f"{s.mean(axis=0).tolist()}; spectral launches {n1}; {syncs} synchronizing calls "
          f"(<= {SAMPLER_SYNCS}); {2000 / dt:.1f} steps/s ({dt:.2f} s) on {card}", flush=True)

    # 30. HMC through the adjoint against Metropolis (tests/test_eval.py)
    t0 = phase_start()
    with torch.no_grad():
        y_clean, _ = fh(torch.tensor([[0.8, 0.2]], dtype=torch.float64, device=dev))
    lp_c = make_fem_logpost(fh, y_clean[0], 1e-2)
    h, syncs = host_syncs(lambda: hmc(torch.Generator().manual_seed(3), lp_c, d=2,
                                      n_samples=400, burn=200, n_chains=4, step_size=0.3,
                                      n_leapfrog=6, device=dev))
    dt_h, n_h = phase_end(t0)
    t0 = phase_start()
    m = metropolis(torch.Generator().manual_seed(4), lp_c, d=2, n_samples=800, burn=300,
                   n_chains=4, step_size=0.3, device=dev)
    dt_m, n_m = phase_end(t0)
    out["eval_20x10"] += n_h + n_m
    hs, ms = h.samples.reshape(-1, 2), m.samples.reshape(-1, 2)
    tol = 5 * (h.mean_mcse() + m.mean_mcse())
    diff = abs(hs[:, 0].mean() - ms[:, 0].mean())
    ratio = hs[:, 0].std() / ms[:, 0].std()
    if not (h.accept_rate > 0.4 and diff < max(tol[0], 0.15) and 0.5 < ratio < 2.0
            and syncs <= SAMPLER_SYNCS):
        fail(f"HMC vs Metropolis: accept {h.accept_rate} (> 0.4), |mean theta_1 diff| {diff} "
             f"(< {max(tol[0], 0.15)}), std ratio {ratio} (0.5, 2), synchronizing calls "
             f"{syncs} (<= {SAMPLER_SYNCS})")
    grads = 600 * 6 + 1  # batched gradient evaluations: L a step and the start's
    print(f"[30 hmc] ok: 4 chains x (200 + 400) steps, L = 6: accept {h.accept_rate:.3f} "
          f"(> 0.4), |mean theta_1 - Metropolis's| {diff:.4f} (< {max(tol[0], 0.15):.4f}), std "
          f"ratio {ratio:.3f} (0.5, 2), {syncs} synchronizing calls (<= {SAMPLER_SYNCS}); "
          f"{grads / dt_h:.1f} gradient evaluations/s of 4 chains "
          f"({4 * grads / dt_h:.1f} chain gradients/s, {dt_h:.2f} s), Metropolis 4 x 1100 steps "
          f"{1100 / dt_m:.1f} steps/s; spectral launches {n_h} + {n_m}; on {card}", flush=True)

    # 31. the paper's accuracy check: the VI posterior trained with
    #     per-sample pairing against the chain of phase 29, and the step-2
    #     predictive against the MCMC posterior predictive, with
    #     tests/test_statistical.py's gates
    t0 = phase_start()
    tcfg = TrainConfig(batch_size=64, num_epoch1=120, num_epoch2=100, pairing="per_sample")
    trainer = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(8))
    dt_train, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    tm, tsig, zm_all, _ = (t.cpu().numpy() for t in trainer.predict(res.theta_net, res.z_net,
                                                                     ds.y_data))
    tm, tsig = tm[3], tsig[3]
    mcse = mc.mean_mcse()
    std_ratio = np.sqrt(tsig[0]) / s[:, 0].std()
    rmse_m = float(np.sqrt(np.mean((zm_all - res.logz_mean_post) ** 2)))
    med = float(np.median(np.exp(zm_all) / ds.z_data))
    t0 = phase_start()
    z_mc = posterior_predictive_z(torch.Generator().manual_seed(11), fh, s[:2000], cfg.sig_eta,
                                  device=dev)
    _, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    logz_gap = np.abs(zm_all[3] - np.log(z_mc).mean(axis=0))
    _, _, zm3, zs3 = (t[0].cpu().numpy() for t in trainer.predict(res.theta_net, res.z_net,
                                                                   ds.y_data[3:4]))
    kld = kld_gaussian_kde(z_mc, lambda p: lognormal_pdf_2d(p, zm3, zs3))
    gates = {
        "theta_1 mean": (abs(tm[0] - s[:, 0].mean()), 0.15 + 5 * mcse[0]),
        "theta_2 mean": (abs(tm[1] - s[:, 1].mean()), 0.4 + 5 * mcse[1]),
        "step-2 log z mean rmse": (rmse_m, 0.08),
        "predictive log z vs MCMC": (float(logz_gap.max()), 0.25),
    }
    bands = {"theta_2 std": (np.sqrt(tsig[1]), 0.6, 1.4), "theta_1 std ratio":
             (std_ratio, 0.5, 1.6), "median exp(z_mean) / z": (med, 0.5, 2.0)}
    bad = [k for k, (v, b) in gates.items() if not v < b]
    bad += [k for k, (v, lo, hi) in bands.items() if not lo < v < hi]
    line = "; ".join([f"{k} {v:.4f} (< {b:.4f})" for k, (v, b) in gates.items()]
                     + [f"{k} {v:.4f} ({lo}, {hi})" for k, (v, lo, hi) in bands.items()])
    if bad:
        fail(f"VI vs MCMC (tests/test_statistical.py's gates): {bad} failed: {line}")
    print(f"[31 vi vs mcmc] ok: n = 1024, ne = 8, 120 + 100 epochs at B = 64, f64, per-sample "
          f"pairing, trained in {dt_train:.2f} s; VI theta {tm.tolist()} std "
          f"{np.sqrt(tsig).tolist()}, MCMC mean {s.mean(axis=0).tolist()} std "
          f"{s.std(axis=0).tolist()}; {line}; KLD(MCMC || VI) {kld:.4f}; on {card}", flush=True)

    # 32. Laplace at phase 29's observation, card against CPU
    t0 = phase_start()
    lap = laplace_posterior(logpost, torch.zeros(2, dtype=torch.float64, device=dev), tol=1e-7)
    dt, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    lap_cpu = laplace_posterior(make_fem_logpost(cpu_fh, y_obs, cfg.sig_e),
                                torch.zeros(2, dtype=torch.float64), tol=1e-7)
    mode_err = float(np.abs(lap.theta_map - lap_cpu.theta_map).max())
    cov_err = float(np.abs(lap.cov - lap_cpu.cov).max())
    if not (lap.converged and mode_err <= 1e-6 and cov_err <= 1e-6) or n1 <= 0:
        fail(f"Laplace: converged {lap.converged} (|grad| {lap.grad_norm}), card vs CPU mode "
             f"{mode_err}, cov {cov_err} (tol 1e-6), spectral launches {n1}")
    print(f"[32 laplace] ok: mode {lap.theta_map.tolist()}, |grad| {lap.grad_norm:.2e} "
          f"(tol 1e-7), Hessian positive definite, cov {lap.cov.tolist()}; card vs CPU mode "
          f"{mode_err:.2e}, cov {cov_err:.2e} (tol 1e-6); spectral launches {n1}; {dt:.2f} s",
          flush=True)

    # 33. the comparison pipeline with phase 31's nets on a 4x4 y-grid
    t0 = phase_start()
    yg = cmp.y_grid(ds.y_mean, ds.y_std**2, 2.0, 4)[0]
    tm_g, tsg_g, zm_g, zs_g = trainer.predict(res.theta_net, res.z_net, yg)
    batch_h = lambda thetas: fh(thetas)[1]  # noqa: E731
    gen = torch.Generator().manual_seed(33)
    kld_p, kld_c = cmp.kld_maps(gen, batch_h, yg, (tm_g, tsg_g, zm_g, zs_g), (tm_g, tsg_g),
                                cfg.sig_eta, 200)
    fields = cmp.mean_sig_fields(gen, batch_h, (tm_g, tsg_g, zm_g, zs_g), (tm_g, tsg_g),
                                 cfg.sig_eta, 200,
                                 proposed_sampler=trainer.theta_sampler(res.theta_net, yg))
    rel = cmp.relative_error_fields(fields)
    dt, n1 = phase_end(t0)
    out["eval_20x10"] += n1
    arrays = [kld_p, kld_c, *(a for v in fields.values() for a in v),
              *(a for v in rel.values() for a in v)]
    if not (kld_p.shape == kld_c.shape == (16,)
            and all(a.shape[0] == 16 and np.isfinite(a).all() for a in arrays)) or n1 <= 0:
        fail(f"comparison pipeline: shapes {[a.shape for a in arrays]}, finite "
             f"{[bool(np.isfinite(a).all()) for a in arrays]}, spectral launches {n1}")
    print(f"[33 comparison] ok: 4x4 y-grid, 200 samples a y: KLD proposed mean "
          f"{kld_p.mean():.4f}, classical {kld_c.mean():.4f}; mean-field rel err proposed "
          f"{rel['proposed'][0].mean():.4f}, classical {rel['classical'][0].mean():.4f}; finite, "
          f"(16,) and (16, 2); spectral launches {n1}; {dt:.2f} s", flush=True)

    # 34. refinement on the 3-D box through the trainer's f32 + 1 refinement
    #     solver: one observation, ne = 16 (full width), 150 steps (cut from
    #     the example's 1500), from box3d_path's amortized posterior
    cfg3, fh3, trainer3, res3, ds3 = box["trained"]
    tm3, tsg3, _, _ = trainer3.predict(res3.theta_net, res3.z_net, ds3.y_data[:1])
    steps = 150
    t0 = phase_start()
    mu, L, losses = refine_posterior(lambda thetas: fh3(thetas)[0], ds3.y_data[0], cfg3.sig_e,
                                     tm3[0], torch.diag(torch.sqrt(tsg3[0])),
                                     generator=torch.Generator().manual_seed(200), steps=steps,
                                     ne=16, lr=1e-2, chunk_steps=50)
    dt, n1 = phase_end(t0)
    n4 = launched("stencil3d_affine", mark)
    out["refine_32x8x8"] = (n1, n4)
    losses = losses.cpu().numpy()
    first, last = losses[:20].mean(), losses[-20:].mean()
    ok = np.isfinite(losses).all() and bool(torch.isfinite(mu).all() and torch.isfinite(L).all())
    if not (ok and last < first and n1 > 0 and n4 > 0):
        fail(f"3-D refinement: finite {ok}, mean loss first 20 {first}, last 20 {last}, launches "
             f"spectral {n1}, stencil3d {n4}")
    print(f"[34 refine] ok: 32x8x8, one observation, ne = 16, {steps} steps (cut from 1500): "
          f"mean loss first 20 {first:.4f} > last 20 {last:.4f}; amortized "
          f"{tm3[0].tolist()} -> refined {mu.tolist()} (true {ds3.theta_data[0].tolist()}); "
          f"launches stencil3d {n4}, spectral {n1}; {1e3 * dt / steps:.2f} ms a step "
          f"({dt:.2f} s) on {card}", flush=True)
    return out


def trainer_path(dev, card, model, ds, thetas, fh64, mf_steps_per_s):
    """Phases 35-40: the rest of the two-step trainer on Cook's 20x10 at the
    reference's widths, each phase with its spectral launches and its wall
    time: the dense Cholesky and inverse solvers
    against the spectral solve (phase 5's 256 thetas), the full-covariance
    and flow posteriors (phase 6's dataset, 3 + 3 epochs), exact resume from
    the trainer's checkpoints, gradient clipping with resampled base draws,
    and the dataset's .npz round trip. ``model``, ``ds``, ``thetas`` and
    ``fh64`` are phases 5-6's; ``mf_steps_per_s`` is phase 7's mean-field
    rate. Returns the spectral launch counts by path."""
    import tempfile

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.models.flow import flow_moments
    from vbicm_tpu_torch.ops.element import material_coeffs
    from vbicm_tpu_torch.ops.solve import make_dense_affine_solver, make_spectral_affine_solver
    from vbicm_tpu_torch.prob.datagen import load_dataset, save_dataset
    from vbicm_tpu_torch.solver import make_fh_fun
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    mark = {}  # the counters at the phase's start

    def phase_start():
        torch.cuda.synchronize()
        mark.update(trace.counters())
        return time.perf_counter()

    def phase_end(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, launched("spectral_apply", mark)

    cfg = ProblemConfig()
    out = {}

    # 35. the dense Cholesky and inverse solvers (f64, and a float32 factor
    #     with two refinements) against the f64 spectral fh on phase 5's 256
    #     thetas; the coefficient gradient against the spectral solve's;
    #     each solve's time beside #1's at (256, 440)
    t0 = phase_start()
    with torch.no_grad():
        y64, h64 = fh64(thetas)
    parts = torch.stack([model.k_lam_ff, model.k_mu_ff])
    E = torch.exp(0.1 * thetas[:, 0] + math.log(20.0))
    nu = 0.5 * torch.sigmoid(0.015 * thetas[:, 1])
    coeffs = torch.stack(material_coeffs(model.stype, E, nu), dim=-1)
    f = model.f_free.expand(coeffs.shape[0], -1)
    w = torch.randn(f.shape, generator=torch.Generator().manual_seed(35),
                    dtype=torch.float64).to(dev)

    def coeff_grad(solver):
        c = coeffs.clone().requires_grad_(True)
        return torch.autograd.grad((w * solver(c, f)).sum(), c)[0]

    spectral = make_spectral_affine_solver(parts)
    g_ref = coeff_grad(spectral)
    lines, dense_ms = [], {}
    with torch.no_grad():
        dense_ms["spectral (#1)"] = time_ms(lambda: spectral(coeffs, f), warmup=5, reps=50)
    for method in ("cholesky", "inverse"):
        for factor, refine, tol in ((None, 0, 1e-10), (torch.float32, 2, 1e-6)):
            with torch.no_grad():
                y, h = make_fh_fun(model, cfg, method=method, factor_dtype=factor,
                                   refine_iters=refine)(thetas)
            err = max(rel_err(y, y64), rel_err(h, h64))
            tag = f"{method} {'f64' if factor is None else 'f32 factor + 2 refinements'}"
            if not err <= tol:
                fail(f"dense {tag} vs the f64 spectral fh: rel err {err} > {tol}")
            solver = make_dense_affine_solver(parts, factor_dtype=factor, refine_iters=refine,
                                              method=method)
            with torch.no_grad():
                dense_ms[tag] = time_ms(lambda: solver(coeffs, f), warmup=3, reps=20)
            lines.append(f"{tag} {err:.2e} (tol {tol:g})")
        g_err = rel_err(coeff_grad(make_dense_affine_solver(parts, method=method)), g_ref)
        if not g_err <= 1e-8:
            fail(f"dense {method}: coefficient gradient vs the spectral solve's {g_err} > 1e-8")
        lines.append(f"{method} coefficient gradient {g_err:.2e} (tol 1e-8)")
    dt, _ = phase_end(t0)
    out["dense_ms"] = dense_ms
    print(f"[35 dense] ok: vs the f64 spectral fh, 256 thetas: {'; '.join(lines)}; solve "
          f"(256, 440) f64 eager ms (CUDA events): "
          f"{', '.join(f'{k} {v:.4f}' for k, v in dense_ms.items())}; {dt:.2f} s on {card}",
          flush=True)

    # 36-37. the full-covariance and flow posteriors, phase 6's run (n_data
    #     1024, 3 + 3 epochs, f32 apply + 1 refinement) with per-sample
    #     pairing; steps/s of step-1 epochs 2-3 beside phase 7's mean field
    steps_per_epoch = math.ceil(ds.n_sam / 64)
    fams = {}
    for phase, fam in ((36, "fullcov"), (37, "flow")):
        tcfg = TrainConfig(batch_size=64, num_epoch1=3, num_epoch2=3, posterior=fam,
                           pairing="per_sample")
        trainer = TwoStepTrainer(model, cfg, tcfg, factor_dtype=torch.float32, refine_iters=1)
        t0 = phase_start()
        extra = ""
        if fam == "flow":
            net0 = trainer.new_theta_net(torch.Generator().manual_seed(0))
            y8 = torch.as_tensor(ds.y_data[:8], device=dev)
            e8 = torch.as_tensor(ds.e_data, device=dev)
            with torch.no_grad():
                theta0, _ = net0(y8, e8)
                mu, log_sig = net0.base(y8)
            if not torch.equal(theta0, mu[:, None] + torch.exp(0.5 * log_sig)[:, None] * e8[None]):
                fail("flow: at init theta is not the mean-field base bitwise")
            extra = "at init theta = the mean-field base bitwise; "
        res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
        dt, n1 = phase_end(t0)
        fams[fam] = (trainer, res)
        losses = np.concatenate([res.hist_step1, res.hist_step2])
        if not np.all(np.isfinite(losses)) or n1 <= 0:
            fail(f"{fam} trainer: losses {losses}, spectral launches {n1}")
        if fam == "fullcov":
            tm, tsig, _, _ = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
            mu, L = trainer.predict_cholesky(res.theta_net, ds.y_data[:8])
            if not (torch.equal(tsig, torch.sum(L**2, dim=-1)) and torch.equal(tm, mu)):
                fail("fullcov: predict's variances are not diag(L L^T) of predict_cholesky")
            extra = "predict = diag(L L^T) of predict_cholesky; "
        else:
            m, v = flow_moments(res.theta_net, ds.y_data[:8], torch.Generator().manual_seed(2),
                                n_mc=256)
            if not (m.shape == v.shape == (8, 2) and bool(torch.isfinite(m).all())
                    and bool((v > 0).all())):
                fail(f"flow_moments: mean {m}, var {v}")
            extra += f"flow_moments (n_mc 256) theta mean {m[0].tolist()}; "
        rate = steps_per_epoch * 2 / sum(res.epoch_times_step1[1:])
        out[fam] = (n1, rate)
        print(f"[{phase} {fam}] ok: step1 losses {res.hist_step1.tolist()}, step2 "
              f"{res.hist_step2.tolist()}; {extra}spectral launches {n1}; step-1 steps/s "
              f"(epochs 2-3) {rate:.2f} against mean field {mf_steps_per_s:.2f} (phase 7); "
              f"{dt:.2f} s on {card}", flush=True)

    # 38. exact resume from the trainer's checkpoints, each against the
    #     uninterrupted run: step 1 two epochs + two resumed against four,
    #     step 2 the same, a crash after a partial final chunk (1000
    #     observations: 15 full batches and a partial one, scan_chunk 4,
    #     so the last chunk holds 3) then the resume, and fit(resume=True)
    #     after step 1
    class Crash(Exception):
        pass

    def crashing(fh, after):
        calls = [0]

        def wrapped(th):
            calls[0] += 1
            if calls[0] > after:
                raise Crash
            return fh(th)

        return wrapped

    def compare(a_nets, b_nets, a_hists, b_hists):
        """(bitwise equal, max relative difference) of nets and histories."""
        pairs = [(x, y) for na, nb in zip(a_nets, b_nets)
                 for x, y in zip(na.state_dict().values(), nb.state_dict().values())]
        pairs += [(torch.as_tensor(x), torch.as_tensor(y)) for x, y in zip(a_hists, b_hists)]
        equal = all(torch.equal(x, y) for x, y in pairs)
        return equal, max(rel_err(x, y) for x, y in pairs)

    fh32 = make_fh_fun(model, cfg, factor_dtype=torch.float32, refine_iters=1)
    y, e = ds.y_data, ds.e_data
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    t0 = phase_start()
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name, tcfg, fh=fh32):
            return TwoStepTrainer(model, cfg, tcfg, fh_batch=fh,
                                  results_path=None if name is None else os.path.join(tmp, name))

        tcfg = TrainConfig(batch_size=64, lr_decay_mode="fixed", lr_patience=2)
        net4, h4, _ = trainer(None, tcfg).train_step1(y, e, gen(), 4)
        trainer("s1", tcfg).train_step1(y, e, gen(), 2)
        net, h, _ = trainer("s1", tcfg).train_step1(y, e, gen(), 4, resume=True)
        checks["step 1 2 + 2 vs 4"] = compare([net], [net4], [h], [h4])

        g = gen()
        tr = trainer(None, tcfg)
        lm, ls = tr.bridge(y, e, net4, g)
        state = g.get_state()
        z4, h4, _ = tr.train_step2(y, e, net4, lm, ls, g, 4)
        g.set_state(state)
        trainer("s2", tcfg).train_step2(y, e, net4, lm, ls, g, 2)
        g.set_state(state)
        z, h, _ = trainer("s2", tcfg).train_step2(y, e, net4, lm, ls, g, 4, resume=True)
        checks["step 2 2 + 2 vs 4"] = compare([z], [z4], [h], [h4])

        tcfg_c = TrainConfig(batch_size=64, ckpt_chunk=True, scan_chunk=4, ckpt_every=5,
                             num_epoch1=2, num_epoch2=2)
        y1k = y[:1000]
        ref = trainer(None, tcfg_c).fit(y1k, e, gen())
        try:  # the crash is the run's own: fh raises in epoch 1's partial batch
            trainer("chunk", tcfg_c, crashing(fh32, 16 + 15)).fit(y1k, e, gen())
            fail("the crashing run did not crash")
        except Crash:
            pass
        bundle = torch.load(os.path.join(tmp, "chunk", "step1", "latest.pt"), weights_only=True)
        if (bundle["epoch"], bundle["batches_done"]) != (1, 15):
            fail(f"chunk bundle at epoch {bundle['epoch']}, {bundle['batches_done']} batches, "
                 "not (1, 15)")
        res = trainer("chunk", tcfg_c).fit(y1k, e, gen(), resume=True)
        checks["ckpt_chunk crash after a partial final chunk"] = compare(
            [res.theta_net, res.z_net], [ref.theta_net, ref.z_net],
            [res.hist_step1, res.hist_step2], [ref.hist_step1, ref.hist_step2])

        tcfg_f = TrainConfig(batch_size=64, num_epoch1=3, num_epoch2=3)
        ref = trainer(None, tcfg_f).fit(y, e, gen())
        trainer("fit", tcfg_f).train_step1(y, e, gen())
        res = trainer("fit", tcfg_f).fit(y, e, gen(), resume=True)
        checks["fit(resume=True) after step 1"] = compare(
            [res.theta_net, res.z_net], [ref.theta_net, ref.z_net],
            [res.hist_step1, res.hist_step2, res.logz_mean_post],
            [ref.hist_step1, ref.hist_step2, ref.logz_mean_post])

        tr_w, opt, reps = trainer("write", tcfg), tr.optimizer_step1(net4), 20
        tic = time.perf_counter()
        for _ in range(reps):
            tr_w._save_ckpt("step1", 0, 1.0, net4, opt, h4, g.get_state())
        write_ms = 1e3 * (time.perf_counter() - tic) / reps
    dt, n1 = phase_end(t0)
    out["resume"] = n1
    bad = [k for k, (_, err) in checks.items() if not err <= 1e-12]
    text = "; ".join(f"{k}: bitwise {eq}, max rel diff {err:.2e}" for k, (eq, err) in checks.items())
    if bad or n1 <= 0:
        fail(f"resume: {bad} beyond 1e-12 relative: {text}; spectral launches {n1}")
    print(f"[38 resume] ok: {text} (tol 1e-12); an epoch's checkpoint write (the numbered "
          f"weights file and the latest.pt bundle, each fsynced) {write_ms:.2f} ms; spectral "
          f"launches {n1}; {dt:.2f} s on {card}", flush=True)
    out["bundle_write_ms"] = write_ms

    # 39. clip_grad_norm with resampled base draws: two epochs' finite
    #     histories, then one epoch of update_step1 with every clipped
    #     step's global norm at most max_norm
    max_norm = 5.0
    tcfg = TrainConfig(batch_size=64, num_epoch1=2, clip_grad_norm=max_norm, resample_e=True)
    t0 = phase_start()
    tr = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh32)
    net, hist, _ = tr.train_step1(y, e, gen())
    opt = tr.optimizer_step1(net)
    y_t, e_t = torch.as_tensor(y, device=dev), torch.as_tensor(e, device=dev)
    e_all = torch.randn((steps_per_epoch, *e.shape), generator=torch.Generator().manual_seed(39),
                        dtype=torch.float64).to(dev)
    clipped, worst, pre = 0, 0.0, []
    for b in range(steps_per_epoch):
        tr.update_step1(net, opt, y_t[b * 64:(b + 1) * 64], e_t, e_all[b])
        norm = float(torch.sqrt(sum(torch.sum(p.grad**2) for p in net.parameters())))
        pre.append(float(tr.last_grad_norm))
        if pre[-1] >= max_norm:
            clipped += 1
            worst = max(worst, norm)
            if not norm <= max_norm + 1e-12:
                fail(f"clip: the clipped global norm {norm} > {max_norm} + 1e-12")
    dt, n1 = phase_end(t0)
    out["clip"] = n1
    if not np.all(np.isfinite(hist)) or n1 <= 0:
        fail(f"clip_grad_norm + resample_e: losses {hist}, spectral launches {n1}")
    print(f"[39 clip] ok: clip_grad_norm {max_norm} + resample_e, step1 losses {hist.tolist()}; "
          f"{clipped} of {steps_per_epoch} steps clipped (norms before clipping "
          f"{min(pre):.3f}-{max(pre):.3f}), clipped norms <= {worst!r} (<= {max_norm} + 1e-12); "
          f"spectral launches {n1}; {dt:.2f} s", flush=True)

    # 40. phase 6's dataset through the .npz form, bitwise
    t0 = phase_start()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.npz")
        save_dataset(ds, path)
        back = load_dataset(path)
    fields = ("y_data", "z_data", "log_z_data", "e_data", "y_mean", "y_std", "z_mean", "z_std",
              "theta_data")
    unequal = [k for k in fields if not np.array_equal(getattr(back, k), getattr(ds, k))]
    dt, _ = phase_end(t0)
    if unequal:
        fail(f"dataset .npz round trip: {unequal} differ")
    print(f"[40 dataset] ok: phase 6's {ds.n_sam}-point dataset through .npz bitwise equal "
          f"({len(fields)} fields); {dt:.2f} s", flush=True)
    return out


def load_example(name):
    """An example script under examples/ as a module (its ``main`` not run)."""
    import importlib.util

    examples = os.path.join(ROOT, "examples")
    if examples not in sys.path:  # the 3-D field example imports the 2-D one
        sys.path.insert(0, examples)
    spec = importlib.util.spec_from_file_location(name, os.path.join(examples, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cg_iters(solver):
    """(mean, max) CG iterations a lane of each CG run of the last solve."""
    return [(round(float(it.double().mean()), 2), int(it.max())) for it in solver.last_cg_iters]


def field_path(dev, card):
    """Phases 41-47: the random-field family, each phase with its spectral
    launches and its wall time: the spectral kernel at
    the 3-D field path's coarse size (n = 216) against its plain version;
    the 80x40 field solve (examples/train_randomfield_torch.py's operator:
    grid mode, the mean-field two-level cycle, float32 CG at tol 3e-3 plus
    one float64 refinement) against float64 solves, its CG iterations and
    the field matvec's time; the field adjoint against finite differences
    and the field log-posterior's Hessian against the CPU run; the 2-D and
    3-D field trainers at the examples' widths (n_data 256, 2 + 2 epochs);
    Laplace and refinement through the 10x5 field fh to tests/test_laplace.py
    and tests/test_refine.py's gates; the field ROM at 10x5 to
    tests/test_randomfield.py's gates. Returns the spectral launch counts by
    path and #1's (256, 216) times."""
    import warnings

    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.eval import laplace_posterior, make_fem_logpost
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.spectral_kernel import (
        spectral_apply_batched,
        spectral_apply_reference,
    )
    from vbicm_tpu_torch.prob import randomfield as rf
    from vbicm_tpu_torch.rom.field import build_reduced_basis_field, make_fh_fun_field_rom
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.utils.timing import Timer
    from vbicm_tpu_torch.vi.refine import refine_posterior

    mark = {}  # the counters at the phase's start

    def phase_start():
        torch.cuda.synchronize()
        mark.update(trace.counters())
        return time.perf_counter()

    def phase_end(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0, launched("spectral_apply", mark)

    def solves_per_s(fh, thetas, grad, reps=3):
        """Field solves a second of ``fh`` on ``thetas`` (host clock, the card
        synchronised): forward only, or forward and the theta-gradient."""
        def call():
            if not grad:
                with torch.no_grad():
                    fh(thetas)
                return
            th = thetas.clone().requires_grad_(True)
            y, h = fh(th)
            torch.autograd.grad((y**2).sum() + h.sum(), th)

        call()
        with Timer(torch.device("cuda", 0)) as t:
            for _ in range(reps):
                call()
        return thetas.shape[0] * reps / t.seconds

    out = {"launches": {}}
    ex2 = load_example("train_randomfield_torch")
    ex3 = load_example("train_randomfield_3d_torch")

    # 41. #1 against its plain version at the 3-D field path's coarse size
    #     (216 free dofs of the 8x2x2 box: not a multiple of 8, 16 or 32),
    #     two calls bitwise equal; device time and bound at (256, 216)
    t0 = phase_start()
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for B in FIELD_COARSE_BATCHES:
            V, g, c, b = pencil_problem(B, FIELD_COARSE_N, seed=B + 41, dtype=dtype, device=dev)
            x, a = spectral_apply_batched(V, g, c, b, return_coords=True)
            x2, a2 = spectral_apply_batched(V, g, c, b, return_coords=True)
            xr, ar = spectral_apply_reference(V, g, c, b, return_coords=True)
            torch.cuda.synchronize()
            err = max(rel_err(x, xr), rel_err(a, ar))
            if not err <= REL_TOL[dtype]:
                fail(f"spectral kernel vs plain at B={B} n={FIELD_COARSE_N} {dtype}: rel err {err}")
            if not (torch.equal(x, x2) and torch.equal(a, a2)):
                fail(f"spectral kernel at B={B} n={FIELD_COARSE_N} {dtype}: two calls differ")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if dtype == torch.float32 and B == 256:
                out["spectral_abs_err_216"] = float((x - xr).abs().max())
    out["spectral_ms"] = {dt: spectral_times((256, FIELD_COARSE_N), dt, dev, card, 41, 100)
                          for dt in (torch.float32, torch.float64)}
    dt_s, _ = phase_end(t0)
    print(f"[41 spectral 216] ok: max rel err vs plain f32 {worst[torch.float32]:.3e} (tol 2e-5), "
          f"f64 {worst[torch.float64]:.3e} (tol 1e-12) at B in {FIELD_COARSE_BATCHES} x n "
          f"{FIELD_COARSE_N}, x and a, two calls bitwise equal; {dt_s:.2f} s", flush=True)

    # 42. the 80x40 field solve of 256 prior fields: the f64 mean-field
    #     two-level solve against f64 Jacobi; the trainer's f32 + 1
    #     refinement against f64; lm against grid mode; two calls bitwise
    #     equal; CG iterations; the field matvec's time
    t0 = phase_start()
    model, kl, cfg, probes, fh = ex2.build(80, 40, device=dev)
    coarse = build_fem_model(cooks_membrane_mesh(20, 10), device=dev, dense=True)
    prec = rf.make_mean_field_preconditioner(coarse, 20, 10, 4, model.free_mask, nu=0.3,
                                             E0=float(np.exp(kl.mean_log)))
    kw = dict(probe_nodes=probes)
    fh_p = rf.make_fh_fun_field(model, kl, cfg, tol=1e-10, preconditioner=prec, grid=(80, 40),
                                **kw)
    # lm against grid mode at tol 1e-13: their sums run in other orders, so
    # they agree to the CG's tolerance, not to the last bit
    fh_a = rf.make_fh_fun_field(model, kl, cfg, tol=1e-13, preconditioner=prec, grid=(80, 40),
                                **kw)
    fh_a_lm = rf.make_fh_fun_field(model, kl, cfg, tol=1e-13, preconditioner=prec, **kw)
    fh_j = rf.make_fh_fun_field(model, kl, cfg, tol=1e-12, grid=(80, 40), **kw)
    fh_lm = rf.make_fh_fun_field(model, kl, cfg, probe_nodes=probes, cg_dtype=torch.float32,
                                 refine_iters=1, tol=3e-3, preconditioner=prec)
    thetas = torch.randn((256, kl.n_modes), generator=torch.Generator().manual_seed(42),
                         dtype=torch.float64).to(dev)
    res, iters = {}, {}
    with torch.no_grad():
        for name, f in (("trainer", fh), ("two-level f64", fh_p), ("two-level f64 1e-13", fh_a),
                        ("two-level f64 1e-13 lm", fh_a_lm), ("Jacobi f64", fh_j),
                        ("trainer lm", fh_lm)):
            res[name] = f(thetas)
            iters[name] = cg_iters(f.solver)
        again = {name: f(thetas) for name, f in (("trainer", fh), ("trainer lm", fh_lm))}
    torch.cuda.synchronize()
    errs = {"two-level f64 vs Jacobi f64": (res["two-level f64"], res["Jacobi f64"], 1e-9),
            "trainer (f32 + 1 refinement) vs f64": (res["trainer"], res["two-level f64"], 1e-5),
            "lm vs grid mode (f64, tol 1e-13)": (res["two-level f64 1e-13 lm"],
                                                 res["two-level f64 1e-13"], 1e-12)}
    text = []
    for key, ((y, h), (yr, hr), tol) in errs.items():
        err = max(rel_err(y, yr), rel_err(h, hr))
        if not err <= tol:
            fail(f"80x40 field solve, {key}: rel err (y, h) {err} > {tol}")
        text.append(f"{key} {err:.2e} (tol {tol:g})")
    for name in again:
        if not all(torch.equal(a, b) for a, b in zip(again[name], res[name])):
            fail(f"80x40 field solve, {name}: two calls are not bitwise equal")
    # the field matvec (gather, element products, E-scaling, scatter) at the
    # trainer's CG dtype, grid and lm mode; its share of a trainer solve
    E32 = rf.field_from_theta(kl, thetas, torch.float32)
    x32 = torch.randn((256, model.ndof), generator=torch.Generator().manual_seed(43)).to(dev)
    mv = {}
    for mode, f in (("grid", fh), ("lm", fh_lm)):
        with torch.no_grad():
            op, _ = f.solver.cg_operator(E32)
            mv[mode] = time_ms(lambda: op(x32), warmup=5, reps=50)
    with torch.no_grad():
        solve_ms = time_ms(lambda: fh(thetas), warmup=2, reps=10)
    loops = sum(-(-m // 8) * 8 for _, m in iters["trainer"])  # pcg checks every 8 iterations
    share = mv["grid"] * loops / solve_ms
    out["field_matvec_ms"] = mv
    out["field_solve_ms"] = solve_ms
    out["field_matvec_share"] = share
    dt_s, n1 = phase_end(t0)
    out["launches"]["field_80x40_solve"] = n1
    if n1 <= 0:
        fail("the 80x40 field solve never launched the spectral kernel")
    print(f"[42 field solve] ok: 80x40 ({model.ndof} dofs), 256 prior fields of the 16-mode KL: "
          f"{'; '.join(text)}; the trainer's solve and its lm-mode twin two calls bitwise "
          f"equal; CG iterations (mean, max) a run: "
          f"{'; '.join(f'{k} {v}' for k, v in iters.items())}; field matvec (B 256, f32) "
          f"{mv['grid']:.4f} ms grid mode, {mv['lm']:.4f} ms lm mode (CUDA events); a trainer "
          f"forward solve {solve_ms:.3f} ms, so {loops} matvecs ~{100 * share:.1f} % of it; "
          f"spectral launches {n1}; {dt_s:.2f} s on {card}", flush=True)

    # 43. the field adjoint against fourth-order central differences (f64
    #     two-level, tol 1e-13, 8 fields, 3 directions), and the field log-posterior's
    #     Hessian (10x5, 4 modes, the double backward) against the CPU run
    t0 = phase_start()
    th8 = thetas[:8].clone()
    wts = torch.randn((8, cfg.y_dim), generator=torch.Generator().manual_seed(44),
                      dtype=torch.float64).to(dev)

    def loss(th):
        y, h = fh_a(th)
        return (wts * y).sum() + h.sum()

    th = th8.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(th), th)
    fd_errs = []
    for k in range(3):
        v = torch.randn(th8.shape, generator=torch.Generator().manual_seed(45 + k),
                        dtype=torch.float64).to(dev)
        eps = 1e-4  # the fourth-order central stencil: truncation ~eps^4
        with torch.no_grad():
            fd = (8 * (loss(th8 + eps * v) - loss(th8 - eps * v))
                  - (loss(th8 + 2 * eps * v) - loss(th8 - 2 * eps * v))) / (12 * eps)
        fd_errs.append(abs(float(fd) - float((g * v).sum())) / abs(float(fd)))
    if not max(fd_errs) <= 1e-6:
        fail(f"field adjoint vs central differences: rel err {fd_errs} > 1e-6")
    hess_err, small = [], []
    for d in (torch.device("cpu"), dev):
        m10 = build_fem_model(cooks_membrane_mesh(10, 5), device=d)
        kl10 = rf.build_kl_expansion(m10, n_modes=4, corr_len=15.0, sigma=0.3)
        cfg10 = ProblemConfig(theta_dim=4, y_dim=16, ele_id=5, sig_e=1e-3)
        f10 = rf.make_fh_fun_field(m10, kl10, cfg10, probe_nodes=tuple(range(8, 55, 6)),
                                   tol=1e-12)
        t_true = torch.tensor([0.7, -0.4, 0.2, 0.9], dtype=torch.float64, device=d)
        with torch.no_grad():
            y_obs = f10(t_true[None])[0][0]
        lp = make_fem_logpost(f10, y_obs, cfg10.sig_e)
        small.append((m10, kl10, cfg10, f10, t_true, y_obs, lp))
        hess_err.append([torch.autograd.functional.hessian(lambda x: lp(x[None])[0],
                                                           t.to(d)).cpu()
                         for t in (t_true + 0.1, torch.tensor([0.2, 0.1, -0.3, 0.5],
                                                              dtype=torch.float64))])
    herr = max(rel_err(a, b) for a, b in zip(hess_err[1], hess_err[0]))
    if not herr <= 1e-8:
        fail(f"field log-posterior Hessian, card vs CPU: rel err {herr} > 1e-8")
    dt_s, _ = phase_end(t0)
    print(f"[43 field adjoint] ok: 80x40 f64 two-level, 8 fields: theta-gradient vs central "
          f"differences (fourth order, eps 1e-4) rel err "
          f"{', '.join(f'{e:.2e}' for e in fd_errs)} (tol 1e-6); "
          f"10x5 field log-posterior Hessian (double backward) card vs CPU {herr:.2e} (tol 1e-8); "
          f"{dt_s:.2f} s", flush=True)

    # 44. the 2-D field trainer at the example's width (16 modes, 50 probes,
    #     64-neuron heads, full covariance, per-sample pairing, resample_e,
    #     clip 1e5), n_data 256, 2 + 2 epochs; field solves/s at B = 256
    t0 = phase_start()
    trainer, res2, _, s2 = ex2.train(fh, cfg, n_data=256, epochs1=2, epochs2=2,
                                     posterior="fullcov", seed=0, device=dev, verbose=False)
    dt_s, n1 = phase_end(t0)
    out["launches"]["field_train_80x40"] = n1
    losses = np.concatenate([res2.hist_step1, res2.hist_step2])
    if not np.all(np.isfinite(losses)) or n1 <= 0:
        fail(f"2-D field trainer: losses {losses}, spectral launches {n1}")
    fwd = solves_per_s(fh, thetas, grad=False)
    grad = solves_per_s(fh, thetas, grad=True)
    out["field_2d"] = dict(steps_per_s=s2["train_steps_per_sec"],
                           step1_steady=s2.get("step1_steps_per_sec_steady"),
                           solves_per_s=fwd, grad_solves_per_s=grad)
    print(f"[44 field trainer 2-D] ok: step1 losses {res2.hist_step1.tolist()}, step2 "
          f"{res2.hist_step2.tolist()}; spectral launches {n1} (the phase: the example's "
          f"datagen and training), {s2['training_launches']['spectral_apply']} in training; "
          f"train steps/s (2 + 2 epochs, "
          f"first epochs included) {s2['train_steps_per_sec']:.3f}, step-1 steps/s (epoch 2) "
          f"{s2.get('step1_steps_per_sec_steady', float('nan')):.3f}; field solves/s at B 256 "
          f"forward {fwd:.1f}, with the theta-gradient {grad:.1f}; {dt_s:.2f} s on {card}",
          flush=True)

    # 45. the 3-D field solve (32x8x8, box3d two-level at ratio 4: an 8x2x2
    #     coarse box, n = 216) against f64 Jacobi, then its trainer
    t0 = phase_start()
    model3, kl3, cfg3, probes3, fh3 = ex3.build(32, 8, 8, device=dev)
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh

    coarse3 = build_fem_model(beam_hex8_mesh(8, 2, 2, lx=8.0), SectionCard(stype=4), device=dev,
                              dense=True)
    if coarse3.nfree != FIELD_COARSE_N:
        fail(f"the 8x2x2 coarse box has {coarse3.nfree} free dofs, not {FIELD_COARSE_N}")
    prec3 = rf.make_mean_field_preconditioner_box3d(coarse3, (8, 2, 2), 4, model3.free_mask,
                                                    nu=0.3, E0=float(np.exp(kl3.mean_log)))
    fh3_p = rf.make_fh_fun_field(model3, kl3, cfg3, probe_nodes=probes3, tol=1e-10,
                                 preconditioner=prec3, grid=(32, 8, 8))
    fh3_j = rf.make_fh_fun_field(model3, kl3, cfg3, probe_nodes=probes3, tol=1e-12,
                                 grid=(32, 8, 8))
    th3 = torch.randn((64, kl3.n_modes), generator=torch.Generator().manual_seed(45),
                      dtype=torch.float64).to(dev)
    with torch.no_grad():
        r3 = {name: (f(th3), cg_iters(f.solver)) for name, f in
              (("trainer", fh3), ("two-level f64", fh3_p), ("Jacobi f64", fh3_j))}
    e_p = max(rel_err(a, b) for a, b in zip(r3["two-level f64"][0], r3["Jacobi f64"][0]))
    e_t = max(rel_err(a, b) for a, b in zip(r3["trainer"][0], r3["Jacobi f64"][0]))
    # the trainer's f32 CG at tol 3e-3 + one refinement is the JAX example's
    # policy; on the CPU it is 3.4e-4 from f64 here (1.8e-7 in 2-D)
    if not (e_p <= 1e-6 and e_t <= 1e-3):
        fail(f"3-D field solve vs f64 Jacobi: two-level f64 {e_p} (tol 1e-6), trainer {e_t} "
             "(tol 1e-3)")
    _, n_solve = phase_end(t0)
    mark.update(trace.counters())
    trainer3, res3, _, s3 = ex3.field_example.train(fh3, cfg3, n_data=256, epochs1=2,
                                                    epochs2=2, posterior="fullcov", seed=0,
                                                    device=dev, verbose=False, chunk=256)
    dt_s, n1 = phase_end(t0)
    out["launches"]["field_3d_solve"] = n_solve
    out["launches"]["field_train_32x8x8"] = n1
    losses = np.concatenate([res3.hist_step1, res3.hist_step2])
    if not np.all(np.isfinite(losses)) or n1 <= 0 or n_solve <= 0:
        fail(f"3-D field trainer: losses {losses}, spectral launches {n_solve}, {n1}")
    fwd3 = solves_per_s(fh3, th3, grad=False)
    out["field_3d"] = dict(steps_per_s=s3["train_steps_per_sec"],
                           step1_steady=s3.get("step1_steps_per_sec_steady"), solves_per_s=fwd3)
    print(f"[45 field 3-D] ok: 32x8x8 ({model3.ndof} dofs), 64 prior fields of the 12-mode KL: "
          f"two-level f64 vs Jacobi f64 {e_p:.2e} (tol 1e-6), the trainer's f32 + 1 refinement "
          f"{e_t:.2e} (tol 1e-3); CG iterations (mean, max) "
          f"{'; '.join(f'{k} {v[1]}' for k, v in r3.items())}; trainer 2 + 2 epochs at n_data "
          f"256: step1 losses {res3.hist_step1.tolist()}, step2 {res3.hist_step2.tolist()}; "
          f"spectral launches solve {n_solve}, trainer {n1} (datagen and training), "
          f"{s3['training_launches']['spectral_apply']} in training; train steps/s "
          f"{s3['train_steps_per_sec']:.3f}, step-1 steps/s (epoch 2) "
          f"{s3.get('step1_steps_per_sec_steady', float('nan')):.3f}; field solves/s at B 64 "
          f"{fwd3:.1f}; {dt_s:.2f} s on {card}", flush=True)

    # 46. Laplace and refinement through the 10x5 field fh (Jacobi CG, f64)
    #     on the card, to tests/test_laplace.py:35 and tests/test_refine.py:34's
    #     gates
    t0 = phase_start()
    m10, kl10, cfg10, f10, t_true, y_obs, lp = small[-1]  # the card's
    lres = laplace_posterior(lp, torch.zeros(4, dtype=torch.float64, device=dev), tol=1e-7)
    stds = np.sqrt(np.diag(lres.cov))
    lap_ok = (lres.grad_norm < 1e-6 and np.abs(lres.theta_map - t_true.cpu().numpy()).max() <= 0.05
              and np.all(stds < 1.0) and np.all(stds > 0))
    if not lap_ok:
        fail(f"Laplace through the 10x5 field fh: grad norm {lres.grad_norm}, mode "
             f"{lres.theta_map}, stds {stds}")
    f11 = rf.make_fh_fun_field(m10, kl10, cfg10, probe_nodes=tuple(range(8, 55, 6)), tol=1e-11)
    with torch.no_grad():
        y_n = f11(t_true[None])[0][0] + 0.01
    lres_n = laplace_posterior(make_fem_logpost(f11, y_n, cfg10.sig_e),
                               torch.zeros(4, dtype=torch.float64, device=dev), tol=1e-7)
    t_ref = time.perf_counter()
    mu, L, _ = refine_posterior(
        lambda th: f11(th)[0], y_n, cfg10.sig_e,
        t_true + torch.tensor([0.3, -0.25, 0.3, -0.3], dtype=torch.float64, device=dev),
        0.3 * torch.eye(4, dtype=torch.float64, device=dev),
        generator=torch.Generator().manual_seed(1), steps=3000, ne=16, lr=1e-2, chunk_steps=500)
    refine_ms = 1e3 * (time.perf_counter() - t_ref) / 3000
    vi_std = np.sqrt(torch.sum(L**2, -1).cpu().numpy())
    la_std = np.sqrt(np.diag(lres_n.cov))
    zgap = np.abs(mu.cpu().numpy() - lres_n.theta_map) / la_std
    ratio = vi_std / la_std
    if not (np.all(zgap < 0.6) and np.all(ratio > 0.7) and np.all(ratio < 1.4)):
        fail(f"refinement through the 10x5 field fh vs Laplace: zgap {zgap} (< 0.6), std ratio "
             f"{ratio} (0.7-1.4)")
    dt_s, _ = phase_end(t0)
    out["refine_field_ms"] = refine_ms
    print(f"[46 field Laplace + refine] ok: 10x5, 4 modes: Laplace grad norm {lres.grad_norm:.2e} "
          f"(< 1e-6), |mode - truth| {np.abs(lres.theta_map - t_true.cpu().numpy()).max():.2e} "
          f"(<= 0.05), stds {stds.round(4).tolist()}; refinement 3000 steps vs Laplace: zgap "
          f"max {zgap.max():.3f} (< 0.6), std ratio {ratio.min():.3f}-{ratio.max():.3f} (0.7-1.4); "
          f"{refine_ms:.2f} ms a refinement step; {dt_s:.2f} s", flush=True)

    # 47. the field ROM at 10x5 (6 modes, 128 candidates, at most 120
    #     vectors) to tests/test_randomfield.py:383's gates; the ROM fh and
    #     the full field fh each timed at B = 256
    t0 = phase_start()
    kl6 = rf.build_kl_expansion(m10, n_modes=6, corr_len=15.0, sigma=0.3)
    probes6 = tuple(range(8, 67, 6))
    cfg6 = ProblemConfig(theta_dim=6, y_dim=2 * len(probes6), ele_id=5)
    t_rb = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rb = build_reduced_basis_field(m10, kl6, nu=0.3, n_candidates=128, n_validate=32,
                                       tol=1e-9, max_basis=120, seed=0)
    rb_s = time.perf_counter() - t_rb
    if not (rb.max_rel_residual < 1e-9 and rb.val_max_rel_residual < 1e-10):
        fail(f"field ROM certificates: train {rb.max_rel_residual} (< 1e-9), held-out "
             f"{rb.val_max_rel_residual} (< 1e-10)")
    fh_rom = make_fh_fun_field_rom(m10, kl6, rb, cfg6, probe_nodes=probes6)
    fh_full = rf.make_fh_fun_field(m10, kl6, cfg6, probe_nodes=probes6, tol=1e-12)
    th5 = torch.randn((5, 6), generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64).to(dev)
    with torch.no_grad():
        (yr, hr), (yf, hf) = fh_rom(th5), fh_full(th5)
    ok = (torch.allclose(yr, yf, rtol=2e-7, atol=1e-10) and torch.allclose(hr, hf, rtol=2e-7,
                                                                            atol=0))
    grads = []
    for f in (fh_rom, fh_full):
        t1 = th5[:1].clone().requires_grad_(True)
        y, h = f(t1)
        grads.append(torch.autograd.grad((y**2).sum() + h.sum(), t1)[0])
    gerr = float(((grads[0] - grads[1]).abs() / grads[1].abs()).max())
    if not (ok and gerr <= 1e-5):
        fail(f"field ROM vs full field fh: y {rel_err(yr, yf)}, h {rel_err(hr, hf)} (rtol 2e-7), "
             f"gradient {gerr} (rtol 1e-5)")
    th256 = torch.randn((256, 6), generator=torch.Generator().manual_seed(47),
                        dtype=torch.float64).to(dev)
    rom_sps = solves_per_s(fh_rom, th256, grad=False, reps=10)
    full_sps = solves_per_s(fh_full, th256, grad=False)
    dt_s, _ = phase_end(t0)
    out["field_rom"] = dict(r=rb.r, rom_solves_per_s=rom_sps, full_solves_per_s=full_sps)
    print(f"[47 field ROM] ok: 10x5, 6 modes: r = {rb.r} in {rb_s:.1f} s on the host, "
          f"certificates train {rb.max_rel_residual:.2e} (< 1e-9), held-out "
          f"{rb.val_max_rel_residual:.2e} (< 1e-10); ROM vs full field fh at 5 thetas y "
          f"{rel_err(yr, yf):.2e}, h {rel_err(hr, hf):.2e} (rtol 2e-7), gradient {gerr:.2e} "
          f"(rtol 1e-5); solves/s at B 256 (f64): ROM {rom_sps:.1f}, full field fh (Jacobi CG "
          f"tol 1e-12) {full_sps:.1f}; {dt_s:.2f} s on {card}", flush=True)
    return out


# the hat transfers' shapes (phase 48): (B, coarse cells slowest first,
# ratio, dofs a node). The benchmark cells' 160x80 at ratio 4 (B = 256, and
# 512 for data generation's chunks), the 3-D boxes 32x8x8 (also the 3-D
# field path's) and 64x16x16 at ratio 4, the 80x40 field grid, and odd
# small grids at ratios 2, 3 and 4 with ragged batches
TRANSFER_MAIN = (256, (20, 40), 4, 2)
TRANSFER_SHAPES = [TRANSFER_MAIN, (512, (20, 40), 4, 2), (256, (2, 2, 8), 4, 3),
                   (256, (4, 4, 16), 4, 3), (256, (10, 20), 4, 2), (5, (3, 5), 2, 2),
                   (3, (1, 1), 3, 2), (7, (2, 3, 1), 3, 3), (4, (5, 7), 2, 3),
                   (2, (2, 2, 3), 4, 2), (300, (8, 8, 32), 2, 3)]
TRANSFER_TIMED = [TRANSFER_MAIN, (256, (2, 2, 8), 4, 3), (256, (4, 4, 16), 4, 3)]


def hat_macs(cells, ratio):
    """A transfer's multiply-adds a dof channel of a sample: one per nonzero
    hat weight of each axis's pass, times the other axes' nodes at that pass
    (fine before it, coarse after it in the prolongation's order; the
    restriction is its transpose)."""
    nf = [c * ratio + 1 for c in cells]
    nc = [c + 1 for c in cells]
    return sum((nc[k] + 2 * (nf[k] - nc[k])) * int(np.prod(nf[:k])) * int(np.prod(nc[k + 1:]))
               for k in range(len(cells)))


def hat_least_time(B, cells, ratio, ndof, dtype):
    """least_time of one transfer (either direction): each sample's fine and
    coarse vectors once, and :func:`hat_macs`."""
    nf = [c * ratio + 1 for c in cells]
    nc = [c + 1 for c in cells]
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = B * ndof * (int(np.prod(nf)) + int(np.prod(nc))) * itemsize
    return least_time(nbytes, 2 * B * ndof * hat_macs(cells, ratio), dtype)


def transfer_path(dev, card):
    """Phase 48: the hat-transfer kernels (csrc/hat_transfer.cu) against
    their plain version (REL_TOL of max|want|, whether bitwise), two calls
    bitwise equal, adjointness in float64, the launch count of one 160x80
    fh batch (none of this pair: each preconditioner call launches the fused
    pair twice and the coarse apply once), and device time (CUDA graphs)
    beside the bound and the plain version's."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.hat_transfer_kernel import (
        hat_transfer,
        hat_transfer_reference,
        launch_plan,
    )
    from vbicm_tpu_torch.ops.multigrid import hat_matrix
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.utils import trace

    t0 = time.perf_counter()
    out = {"err": {}, "bitwise": {}, "ms": {}}

    def case(B, cells, ratio, ndof, dtype, seed):
        nf = [c * ratio + 1 for c in cells]
        nc = [c + 1 for c in cells]
        ps = [torch.as_tensor(hat_matrix(f, c, ratio), dtype=dtype, device=dev)
              for f, c in zip(nf, nc)]
        pts = [p.T.contiguous() for p in ps]
        rng = np.random.default_rng(seed)
        u = torch.as_tensor(rng.normal(size=(B, ndof * int(np.prod(nc)))), dtype=dtype,
                            device=dev)
        r = torch.as_tensor(rng.normal(size=(B, ndof * int(np.prod(nf)))), dtype=dtype,
                            device=dev)
        return ps, pts, u, r

    before = launched("hat_transfer")
    calls = 0
    for B, cells, ratio, ndof in TRANSFER_SHAPES:
        for dtype in (torch.float32, torch.float64):
            ps, pts, u, r = case(B, cells, ratio, ndof, dtype, seed=B + sum(cells))
            got = {"prolong": hat_transfer(u, ps, cells, ratio, ndof, adjoint=False),
                   "restrict": hat_transfer(r, pts, cells, ratio, ndof, adjoint=True)}
            again = {"prolong": hat_transfer(u, ps, cells, ratio, ndof, adjoint=False),
                     "restrict": hat_transfer(r, pts, cells, ratio, ndof, adjoint=True)}
            want = {"prolong": hat_transfer_reference(u, ps, cells, ratio, adjoint=False),
                    "restrict": hat_transfer_reference(r, pts, cells, ratio, adjoint=True)}
            calls += 4
            torch.cuda.synchronize()
            for way in ("prolong", "restrict"):
                err = rel_err(got[way], want[way])
                key = f"{way} {B}x{'x'.join(map(str, cells))} r{ratio} d{ndof} {dtype}"
                if not err <= REL_TOL[dtype]:
                    fail(f"hat {key}: rel err vs plain {err} > {REL_TOL[dtype]}")
                if not torch.equal(got[way], again[way]):
                    fail(f"hat {key}: two calls are not bitwise equal")
                out["err"][key] = err
                out["bitwise"][key] = bool(torch.equal(got[way], want[way]))
            if dtype == torch.float64:
                lhs = (got["prolong"] * r).sum(1)
                rhs = (u * got["restrict"]).sum(1)
                adj = float(((lhs - rhs).abs() / (u.norm(dim=1) * r.norm(dim=1))).max())
                if not adj <= 1e-12:
                    fail(f"hat {B}x{cells} r{ratio}: <P u, r> - <u, R r> {adj} > 1e-12")
                out.setdefault("adjoint", 0.0)
                out["adjoint"] = max(out["adjoint"], adj)
    if launched("hat_transfer") - before != calls:
        fail(f"hat transfers launched {launched('hat_transfer') - before} times in {calls} calls")
    worst = {dt: max(v for k, v in out["err"].items() if k.endswith(str(dt)))
             for dt in (torch.float32, torch.float64)}
    at_cells = {k: v for k, v in out["bitwise"].items() if k.split(" ")[1] == "256x20x40"}
    print(f"[48 hat transfer] ok: kernel vs plain max rel err f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12) over (B, cells, ratio, "
          f"dofs) in {TRANSFER_SHAPES}; two calls bitwise equal; <P u, r> = <u, R r> to "
          f"{out['adjoint']:.2e} (f64, tol 1e-12); bitwise equal to plain at the cells' shape: "
          f"{at_cells}; bitwise over all {sum(out['bitwise'].values())} of "
          f"{len(out['bitwise'])}", flush=True)

    # the launch count of one fh batch on the benchmark cells' solver
    model = build_fem_model(cooks_membrane_mesh(160, 80), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(40, 20), device=dev, dense=True)
    solve = make_two_level_solver(model, coarse, 40, 20, 4, cg_dtype=torch.float32,
                                  refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=40 * 160 + 12)
    fh = make_fh_fun(model, cfg, solve_free=solve)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(48),
                         dtype=torch.float64).to(dev)
    before = trace.counters()
    with torch.no_grad():
        fh(thetas)
    torch.cuda.synchronize()
    out["launches_fh"] = launched("hat_transfer", before)
    fused_fh = launched("hat_transfer_prec", before)
    prec_calls = trace.counters().get("prec.calls.fused", 0) - before.get("prec.calls.fused", 0)
    if not (prec_calls > 0 and out["launches_fh"] == 0 and fused_fh == 2 * prec_calls
            and launched("spectral_apply", before) == prec_calls):
        fail(f"one 160x80 fh batch: {out['launches_fh']} plain and {fused_fh} fused transfer "
             f"launches for {prec_calls} fused preconditioner calls (want none of the plain "
             "pair, two of the fused pair and one coarse apply a call)")
    print(f"[48 hat transfer] ok: one 160x80 fh batch (B = 256): {out['launches_fh']} plain "
          f"transfer launches, {fused_fh} fused = 2 x {prec_calls} fused preconditioner calls",
          flush=True)

    # device time beside the bound and the plain version's
    for B, cells, ratio, ndof in TRANSFER_TIMED:
        for dtype in (torch.float32, torch.float64):
            ps, pts, u, r = case(B, cells, ratio, ndof, dtype, seed=1)
            bound = hat_least_time(B, cells, ratio, ndof, dtype)
            plan = launch_plan(B, cells, ratio, ndof, u.element_size())
            for way, x, mats, adjoint in (("prolong", u, ps, False), ("restrict", r, pts, True)):
                t = kernel_times(
                    lambda: hat_transfer(x, mats, cells, ratio, ndof, adjoint=adjoint),
                    lambda: hat_transfer_reference(x, mats, cells, ratio, adjoint=adjoint),
                    bound)
                out["ms"][B, cells, dtype, way] = t
                print(f"[48 times] hat {way} (B={B}, cells {cells}, ratio {ratio}, {ndof} dofs) "
                      f"{dtype}, {plan}: device kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms; eager kernel {t['ms_eager']:.4f} ms; bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['share_of_bound']:.1f} "
                      f"% of it, on {card}", flush=True)
    print(f"[48 hat transfer] {time.perf_counter() - t0:.2f} s", flush=True)
    return out



# The two-level preconditioner's fused pair (phase 50): (B, fine cells, ratio)
# of the paths that run it. The benchmark cells' 160x80 over 40x20, a ratio-2
# 80x40 over 40x20, the 3-D trainer's 32x8x8 over 16x4x4 and the 64x16x16 over
# 16x4x4 at ratio 4 (bench.py's box, B = 64), each with a coarse support set
PREC_MAIN = (256, (160, 80), 4)
PREC_SHAPES = [PREC_MAIN, (256, (80, 40), 2), (256, (32, 8, 8), 2), (64, (64, 16, 16), 4)]
# a fused call's kernels: the coefficients' cast, the restriction, #1's two,
# the prolongation
PREC_LAUNCHES = 5
# the preconditioner's calls each way and the launches of each transfer pair
PREC_COUNTERS = ("prec.calls.fused", "prec.calls.plain", "hat_transfer_prec.launches",
                 "hat_transfer.launches")


def prec_case(dev, fine_cells, ratio):
    """(fine model, coarse model, transfer pair, coarse cells slowest first,
    dofs a node) of a two-level solver: Cook's membrane for 2 axes, the hex8
    box for 3, as solver.make_two_level_solver{,_box3d} build them."""
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.multigrid import make_grid_transfer_nd

    coarse_cells = tuple(c // ratio for c in fine_cells)
    if len(fine_cells) == 2:
        fine = build_fem_model(cooks_membrane_mesh(*fine_cells), device=dev, dense=False)
        coarse = build_fem_model(cooks_membrane_mesh(*coarse_cells), device=dev, dense=True)
        ndof = 2
    else:
        sec = SectionCard(stype=4)
        fine = build_fem_model(beam_hex8_mesh(*fine_cells), sec, device=dev, dense=False)
        coarse = build_fem_model(beam_hex8_mesh(*coarse_cells), sec, device=dev, dense=True)
        ndof = 3
    cells = coarse_cells[::-1]  # slowest first
    return fine, coarse, make_grid_transfer_nd(cells, ratio, ndof, device=dev), cells, ndof


def prec_least_time(B, cells, ratio, ndof, nfree, dtype, way):
    """least_time of one kernel of the pair: the restriction reads r and the
    mask and writes the compact coarse vectors; the prolongation reads
    those, r, D^-1 and the mask and writes z; each reads the int32 slot
    table. Operations: the transfer's multiply-adds (:func:`hat_macs`) and a
    product a fine value (r m) in the restriction, five in the prolongation
    (r m, omega D^-1, their product, z_f m and the sum)."""
    itemsize = torch.finfo(dtype).bits // 8
    n_f = ndof * int(np.prod([c * ratio + 1 for c in cells]))
    n_c = ndof * int(np.prod([c + 1 for c in cells]))
    flops = 2 * B * ndof * hat_macs(cells, ratio)
    if way == "restrict":
        nbytes, flops = itemsize * (B * n_f + n_f + B * nfree) + 4 * n_c, flops + B * n_f
    else:
        nbytes, flops = itemsize * (B * nfree + 3 * B * n_f + n_f) + 4 * n_c, flops + 5 * B * n_f
    return least_time(nbytes, flops, dtype)


def device_kernels(fn):
    """The names of the device kernels (and copies) that one call of ``fn``
    ran, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation()]


def host_us(fn, reps=50):
    """Host µs a call of ``fn``: the time to enqueue ``reps`` calls after a
    warm-up, the card synchronised before (not inside) the timed run."""
    for n in (5, reps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(n):
            fn()
        toc = time.perf_counter()
    torch.cuda.synchronize()
    return (toc - tic) / reps * 1e6


def prec_path(dev, card):
    """Phase 50: the two-level preconditioner's fused pair (csrc/hat_transfer.cu,
    ``hat_restrict_prec_kernel``, ``hat_prolong_prec_kernel``): the fused call
    torch.equal to the composition it replaces (the plain form, which the
    preconditioner takes on the transfers handed as a plain tuple: PyTorch
    ops around the plain transfer kernels) at PREC_SHAPES in float32 and
    float64, with the solvers' coefficients and with the mean field's
    constant ones; its kernels (PREC_LAUNCHES); the counters around one
    160x80 fh batch (every call fused, two launches of the fused pair each,
    none of the plain pair); device
    time of each kernel beside its bound and its plain version's, and of
    the whole call fused and composed (CUDA graphs; the host's µs a call
    beside), the 3-D fused call no slower than the composed one."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.ops.hat_transfer_kernel import free_slots, launch_plan
    from vbicm_tpu_torch.ops.multigrid import make_two_level_preconditioner
    from vbicm_tpu_torch.solver import (
        _make_free_embed,
        make_coarse_spectral_apply,
        make_fh_fun,
        make_two_level_solver,
    )
    from vbicm_tpu_torch.utils import trace

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    out = {"ms": {}, "call_ms": {}, "host_us": {}}
    coeffs0 = torch.tensor(lame_from_Ev(20.0, 0.3), dtype=f64, device=dev)  # the mean field's
    for B, fine_cells, ratio in PREC_SHAPES:
        fine, coarse, transfer, cells, ndof = prec_case(dev, fine_cells, ratio)
        coarse_apply = make_coarse_spectral_apply(coarse)
        nfree = int(coarse.nfree)
        embed = _make_free_embed(coarse)
        prec = make_two_level_preconditioner(coarse_apply, fine.free_mask, transfer, omega=0.6)
        composed = make_two_level_preconditioner(coarse_apply, fine.free_mask, tuple(transfer),
                                                 omega=0.6)
        tag = f"{B}x{'x'.join(map(str, fine_cells))} r{ratio}"
        for dtype in (f32, f64):
            g = torch.Generator(device=dev).manual_seed(B + ratio + sum(fine_cells))
            mask = fine.free_mask.to(dtype)
            r = torch.randn((B, fine.ndof), generator=g, device=dev, dtype=dtype)
            dinv = 0.01 + 0.09 * torch.rand((B, fine.ndof), generator=g, device=dev, dtype=dtype)
            dinv = torch.where(mask > 0, dinv, torch.ones_like(dinv))
            coeffs = torch.stack([8.0 + 8.0 * torch.rand(B, generator=g, device=dev, dtype=f64),
                                  6.0 + 3.0 * torch.rand(B, generator=g, device=dev, dtype=f64)],
                                 -1)
            mean = coeffs0.to(dtype).expand(B, 2)
            before = trace.counters()
            got = [prec(coeffs, dinv, r), prec(coeffs, dinv, r), prec(mean, dinv, r)]
            torch.cuda.synchronize()
            after = trace.counters()
            want = [composed(coeffs, dinv, r), composed(mean, dinv, r)]
            torch.cuda.synchronize()
            moved = {k: after.get(k, 0) - before.get(k, 0) for k in PREC_COUNTERS}
            if moved != {"prec.calls.fused": 3, "prec.calls.plain": 0,
                         "hat_transfer_prec.launches": 6, "hat_transfer.launches": 0}:
                fail(f"prec {tag} {dtype}: counters {moved} over 3 calls (want 3 fused calls, "
                     "6 launches of the fused pair, none of the plain pair)")
            same = (torch.equal(got[0], want[0]), torch.equal(got[0], got[1]),
                    torch.equal(got[2], want[1]))
            if not all(same):
                err = max(rel_err(got[0], want[0]), rel_err(got[2], want[1]))
                fail(f"prec {tag} {dtype}: fused vs composed (coeffs, two calls, mean field) "
                     f"torch.equal {same}; max rel err {err:.3e}")
        print(f"[50 prec] ok: {tag} ({nfree} free of {coarse.ndof} coarse dofs), f32 and f64: "
              "the fused call torch.equal to the composition, with the solvers' and the mean "
              "field's coefficients; two calls bitwise equal; every call fused, 2 launches of "
              "the fused pair each, none of the plain pair", flush=True)

        # times, float32 (and float64 at the cells' shape)
        for dtype in ((f32, f64) if (B, fine_cells, ratio) == PREC_MAIN else (f32,)):
            g = torch.Generator(device=dev).manual_seed(1)
            mask = fine.free_mask.to(dtype)
            r = torch.randn((B, fine.ndof), generator=g, device=dev, dtype=dtype)
            dinv = torch.where(mask > 0, 0.05, 1.0).to(dtype).expand(B, -1).contiguous()
            coeffs = coeffs0.expand(B, 2).contiguous()
            slots = free_slots(coarse.free_dof, coarse.ndof)
            rc = transfer.restrict_free(r, mask, slots, nfree)
            plan = launch_plan(B, cells, ratio, ndof, r.element_size())
            # each kernel's plain version: the composition's ops it replaces
            for way, kernel, plain in (
                    ("restrict", lambda: transfer.restrict_free(r, mask, slots, nfree),
                     lambda: transfer.restrict(r * mask)[:, coarse.free_dof]),
                    ("prolong", lambda: transfer.prolong_smooth(rc, slots, r, dinv, mask, 0.6),
                     lambda: 0.6 * dinv * (r * mask) + transfer.prolong(embed(rc)) * mask)):
                t = kernel_times(kernel, plain,
                                 prec_least_time(B, cells, ratio, ndof, nfree, dtype, way))
                out["ms"][B, fine_cells, dtype, way] = t
                print(f"[50 times] hat {way} prec ({tag}, {ndof} dofs) {dtype}, {plan}: device "
                      f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager kernel "
                      f"{t['ms_eager']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                      f"{100 * t['share_of_bound']:.1f} % of it, on {card}", flush=True)
            fused_call = lambda: prec(coeffs, dinv, r)  # noqa: E731
            composed_call = lambda: composed(coeffs, dinv, r)  # noqa: E731
            dev_ms = [graph_ms(composed_call), graph_ms(fused_call), graph_ms(fused_call),
                      graph_ms(composed_call)]
            call = {"fused_ms": min(dev_ms[1:3]), "composed_ms": min(dev_ms[0], dev_ms[3]),
                    "fused_ms_eager": time_ms(fused_call, warmup=5, reps=50),
                    "composed_ms_eager": time_ms(composed_call, warmup=5, reps=50),
                    "fused_host_us": host_us(fused_call),
                    "composed_host_us": host_us(composed_call)}
            out["call_ms"][B, fine_cells, dtype] = call
            print(f"[50 times] prec call ({tag}) {dtype}: device fused {call['fused_ms']:.4f} ms, "
                  f"composed {call['composed_ms']:.4f} ms; eager fused "
                  f"{call['fused_ms_eager']:.4f} ms, composed {call['composed_ms_eager']:.4f} ms;"
                  f" host fused {call['fused_host_us']:.1f} us, composed "
                  f"{call['composed_host_us']:.1f} us a call, on {card}", flush=True)
            if len(fine_cells) == 3 and call["fused_ms"] > call["composed_ms"]:
                fail(f"prec {tag} {dtype}: the fused call ({call['fused_ms']:.4f} ms) is slower "
                     f"than the composed one ({call['composed_ms']:.4f} ms)")
            if (B, fine_cells, ratio) == PREC_MAIN and dtype == f32:
                out["kernels_fused"] = device_kernels(fused_call)
                out["kernels_composed"] = device_kernels(composed_call)
                fc = torch.stack([coeffs0] * B)  # the solvers' float64 coefficients
                out["kernels_fused_f64_coeffs"] = device_kernels(lambda: prec(fc, dinv, r))
                print(f"[50 prec] {tag} f32: a fused call ran {len(out['kernels_fused'])} "
                      f"kernels ({out['kernels_fused']}), with float64 coefficients "
                      f"{len(out['kernels_fused_f64_coeffs'])}; the composed call "
                      f"{len(out['kernels_composed'])} ({out['kernels_composed']})", flush=True)
                if not (len(out["kernels_fused"]) == PREC_LAUNCHES
                        == len(out["kernels_fused_f64_coeffs"])):
                    fail(f"a fused prec call ran {len(out['kernels_fused'])} and "
                         f"{len(out['kernels_fused_f64_coeffs'])} kernels (want "
                         f"{PREC_LAUNCHES})")

    # the counters of one fh batch on the benchmark cells' solver
    fine, coarse, _, _, _ = prec_case(dev, (160, 80), 4)
    solve = make_two_level_solver(fine, coarse, 40, 20, 4, cg_dtype=f32, refine_iters=1,
                                  tol=3e-3, maxiter=400, use_stencil=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=fine.nnodes, ele_id=40 * 160 + 12)
    fh = make_fh_fun(fine, cfg, solve_free=solve)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(50),
                         dtype=torch.float64).to(dev)
    before = trace.counters()
    with torch.no_grad():
        fh(thetas)
    torch.cuda.synchronize()
    after = trace.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in PREC_COUNTERS}
    if not (moved["prec.calls.fused"] > 0 and moved["prec.calls.plain"] == 0
            and moved["hat_transfer.launches"] == 0
            and moved["hat_transfer_prec.launches"] == 2 * moved["prec.calls.fused"]):
        fail(f"one 160x80 fh batch: counters {moved} (want every preconditioner call fused, "
             "two launches of the fused pair each, none of the plain pair)")
    out["fh_counters"] = moved
    print(f"[50 prec] ok: one 160x80 fh batch (B = 256): {moved}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return out


# CG's vector updates (phase 49), (B, n): the benchmark cells' 160x80 lanes
# (26,082 values, 256 a batch), a small batch, one long lane, an odd n (rows
# not aligned to a pair load) and the 3-D 32x8x8 box's 8,019 dofs at a
# ragged batch
CG_MAIN = (256, 26082)
CG_SHAPES = [CG_MAIN, (7, 1000), (1, 26082), (5, 1001), (300, 8019)]
# a lane's state before the step, by lane index modulo 6
CG_LANE_STATES = ("active", "converged", "frozen", "nan residual", "alpha breakdown",
                  "beta breakdown")
CG_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# pcg through the kernel pair against the plain loop on the cells' solver
# (CG tol 3e-3, one float64 refinement): the largest lane's relative
# distance between the solutions; a lane's iterations may differ by one
CG_PCG_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def cg_lane_state(B, n, dtype, dev, seed, timing=False):
    """A CG loop's state before a step, the step's kp and the sign of its
    z = sign 0.5 r: lanes in the states of CG_LANE_STATES by lane index
    modulo 6 (a breakdown at the alpha step with an infinity in p, so that
    0 times it is NaN; at the beta step a negative (r, z)), or with
    ``timing`` every lane active and staying so. rz is p.kp times a factor
    in [0.5, 1.5), so that alpha and beta are of order one and both terms
    of each update count. Returns (state, kp, sign), state the
    (x, r, p, rz, rr, thresh, it, dead) of ``CgUpdate*``."""
    from vbicm_tpu_torch.ops.cg_update_kernel import dot

    g = torch.Generator(device=dev).manual_seed(seed)
    x, r, p = (torch.randn((B, n), generator=g, device=dev, dtype=dtype) for _ in range(3))
    kp = p * (torch.rand((B, n), generator=g, device=dev, dtype=dtype) + 0.5)
    rz = dot(p, kp) * (torch.rand(B, generator=g, device=dev, dtype=dtype) + 0.5)
    rr = dot(r, r)
    thresh = torch.zeros_like(rr) if timing else 1e-6 * rr
    it = torch.randint(0, 50, (B,), generator=g, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    sign = torch.ones(B, dtype=dtype, device=dev)
    if not timing:
        lanes = torch.arange(B, device=dev) % len(CG_LANE_STATES)
        thresh = torch.where(lanes == 1, 2 * rr, thresh)
        dead |= lanes == 2
        nan = lanes == 3
        r[nan, 3] = float("nan")
        rr = torch.where(nan, float("nan"), rr)
        brk = lanes == 4
        kp = torch.where(brk[:, None], -kp, kp)
        p[brk, 7] = float("inf")
        kp[brk, 7] = -float("inf")
        sign = torch.where(lanes == 5, -1.0, sign)
    return (x, r, p, rz, rr, thresh, it, dead), kp, sign


def cg_one_step(update, state, kp, sign):
    """One loop step through ``update`` (``CgUpdateKernel`` or
    ``CgUpdatePlain``) on a copy of ``state``, with z = sign 0.5 r; the
    state after it (x, r, p, rz, rr, it, dead, active)."""
    u = update(*(t.clone() for t in state))
    r_p = u.alpha(kp)
    u.beta(sign[:, None] * (0.5 * r_p))
    return {"x": u.x, "r": u.r, "p": u.p, "rz": u.rz, "rr": u.rr, "it": u.it, "dead": u.dead,
            "active": u.active}


def cg_bits(t):
    """The tensor's bits, so that NaNs compare equal."""
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype, t.dtype))


def cg_state_err(got, want, before=None):
    """Largest error of the float tensors relative to max|want| over their
    finite entries (inf where NaNs or infinities sit elsewhere), and
    whether the flags and counts are equal. With ``before`` (the state the
    step started from, x, r, p first), also the error of the updates to x,
    r and p relative to the largest update, so that a wrong alpha or beta
    shows however small the step."""
    err = 0.0
    for k in ("x", "r", "p", "rz", "rr"):
        g, w = got[k], want[k]
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)) or not torch.equal(g[~fin].isnan(),
                                                                       w[~fin].isnan()):
            return float("inf"), False
        if bool(fin.any()):
            err = max(err, float((g[fin] - w[fin]).abs().max() / w[fin].abs().max()))
    for k, b in zip(("x", "r", "p"), before or ()):
        fin = torch.isfinite(want[k]) & torch.isfinite(b)
        dg, dw = got[k][fin] - b[fin], want[k][fin] - b[fin]
        top = float(dw.abs().max()) if dw.numel() else 0.0
        gap = float((dg - dw).abs().max()) if dw.numel() else 0.0
        err = max(err, gap / top if top > 0 else (0.0 if gap == 0 else float("inf")))
    flags = all(torch.equal(got[k], want[k]) for k in ("it", "dead", "active"))
    return err, flags


def cg_least_time(B, n, dtype, beta):
    """least_time of one step on B active lanes of n values: the alpha step
    reads p, kp, x, r and writes x, r (8 flops a value: the dot, two updates,
    r.r), the beta step reads r, z, p and writes p (4 flops a value); each
    lane's scalars read and written once."""
    itemsize = torch.finfo(dtype).bits // 8
    vectors, flops = (4, 4) if beta else (6, 8)
    scalars = B * (4 * itemsize + 8 + 3) if beta else B * (2 * itemsize + 2)
    return least_time(vectors * B * n * itemsize + scalars, flops * B * n, dtype)


def cg_update_path(dev, card):
    """Phase 49: CG's vector updates (csrc/cg_update.cu) against their plain
    version with lanes in every state (CG_TOL of max|want|; flags and counts
    equal), two launches bitwise equal, no spills in the plan's instances,
    device time (CUDA graphs) beside the bound and the plain version's at
    CG_MAIN, and pcg on the benchmark cells' 160x80 stencil path against the
    plain loop (per-lane iterations within one, the solution within
    CG_PCG_TOL) with two launches a loop step."""
    import dataclasses
    import re

    import vbicm_tpu_torch.ops.solve as solve_mod
    from vbicm_tpu_torch import _build
    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.cg_update_kernel import (
        CgUpdateKernel,
        CgUpdatePlain,
        cg_update_reference_alpha,
        cg_update_reference_beta,
        kernel_fit,
        launch_plan,
    )
    from vbicm_tpu_torch.ops.element import material_coeffs
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.utils import trace

    t0 = time.perf_counter()
    out = {"err": {}, "ms": {}}
    f32, f64 = torch.float32, torch.float64

    # the build: every instance without spills
    _, _, log = _build.load_library()
    inst = {k: v for k, v in ptxas_by_kernel(log).items() if re.search(r"cg_(alpha|beta)_step", k)}
    if len(inst) != 2 * 2:  # (alpha, beta) x (f32, f64)
        fail(f"expected 4 CG update kernel instances in the ptxas log, found {sorted(inst)}")
    spills = {k: v for k, v in inst.items() if v[1] or v[2]}
    if spills:
        fail(f"CG update kernels spill: {spills}")
    plan = launch_plan(CG_MAIN[1])
    fits = {}
    for dtype in (f32, f64):
        for beta in (False, True):
            fits[dtype, beta] = kernel_fit(dtype, beta, plan.cluster)
            if fits[dtype, beta] is None or fits[dtype, beta][0] < 1:
                fail(f"CG update kernel {dtype} beta={beta} {plan}: fit {fits[dtype, beta]} "
                     "(clusters resident, registers, local bytes)")
    print(f"[49 cg update] build: {len(inst)} instances, none spilling; the plan at {CG_MAIN}, "
          f"{plan}: " + "; ".join(f"{dt} {'beta' if b else 'alpha'} clusters resident {v[0]}, "
                                  f"{v[1]} regs" for (dt, b), v in fits.items()), flush=True)

    # the kernel pair against the plain version, lanes in every state
    before = launched("cg_update")
    calls = 0
    for B, n in CG_SHAPES:
        for dtype in (f32, f64):
            state, kp, sign = cg_lane_state(B, n, dtype, dev, seed=B + n)
            got = cg_one_step(CgUpdateKernel, state, kp, sign)
            again = cg_one_step(CgUpdateKernel, state, kp, sign)
            want = cg_one_step(CgUpdatePlain, state, kp, sign)
            calls += 4
            torch.cuda.synchronize()
            err, flags = cg_state_err(got, want, before=state)
            key = f"{B}x{n} {dtype}"
            if not (err <= CG_TOL[dtype] and flags):
                fail(f"cg update {key}: rel err vs plain {err} (tol {CG_TOL[dtype]}), flags and "
                     f"counts equal: {flags}")
            if not all(torch.equal(cg_bits(got[k]), cg_bits(again[k])) for k in got):
                fail(f"cg update {key}: two launches are not bitwise equal")
            out["err"][key] = err
    counted = launched("cg_update") - before
    if counted != calls:
        fail(f"cg update: {counted} launches counted for {calls}")
    worst = {dt: max(v for k, v in out["err"].items() if k.endswith(str(dt))) for dt in (f32, f64)}
    print(f"[49 cg update] ok: kernel pair vs plain, lanes {CG_LANE_STATES} by index mod 6, max "
          f"rel err (of the state and of the updates to x, r, p, each of its own max) f32 "
          f"{worst[f32]:.3e} (tol {CG_TOL[f32]}), f64 {worst[f64]:.3e} (tol "
          f"{CG_TOL[f64]}) over (B, n) in {CG_SHAPES}; flags, counts and NaNs equal; two "
          "launches bitwise equal", flush=True)

    # device time beside the bound and the plain version's
    for dtype in (f32, f64):
        B, n = CG_MAIN
        state, kp, sign = cg_lane_state(B, n, dtype, dev, seed=3, timing=True)
        u = CgUpdateKernel(*(t.clone() for t in state))
        x, r, p, rz, _, thresh, it, dead = (t.clone() for t in state)
        active = ~dead
        bad = torch.zeros_like(dead)
        u.alpha(kp)  # the partials the beta step reads
        for beta in (False, True):
            if beta:
                kernel = lambda: u.beta(u.r)  # noqa: E731
                plain = lambda: cg_update_reference_beta(  # noqa: E731
                    r, p, r, r, rz, it, dead, active, bad, thresh)
            else:
                kernel = lambda: u.alpha(kp)  # noqa: E731
                plain = lambda: cg_update_reference_alpha(x, r, p, kp, rz, active)  # noqa: E731
            t = kernel_times(kernel, plain, cg_least_time(B, n, dtype, beta))
            if not bool(u.active.all()):
                fail("cg update timing: a lane went inactive")
            out["ms"][dtype, beta] = t
            print(f"[49 times] cg {'beta' if beta else 'alpha'} step (B={B}, n={n}) {dtype}, "
                  f"{u.plan}: device kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager "
                  f"kernel {t['ms_eager']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"{100 * t['share_of_bound']:.1f} % of it, on {card}", flush=True)

    # the host's cost a launch: alpha and beta steps back to back at a tiny
    # lane, where the host is the slower; the plain version's a step beside
    state, kp, sign = cg_lane_state(1, 1000, f32, dev, seed=5, timing=True)
    host = {}
    for way in ("kernel", "plain"):
        u = (CgUpdateKernel if way == "kernel" else CgUpdatePlain)(*(t.clone() for t in state))
        for reps in (50, 2000):  # a warm-up, then the timed run
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(reps):
                u.beta(sign[:, None] * u.alpha(kp))
            torch.cuda.synchronize()
            host[way] = (time.perf_counter() - tic) / reps * 1e6
    out["host_us_a_step"] = host
    print(f"[49 times] host time a loop step's vector work at (1, 1000) f32 (two launches, the "
          f"z it reads made by one more op): kernel pair {host['kernel']:.1f} us, plain "
          f"{host['plain']:.1f} us, on {card}", flush=True)

    # pcg on the benchmark cells' solver against the plain loop
    def plain_pcg(matvec, b, prec, *, tol, maxiter):
        return solve_mod._pcg(matvec, b, prec, tol, maxiter, CgUpdatePlain, "pcg.steps.plain")

    model = build_fem_model(cooks_membrane_mesh(160, 80), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(40, 20), device=dev, dense=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=40 * 160 + 12)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(49),
                         dtype=torch.float64).to(dev)
    tm = torch.tensor(cfg.theta_map.theta_mean, dtype=torch.float64, device=dev)
    ts = torch.tensor(cfg.theta_map.theta_std, dtype=torch.float64, device=dev)
    E = torch.exp(ts[0] * thetas[:, 0] + tm[0])
    v = 0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1])
    c0, c1 = material_coeffs(model.stype, E, v)
    out["pcg"] = {}
    for cg_dtype in (f32, f64):
        solve = make_two_level_solver(model, coarse, 40, 20, 4, cg_dtype=cg_dtype,
                                      refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True)
        solver = solve.solver
        runs = {}
        for way in ("fused", "plain"):
            saved = solve_mod.pcg
            if way == "plain":
                solve_mod.pcg = plain_pcg
            try:
                before = trace.counters()
                with torch.no_grad():
                    u = solve(c0, c1)
                torch.cuda.synchronize()
                after = trace.counters()
            finally:
                solve_mod.pcg = saved
            moved = {k: after.get(k, 0) - before.get(k, 0)
                     for k in ("cg_update.launches", "pcg.steps.fused", "pcg.steps.plain")}
            runs[way] = (u, [it.clone() for it in solver.last_cg_iters], moved)
        (uf, itf, mf), (up, itp, mp) = runs["fused"], runs["plain"]
        if not (mf["pcg.steps.fused"] > 0 and mf["pcg.steps.plain"] == 0
                and mf["cg_update.launches"] == 2 * mf["pcg.steps.fused"]):
            fail(f"pcg {cg_dtype} on the 160x80 stencil path: counters {mf} (want 2 launches "
                 "a fused step, no plain step)")
        if mp["cg_update.launches"] or mp["pcg.steps.fused"]:
            fail(f"the plain loop launched the kernels: {mp}")
        dit = [int((a - b).abs().max()) for a, b in zip(itf, itp)]
        nlanes = [int((a != b).sum()) for a, b in zip(itf, itp)]
        means = [(float(a.double().mean()), float(b.double().mean())) for a, b in zip(itf, itp)]
        xrel = float(((uf - up).norm(dim=1) / up.norm(dim=1)).max())
        out["pcg"][cg_dtype] = dict(iters_max_diff=dit, lanes_differing=nlanes, iters_mean=means,
                                    x_rel=xrel, counters=mf)
        print(f"[49 cg update] pcg on the 160x80 stencil path, B = 256, CG {cg_dtype} tol 3e-3 + 1 "
              f"refinement: per-lane iterations (CG, refinement) fused vs plain max |diff| {dit}, "
              f"lanes differing {nlanes}, means {means}; solution max lane rel diff {xrel:.3e}; "
              f"counters {mf} (2 launches a loop step)", flush=True)
        if not (xrel <= CG_PCG_TOL[cg_dtype] and max(dit) <= 1):
            fail(f"pcg {cg_dtype} fused vs plain: solutions differ by {xrel} of their norm (tol "
                 f"{CG_PCG_TOL[cg_dtype]}), a lane's iterations by up to {dit} (tol 1)")

    # both cells' paths: an fh batch forward and backward through the solve
    solve = make_two_level_solver(model, coarse, 40, 20, 4, cg_dtype=f32, refine_iters=1,
                                  tol=3e-3, maxiter=400, use_stencil=True)
    fh = make_fh_fun(model, cfg, solve_free=solve)
    th = thetas.clone().requires_grad_(True)
    before = trace.counters()
    y, h = fh(th)
    (y.sum() + h.sum()).backward()
    torch.cuda.synchronize()
    after = trace.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("cg_update.launches", "pcg.steps.fused", "pcg.steps.plain")}
    if not (moved["pcg.steps.fused"] > 0 and moved["pcg.steps.plain"] == 0
            and moved["cg_update.launches"] == 2 * moved["pcg.steps.fused"]):
        fail(f"one 160x80 fh batch with its adjoint: counters {moved}")
    out["fh_counters"] = moved
    print(f"[49 cg update] ok: one 160x80 fh batch (B = 256) with its adjoint: {moved}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return out


if __name__ == "__main__":
    main()

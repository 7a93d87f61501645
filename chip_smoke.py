"""On-card smoke test of the PyTorch port (``vbicm_tpu_torch``) on one GPU.

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version. Then four paths, each driven through the
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
  float64 refinement, 256 full-order solves per step-1 step);
- the 3-D hex8 box (phases 13-17): the 27-point stencil kernel on grids up
  to 64x16x16 (56,355 dofs), the box two-level solve against the JAX
  package's float64 golden (tests/fixtures/scaled_3d_golden.json) for the
  trainer's 32x8x8 cantilever and the 64x16x16 solve, its adjoint against
  the dense solve at 8x4x4, and dataset generation and the two-step trainer
  at 32x8x8 (8,019 dofs; float32 CG + one float64 refinement, input
  standardization, per-sample pairing);
- the element path (phases 18-23): the element kernel on quad4, randomly
  renumbered quad4 and hex8 meshes, Jacobi-PCG on matrix-free models
  against the dense solve, the element-path two-level solve at 160x80
  against the JAX golden and the stencil path, its adjoint at 40x20, and
  the scaled reduced-basis trainer (examples/train_scaled_rom_torch.py:
  the certified ROM inside the ELBO, the element-path two-level solver for
  its full-order spot check).

- the stencil-kernel study (phases 24-27): the one-row stencil kernel's
  rows-per-block option bitwise against it, the banded tensor-core stencil
  in both precision modes against its plain version and the float64
  stencil, the FMA-ceiling probe against its plain version, and
  examples/stencil_kernel_study_torch.py's main at 160x80, B = 256.

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
# the element kernel's meshes: (name, mesh factory, 3-D) -- quad4 Cook's,
# Cook's 20x10 with its nodes and elements renumbered from a seed (an
# unstructured dof map), hex8 boxes
ELEMENT_MESHES = [("8x4", lambda m: m.cooks_membrane_mesh(8, 4), False),
                  ("32x16", lambda m: m.cooks_membrane_mesh(32, 16), False),
                  ("160x80", lambda m: m.cooks_membrane_mesh(160, 80), False),
                  ("20x10 renumbered",
                   lambda m: m.renumber_mesh(m.cooks_membrane_mesh(20, 10), seed=3), False),
                  ("4x2x2", lambda m: m.beam_hex8_mesh(4, 2, 2), True),
                  ("32x8x8", lambda m: m.beam_hex8_mesh(32, 8, 8), True)]
# the study path (phases 24-27): rows_per_block values held bitwise against
# the one-row kernel (2 and 4 do not divide NY = 81, 8 divides none of the
# grids' NY), and the probe's (B, NY, XLP) shapes
ROWS_PER_BLOCK = (2, 3, 4, 8)
PROBE_SHAPES = [(1, 3, 128), (5, 7, 128), (300, 17, 256), (256, 81, 384)]
PROBE_MAIN = (256, 81, 384)  # the study's: B = 256, NY = 81, XLP = 384
# kernel #6 against its plain version, of max|q|: the same products (bf16x3)
# or 3xTF32 against full float32 products (f32), summed in another order;
# a CPU emulation of 3xTF32 at 160x80 is 1.8e-7 from the plain version.
# Against the float64 stencil: tests/test_pallas.py's bounds.
MXU_TOL_PLAIN = 5e-6
MXU_TOL_EXACT = {"f32": 5e-6, "bf16x3": 5e-5}


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


def stencil_least_time(planes, c, u):
    """least_time of a stencil matvec: u and q once, the coefficient planes'
    nonzero entries once (the lane offsets that carry no coefficient, and the
    Dirichlet rows' zeros, are no work of the function), an FMA per nonzero
    coefficient per sample and the two-part combine per dof."""
    nnz = int(torch.count_nonzero(planes))
    nbytes = (2 * u.numel() + nnz + c.numel()) * u.element_size()
    return least_time(nbytes, 2 * nnz * u.shape[0] + 3 * u.numel(), u.dtype)


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
    ptxas = [ln.strip() for ln in build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[1 card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel build {build_s:.2f}s; ptxas: {' | '.join(ptxas)}", flush=True)

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
            x_only = spectral_apply_batched(V, g, c, b)
            xr, ar = spectral_apply_reference(V, g, c, b, return_coords=True)
            torch.cuda.synchronize()
            errs = (rel_err(x, xr), rel_err(a, ar), rel_err(x_only, xr))
            if not max(errs) <= REL_TOL[dtype]:
                fail(f"kernel vs plain at B={B} n={n} {dtype}: rel err x/a/x-only {errs}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), *errs)
            if dtype == torch.float32 and (B, n) == MAIN_SHAPE:
                main_abs_err = float((x - xr).abs().max())
    print(f"[2 kernel] ok: max rel err vs plain f32 {worst['torch.float32']:.3e} (tol 2e-5), "
          f"f64 {worst['torch.float64']:.3e} (tol 1e-12) over (B, n) in {SHAPES}, x and a",
          flush=True)

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
    spectral_apply_batched.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh32, n_sam=1024, ne_sam=4,
                           device=dev, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=4096)
    trainer = TwoStepTrainer(model, cfg, tcfg, factor_dtype=torch.float32, refine_iters=1)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    launches = spectral_apply_batched.launches
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
    for shape, reps in ((MAIN_SHAPE, 200), (COARSE_SHAPE, 50)):
        for dtype in (torch.float32, torch.float64):
            V, g, c, b = pencil_problem(*shape, seed=7, dtype=dtype, device=dev)
            Vt = V.T.contiguous()
            saved = spectral_apply_batched.launches
            k_ms = time_ms(lambda: spectral_apply_batched(V, g, c, b, return_coords=True, Vt=Vt),
                           warmup=reps // 10, reps=reps)
            p_ms = time_ms(lambda: spectral_apply_reference(V, g, c, b, return_coords=True),
                           warmup=reps // 10, reps=reps)
            spectral_apply_batched.launches = saved
            times[shape, dtype] = (k_ms, p_ms)
            print(f"[7 times] spectral apply (B, n)={shape} {dtype}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, on {card}", flush=True)

    scaled = scaled_path(dev, card)
    box = box3d_path(dev, card)
    elem = element_path(dev, card)
    study = study_path(dev, card)

    def spectral_bound(B, n):  # V, Vt, g, coeffs, b read; x, a written (f32)
        return least_time(4 * (2 * n * n + n + 2 * B + 3 * B * n), 4 * B * n * n + 3 * B * n)

    records = [{
        "name": "spectral_apply_batched",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/spectral_apply.cu",
        "replaces": "vbicm_tpu/ops/spectral_pallas.py:56",
        "launches": (launches + scaled["spectral_launches"] + box["spectral_launches"]
                     + elem["spectral_launches"]),
        "launches_by_path": {"cooks_20x10": launches,
                             "scaled_160x80": scaled["spectral_launches"],
                             "box3d_32x8x8": box["spectral_launches"],
                             "rom_160x80": elem["spectral_launches"]},
        "max_abs_err": main_abs_err,
        "ms": times[MAIN_SHAPE, torch.float32][0],
        "plain_ms": times[MAIN_SHAPE, torch.float32][1],
        "bound_ms": spectral_bound(*MAIN_SHAPE)[0],
        "bound_by": spectral_bound(*MAIN_SHAPE)[1],
        "library_ms": None,  # no one PyTorch call computes V diag(1/d) V^T b per sample
        "ms_coarse_256x1680": times[COARSE_SHAPE, torch.float32][0],
        "plain_ms_coarse_256x1680": times[COARSE_SHAPE, torch.float32][1],
        "bound_ms_coarse_256x1680": spectral_bound(*COARSE_SHAPE)[0],
        "ms_coarse_256x1200": box["spectral_ms"][0],
        "plain_ms_coarse_256x1200": box["spectral_ms"][1],
        "bound_ms_coarse_256x1200": spectral_bound(*BOX_COARSE_SHAPE)[0],
    }, {
        "name": "stencil_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil_pallas.py:71",
        "launches": scaled["stencil_launches"] + study["onerow_launches"],
        "launches_by_path": {"scaled_160x80": scaled["stencil_launches"],
                             "stencil_study_160x80": study["onerow_launches"]},
        "max_abs_err": scaled["stencil_abs_err"],
        "ms": scaled["stencil_ms"][torch.float32][0],
        "plain_ms": scaled["stencil_ms"][torch.float32][1],
        "bound_ms": scaled["stencil_bound"][0],
        "bound_by": scaled["stencil_bound"][1],
        "library_ms": scaled["stencil_ms"][torch.float32][2],
    }, {
        "name": "stencil3d_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil3d_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil3d_pallas.py:63",
        "launches": box["stencil3d_launches"],
        "launches_by_path": {"box3d_32x8x8": box["stencil3d_launches"]},
        "max_abs_err": box["stencil3d_abs_err"],
        "ms": box["stencil3d_ms"][(32, 8, 8), torch.float32][0],
        "plain_ms": box["stencil3d_ms"][(32, 8, 8), torch.float32][1],
        "bound_ms": box["stencil3d_bound"][32, 8, 8][0],
        "bound_by": box["stencil3d_bound"][32, 8, 8][1],
        "library_ms": box["stencil3d_ms"][(32, 8, 8), torch.float32][2],
        "ms_64x16x16": box["stencil3d_ms"][(64, 16, 16), torch.float32][0],
        "plain_ms_64x16x16": box["stencil3d_ms"][(64, 16, 16), torch.float32][1],
        "bound_ms_64x16x16": box["stencil3d_bound"][64, 16, 16][0],
        "library_ms_64x16x16": box["stencil3d_ms"][(64, 16, 16), torch.float32][2],
    }, {
        "name": "element_affine_matvec_kernel",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/element_matvec.cu",
        "replaces": "vbicm_tpu/ops/element_matvec_pallas.py:75",
        "launches": elem["element_launches"],
        "launches_by_path": {"rom_160x80": elem["element_launches"]},
        "max_abs_err": elem["element_abs_err"],
        "ms": elem["element_ms"][torch.float32][0],
        "plain_ms": elem["element_ms"][torch.float32][1],
        "bound_ms": elem["element_ms"][torch.float32][3][0],
        "bound_by": elem["element_ms"][torch.float32][3][1],
        "library_ms": elem["element_ms"][torch.float32][2],
        "ms_f64": elem["element_ms"][torch.float64][0],
        "bound_ms_f64": elem["element_ms"][torch.float64][3][0],
    }]
    f32, f64 = torch.float32, torch.float64
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
        "library_ms": scaled["stencil_ms"][f32][2],  # #2's function: phase 12's cuSPARSE pair
        "ms_rows_per_block_8": rows32[0][8],
        "ms_one_row_same_call": rows32[0][1],
        "ms_f64": rows64[0][3],
        "ms_f64_rows_per_block_8": rows64[0][8],
    }, {
        "name": "stencil_affine_matvec_mxu",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_mxu.cu",
        "replaces": "vbicm_tpu/ops/stencil_mxu.py:116",
        "launches": study["mxu_launches"],
        "launches_by_path": {"stencil_study_160x80": study["mxu_launches"]},
        "mode": "bf16x3",
        "max_abs_err": study["mxu_abs_err"]["bf16x3"],
        "ms": mxu["bf16x3"][0],
        "plain_ms": mxu["bf16x3"][1],
        "bound_ms": study["stencil_bound"][0],  # the function's (kernel #2's)
        "bound_by": study["stencil_bound"][1],
        "library_ms": scaled["stencil_ms"][f32][2],
        "bound_ms_densified": mxu["bf16x3"][2][0],
        "bound_by_densified": mxu["bf16x3"][2][1],
        "ms_f32": mxu["f32"][0],
        "plain_ms_f32": mxu["f32"][1],
        "max_abs_err_f32": study["mxu_abs_err"]["f32"],
        "bound_ms_densified_f32": mxu["f32"][2][0],
        "bound_by_densified_f32": mxu["f32"][2][1],
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
    from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_batched
    from vbicm_tpu_torch.ops.stencil import StencilOperator
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_matvec, stencil_affine_reference
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    out = {}
    # 8. stencil kernel against its plain version, ragged sample tiles
    worst = {}
    saved = stencil_affine_matvec.launches
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
                q = op.affine(c, u)
                qr = stencil_affine_reference(op.W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"stencil kernel vs plain at {nx}x{ny} B={B} {dtype}: rel err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (nx, B) == STENCIL_MAIN:
                    out["stencil_abs_err"] = float((q - qr).abs().max())
                    stencil_case = (op, c64, u64)
    stencil_affine_matvec.launches = saved
    print(f"[8 stencil] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12) over grids {STENCIL_GRIDS} "
          f"x B in {STENCIL_BATCHES}", flush=True)

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
    spectral_apply_batched.launches = 0
    stencil_affine_matvec.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=2048)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out["spectral_launches"] = spectral_apply_batched.launches
    out["stencil_launches"] = stencil_affine_matvec.launches
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"scaled trainer: non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("scaled predict: outputs not finite (8, 2) tensors")
    if out["spectral_launches"] <= 0 or out["stencil_launches"] <= 0:
        fail(f"the scaled trainer launched spectral {out['spectral_launches']}, stencil "
             f"{out['stencil_launches']} times; both must be > 0")
    print(f"[11 scaled trainer] ok: 160x80, n=256 x ne_sam 4, 2 + 2 epochs at batch 64; step1 "
          f"losses {res.hist_step1.tolist()}, step2 losses {res.hist_step2.tolist()}; kernel "
          f"launches stencil {out['stencil_launches']}, spectral {out['spectral_launches']}",
          flush=True)

    # 12. times (records, not a claim), each beside the card's name and limit
    steps = math.ceil(ds.n_sam / tcfg.batch_size) * (tcfg.num_epoch1 - 1)
    print(f"[12 times] scaled step-1 train steps/s (160x80, B=64x4, f32 CG + 1 f64 refinement, "
          f"epoch 2): {steps / sum(res.epoch_times_step1[1:]):.3f} on {card}", flush=True)
    op, c64, u64 = stencil_case
    out["stencil_ms"] = {}
    saved = stencil_affine_matvec.launches
    for dtype in (torch.float32, torch.float64):
        u, c = u64.to(dtype), c64.to(dtype)
        k_ms = time_ms(lambda: op.affine(c, u))
        p_ms = time_ms(lambda: stencil_affine_reference(op.W[dtype], c, u), warmup=5, reps=50)
        K, uT = assembled_csr(model, dtype), u.T.contiguous()
        lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
        if not lib_err <= REL_TOL[dtype]:
            fail(f"cuSPARSE yardstick vs stencil kernel at 160x80 {dtype}: rel err {lib_err}")
        l_ms = time_ms(lambda: library_affine(K, c, uT), warmup=5, reps=50)
        out["stencil_ms"][dtype] = (k_ms, p_ms, l_ms)
        if dtype == torch.float32:
            out["stencil_bound"] = stencil_least_time(op.planes[dtype], c, u)
        print(f"[12 times] stencil matvec (B=256, 160x80) {dtype}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, cuSPARSE yardstick {l_ms:.4f} ms (rel err {lib_err:.1e}), on "
              f"{card}", flush=True)
    stencil_affine_matvec.launches = saved
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
    import importlib.util

    from vbicm_tpu_torch import mesh as meshes
    from vbicm_tpu_torch.config import ProblemConfig, SectionCard
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element_kernel import ElementOperator, element_affine_matvec_kernel
    from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_batched
    from vbicm_tpu_torch.rom import build_reduced_basis, make_fh_fun_rom
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver

    out = {}
    f32, f64 = torch.float32, torch.float64
    # 18. the element kernel against its plain version, ragged sample tiles,
    #     two launches bitwise equal
    worst = {}
    saved = element_affine_matvec_kernel.launches
    for name, make, is3d in ELEMENT_MESHES:
        m = build_fem_model(make(meshes), SectionCard(stype=4) if is3d else SectionCard(),
                            device=dev, dense=False)
        op = ElementOperator(torch.stack([m.ke_lam, m.ke_mu]), m.lm, m.ndof)
        for B in ELEMENT_BATCHES:
            rng = np.random.default_rng(B + m.ndof)
            u64 = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (f32, f64):
                u, c = u64.to(dtype), c64.to(dtype)
                q, q2 = op.affine(c, u), op.affine(c, u)
                qr = element_affine_matvec(op.ke[dtype], m.lm, c, u, m.ndof)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"element kernel vs plain at {name} B={B} {dtype}: rel err {err}")
                if not torch.equal(q, q2):
                    fail(f"element kernel at {name} B={B} {dtype}: two launches differ")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if (name, B, dtype) == ("160x80", 256, f32):
                    out["element_abs_err"] = float((q - qr).abs().max())
            if (name, B) == ("160x80", 256):
                timed = (m, op, c64, u64)
    print(f"[18 element] ok: max rel err vs plain (of max|q|) f32 {worst[f32]:.3e} (tol 2e-5), "
          f"f64 {worst[f64]:.3e} (tol 1e-12), two launches bitwise equal, over "
          f"{[n for n, _, _ in ELEMENT_MESHES]} x B in {ELEMENT_BATCHES}", flush=True)
    m, op, c64, u64 = timed
    out["element_ms"] = {}
    for dtype in (f32, f64):
        u, c = u64.to(dtype), c64.to(dtype)
        k_ms = time_ms(lambda: op.affine(c, u), warmup=10, reps=100)
        p_ms = time_ms(lambda: element_affine_matvec(op.ke[dtype], m.lm, c, u, m.ndof),
                       warmup=3, reps=20)
        K, uT = assembled_csr(m, dtype), u.T.contiguous()
        lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
        if not lib_err <= REL_TOL[dtype]:
            fail(f"cuSPARSE yardstick vs element kernel at 160x80 {dtype}: rel err {lib_err}")
        l_ms = time_ms(lambda: library_affine(K, c, uT), warmup=3, reps=20)
        # u and q once, the blocks and the dof map once (not the kernel's own
        # incidence tables, which the function does not need); an FMA per
        # block entry per sample, and the two-part combine per dof
        nbytes = ((2 * u.numel() + op.ke[dtype].numel() + c.numel()) * u.element_size()
                  + 4 * op.lm.numel())
        flops = 2 * op.ke[dtype].numel() * u.shape[0] + 3 * u.numel()
        out["element_ms"][dtype] = (k_ms, p_ms, l_ms, least_time(nbytes, flops, dtype))
        print(f"[18 times] element matvec (B=256, 160x80) {dtype}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, cuSPARSE yardstick {l_ms:.4f} ms (rel err {lib_err:.1e}); bound "
              f"{out['element_ms'][dtype][3][0]:.4f} ms ({out['element_ms'][dtype][3][1]}), on "
              f"{card}", flush=True)
    element_affine_matvec_kernel.launches = saved

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
    spec = importlib.util.spec_from_file_location(
        "train_scaled_rom_torch", os.path.join(ROOT, "examples", "train_scaled_rom_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
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
    spectral_apply_batched.launches = 0
    element_affine_matvec_kernel.launches = 0
    summary = example.train_and_check(rom_model, rom_cfg, rb, nx, ny, n_data=256, epochs1=2,
                                      epochs2=2, seed=0, device=dev, verbose=False)
    torch.cuda.synchronize()
    out["element_launches"] = element_affine_matvec_kernel.launches
    out["spectral_launches"] = spectral_apply_batched.launches
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
    saved = (element_affine_matvec_kernel.launches, spectral_apply_batched.launches)
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
    element_affine_matvec_kernel.launches, spectral_apply_batched.launches = saved
    return out


def study_path(dev, card):
    """Phases 24-27: the stencil-kernel study (kernels #3, #6 and #7, and
    examples/stencil_kernel_study_torch.py at 160x80, B = 256)."""
    import importlib.util
    import tempfile

    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.peak_probe import (
        fma_peak_probe,
        fma_peak_probe_reference,
        fma_probe_flops,
    )
    from vbicm_tpu_torch.ops.stencil import StencilOperator, build_stencil_tables
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_matvec, stencil_affine_reference
    from vbicm_tpu_torch.ops.stencil_mxu import (
        KDIM,
        MODES,
        n_tiles,
        pack_w_bands,
        stencil_affine_matvec_mxu,
        stencil_affine_mxu_reference,
    )

    out = {}
    f32, f64 = torch.float32, torch.float64
    # 24. the rows-per-block option against the plain version (REL_TOL) and
    #     bitwise against the one-row kernel, on the same inputs
    saved = (stencil_affine_matvec.launches, stencil_affine_matvec.rows_launches)
    stencil_affine_matvec.rows_launches = 0
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
                        fail(f"rows_per_block={rpp} vs one-row kernel at {nx}x{ny} B={B} {dtype}: "
                             f"max abs diff {float((q1 - qr).abs().max())}")
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    if (nx, B, rpp) == (*STENCIL_MAIN, 3) and dtype == f32:
                        out["rows_abs_err"] = float((qr - qp).abs().max())
            if (nx, B) == STENCIL_MAIN:
                main_case = (c64, u64)
    rows_checked = stencil_affine_matvec.rows_launches
    if rows_checked <= 0:
        fail("phase 24 launched the rows-per-block kernel no time")
    print(f"[24 rows-per-block] ok: max rel err vs plain f32 {worst[f32]:.3e} (tol 2e-5), f64 "
          f"{worst[f64]:.3e} (tol 1e-12), and bitwise equal to the one-row kernel, over grids "
          f"{STENCIL_GRIDS} x B in {STENCIL_BATCHES} x rows_per_block in {ROWS_PER_BLOCK} "
          f"({rows_checked} launches)", flush=True)
    op = ops[STENCIL_MAIN[0], STENCIL_MAIN[0] // 2]
    c64, u64 = main_case
    out["rows_ms"], out["stencil_bound"] = {}, {}
    for dtype in (f32, f64):
        u, c = u64.to(dtype), c64.to(dtype)
        if dtype == f32:
            out["stencil_bound"] = stencil_least_time(op.planes[dtype], c, u)
        times = {rpp: time_ms(lambda rpp=rpp: op.affine(c, u, rows_per_block=rpp))
                 for rpp in (1, 3, 8, 1)}  # one-row timed first and last
        p_ms = time_ms(lambda: stencil_affine_reference(op.W[dtype], c, u), warmup=5, reps=50)
        out["rows_ms"][dtype] = (times, p_ms)
        print(f"[24 times] stencil matvec (B=256, 160x80) {dtype}: rows_per_block 3 "
              f"{times[3]:.4f} ms, 8 {times[8]:.4f} ms, one-row {times[1]:.4f} ms, plain "
              f"{p_ms:.4f} ms; bound {out['stencil_bound'][0]:.4f} ms "
              f"({out['stencil_bound'][1]}, f32), on {card}", flush=True)
    stencil_affine_matvec.launches, stencil_affine_matvec.rows_launches = saved

    # 25. the banded tensor-core kernel against its plain version and the
    #     float64 stencil, both modes
    saved = stencil_affine_matvec_mxu.launches
    worst = {}
    for (nx, ny), W in tables.items():
        NY, NX = ny + 1, nx + 1
        m_all = {"f32": pack_w_bands(W, "f32").to(dev),
                 "bf16x3": tuple(m.to(dev) for m in pack_w_bands(W, "bf16x3"))}
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + nx + 25)
            u64 = torch.as_tensor(rng.normal(size=(B, 2 * NY * NX)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            q64 = stencil_affine_reference(ops[nx, ny].W[f64], c64, u64)
            u, c = u64.to(f32), c64.to(f32)
            for mode in MODES:
                q = stencil_affine_matvec_mxu(m_all[mode], c, u, NY, NX, mode)
                qp = stencil_affine_mxu_reference(m_all[mode], c, u, NY, NX, mode)
                torch.cuda.synchronize()
                errs = (rel_err(q, qp), rel_err(q.to(f64), q64))
                if not (errs[0] <= MXU_TOL_PLAIN and errs[1] <= MXU_TOL_EXACT[mode]):
                    fail(f"banded kernel {mode} at {nx}x{ny} B={B}: rel err (of max|q|) vs plain "
                         f"{errs[0]}, vs f64 {errs[1]}; bounds {MXU_TOL_PLAIN}, "
                         f"{MXU_TOL_EXACT[mode]}")
                w = worst.setdefault(mode, [0.0, 0.0])
                w[0], w[1] = max(w[0], errs[0]), max(w[1], errs[1])
                if (nx, B) == STENCIL_MAIN:
                    out.setdefault("mxu_abs_err", {})[mode] = float((q - qp).abs().max())
        if (nx, ny) == (STENCIL_MAIN[0], STENCIL_MAIN[0] // 2):
            main_tables = m_all
        del m_all
    if stencil_affine_matvec_mxu.launches - saved <= 0:
        fail("phase 25 launched the banded kernel no time")
    print(f"[25 banded] ok: rel err (of max|q|) vs plain / vs f64 stencil: f32 (3xTF32) "
          f"{worst['f32'][0]:.3e} / {worst['f32'][1]:.3e}, bf16x3 {worst['bf16x3'][0]:.3e} / "
          f"{worst['bf16x3'][1]:.3e} (tol {MXU_TOL_PLAIN:g} / {MXU_TOL_EXACT}) over grids "
          f"{STENCIL_GRIDS} (T = 1, 1, 3) x B in {STENCIL_BATCHES}", flush=True)
    c64, u64 = main_case
    u, c = u64.to(f32), c64.to(f32)
    NY, NX = STENCIL_MAIN[0] // 2 + 1, STENCIL_MAIN[0] + 1
    dense_flops = 3 * 2.0 * u.shape[0] * KDIM * 256 * NY * n_tiles(NX)
    out["mxu_ms"] = {}
    for mode, unit in (("bf16x3", "bf16_tc"), ("f32", "tf32_tc")):
        mb = main_tables[mode]
        k_ms = time_ms(lambda: stencil_affine_matvec_mxu(mb, c, u, NY, NX, mode), reps=100)
        p_ms = time_ms(lambda: stencil_affine_mxu_reference(mb, c, u, NY, NX, mode), warmup=3,
                       reps=20)
        tbytes = sum(t.numel() * t.element_size() for t in (mb if mode == "bf16x3" else (mb,)))
        own = least_time(tbytes + 2 * u.numel() * 4 + c.numel() * 4, dense_flops, unit=unit)
        out["mxu_ms"][mode] = (k_ms, p_ms, own)
        print(f"[25 times] banded stencil (B=256, 160x80) {mode}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms; densified bound {own[0]:.4f} ms ({own[1]}: {tbytes / 1e6:.1f} MB "
              f"of tables, {dense_flops / 1e9:.2f} GFLOP on {unit}), the function's bound "
              f"{out['stencil_bound'][0]:.4f} ms, on {card}", flush=True)
    del main_tables
    stencil_affine_matvec_mxu.launches = saved

    # 26. the FMA-ceiling probe against its plain version, inputs in
    #     (-0.9, 0.9) so that the chain stays bounded; the kernel contracts
    #     each step to one FMA, the plain version rounds twice
    saved = fma_peak_probe.launches
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
    if fma_peak_probe.launches - saved <= 0:
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
    fma_peak_probe.launches = saved

    # 27. the main path: examples/stencil_kernel_study_torch.py at 160x80,
    #     B = 256, into a temporary results directory
    spec = importlib.util.spec_from_file_location(
        "stencil_kernel_study_torch", os.path.join(ROOT, "examples", "stencil_kernel_study_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    counters = (stencil_affine_matvec, "launches"), (stencil_affine_matvec, "rows_launches"), \
        (stencil_affine_matvec_mxu, "launches"), (fma_peak_probe, "launches")
    saved = [getattr(f, k) for f, k in counters]
    for f, k in counters:
        setattr(f, k, 0)
    with tempfile.TemporaryDirectory() as tmp:
        summary = example.main(["--device", "cuda", "--results", tmp, "--reps", "20"])
        torch.cuda.synchronize()
        with open(os.path.join(tmp, "summary.json")) as fh:
            if json.load(fh)["verdict"] != json.loads(json.dumps(summary["verdict"])):
                fail("the study's summary.json does not hold its verdict")
    (out["onerow_launches"], out["rows_launches"], out["mxu_launches"],
     out["probe_launches"]) = (getattr(f, k) for f, k in counters)
    for (f, k), v in zip(counters, saved):
        setattr(f, k, v)
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
    from vbicm_tpu_torch.ops.spectral_kernel import (
        spectral_apply_batched,
        spectral_apply_reference,
    )
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import (
        stencil3d_affine_matvec,
        stencil3d_affine_reference,
    )
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver_box3d
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    sec = SectionCard(stype=4)
    out = {}

    # 13. the 3-D stencil kernel against its plain version, ragged tiles
    worst, ops, cases, models = {}, {}, {}, {}
    saved = stencil3d_affine_matvec.launches
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
                q = op.affine(c, u)
                qr = stencil3d_affine_reference(W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"3-D stencil kernel vs plain at {cells} B={B} {dtype}: rel err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (cells, B) == BOX_MAIN:
                    out["stencil3d_abs_err"] = float((q - qr).abs().max())
            if B == 256:
                cases[cells] = (c64, u64)
        del W
    stencil3d_affine_matvec.launches = saved
    print(f"[13 stencil3d] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12) over grids {BOX_GRIDS} "
          f"x B in {STENCIL_BATCHES}", flush=True)

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
    spectral_apply_batched.launches = 0
    stencil3d_affine_matvec.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           d_y=3, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=512)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev,
                             y_norm=(ds.y_mean, ds.y_std), bridge_chunk=512)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out["spectral_launches"] = spectral_apply_batched.launches
    out["stencil3d_launches"] = stencil3d_affine_matvec.launches
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
    out["stencil3d_ms"], out["stencil3d_bound"] = {}, {}
    saved = stencil3d_affine_matvec.launches
    for cells in ((32, 8, 8), (64, 16, 16)):
        op = ops[cells]
        c64, u64 = cases[cells]
        for dtype in (torch.float32, torch.float64):
            u, c, W = u64.to(dtype), c64.to(dtype), op.W.to(dev, dtype)
            k_ms = time_ms(lambda: op.affine(c, u), warmup=10, reps=100)
            p_ms = time_ms(lambda: stencil3d_affine_reference(W, c, u), warmup=3, reps=20)
            K, uT = assembled_csr(models[cells], dtype), u.T.contiguous()
            lib_err = rel_err(library_affine(K, c, uT).T, op.affine(c, u))
            if not lib_err <= REL_TOL[dtype]:
                fail(f"cuSPARSE yardstick vs 3-D stencil kernel at {cells} {dtype}: rel err "
                     f"{lib_err}")
            l_ms = time_ms(lambda: library_affine(K, c, uT), warmup=3, reps=20)
            del K, uT
            out["stencil3d_ms"][cells, dtype] = (k_ms, p_ms, l_ms)
            nbytes = (2 * u.numel() + op.planes[dtype].numel() + c.numel()) * u.element_size()
            if dtype == torch.float32:
                out["stencil3d_bound"][cells] = stencil_least_time(op.planes[dtype], c, u)
            print(f"[17 times] 3-D stencil matvec (B=256, {cells[0]}x{cells[1]}x{cells[2]}) "
                  f"{dtype}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e9:.3f} TB/s of u, q and "
                  f"planes once), plain {p_ms:.4f} ms, cuSPARSE yardstick {l_ms:.4f} ms (rel "
                  f"err {lib_err:.1e}), on {card}", flush=True)
    stencil3d_affine_matvec.launches = saved
    saved = spectral_apply_batched.launches
    for dtype in (torch.float32, torch.float64):
        V, g, c, b = pencil_problem(*BOX_COARSE_SHAPE, seed=7, dtype=dtype, device=dev)
        Vt = V.T.contiguous()
        k_ms = time_ms(lambda: spectral_apply_batched(V, g, c, b, return_coords=True, Vt=Vt),
                       warmup=5, reps=50)
        p_ms = time_ms(lambda: spectral_apply_reference(V, g, c, b, return_coords=True),
                       warmup=5, reps=50)
        if dtype == torch.float32:
            out["spectral_ms"] = (k_ms, p_ms)
        print(f"[17 times] spectral apply (B, n)={BOX_COARSE_SHAPE} {dtype}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, on {card}", flush=True)
    spectral_apply_batched.launches = saved
    refine = 2
    fh, solve = fhs["bench", refine]["fh"], fhs["bench", refine]["solve"]
    f64_ms = out["stencil3d_ms"][(64, 16, 16), torch.float64][0]
    f32_ms = out["stencil3d_ms"][(64, 16, 16), torch.float32][0]
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


if __name__ == "__main__":
    main()

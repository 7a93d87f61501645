"""CG's vector updates (``ops/cg_update_kernel.py``) on the CPU: ``pcg``
with the plain version is the loop as it was, bit for bit; the loop's steps
are counted; the wrapper refuses what the CUDA kernels do not take; and the
kernels' launch plan and index arithmetic (``csrc/cg_update.cu``), replayed
on the host, cover every value once and compute the plain version's steps.
The kernels themselves run on the card in chip_smoke.py (phase 49)."""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from vbicm_tpu_torch.ops import cg_update_kernel as cgu
from vbicm_tpu_torch.ops.cg_update_kernel import (
    MAX_CLUSTER,
    PAIRS,
    THREADS,
    CgUpdateKernel,
    CgUpdatePlain,
    launch_plan,
)
from vbicm_tpu_torch.ops.solve import pcg, pcg_loop
from vbicm_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "vbicm_tpu_torch", "csrc", "cg_update.cu")


def _frozen_pcg(matvec, b, prec, *, tol=1e-12, maxiter=1000):
    """``ops.solve.pcg`` as it was before its vector work moved into
    ``ops.cg_update_kernel``: the reference the plain version is held to."""
    def _dot(a, b):
        return torch.einsum("bi,bi->b", a, b)

    rdt = b.dtype
    tiny = 1e-30 if rdt == torch.float32 else 1e-300
    scale = torch.sqrt(torch.clamp_min(_dot(b, b), tiny))
    b = b / scale[:, None]
    bnorm = torch.clamp_min(_dot(b, b), tiny)
    thresh = tol * tol * bnorm
    x = torch.zeros_like(b)
    r = b.clone()
    z = prec(r)
    p = z.clone()
    rz = _dot(r, z)
    rr = _dot(r, r)
    it = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    dead = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    for k in range(maxiter):
        active = ~(rr <= thresh) & ~dead
        if k % 8 == 0:
            if not bool(active.any()):
                break
        kp = matvec(p)
        denom = _dot(p, kp)
        bad = ~(denom > 0)
        alpha = torch.where(bad, 0.0, rz / torch.where(denom == 0, 1.0, denom))
        a = active[:, None]
        torch.where(a, x + alpha[:, None] * p, x, out=x)
        r_n = r - alpha[:, None] * kp
        z_n = prec(r_n)
        rz_n = _dot(r_n, z_n)
        dead_n = dead | (active & (bad | ~(rz_n > 0)))
        beta = torch.where(dead_n, 0.0, rz_n / torch.where(rz == 0, 1.0, rz))
        torch.where(a, z_n + beta[:, None] * p, p, out=p)
        torch.where(a, r_n, r, out=r)
        torch.where(a, z_n, z, out=z)
        rz = torch.where(active & ~dead_n, rz_n, rz)
        rr = _dot(r, r)
        it += active
        dead = torch.where(active, dead_n, dead)
    return x * scale[:, None], it, rr * scale * scale


def _batch(dtype, n=40):
    """Six lanes of K_b = Q diag(eig_b) Q^T with a Jacobi-like scaling:
    well conditioned (converges early), ill conditioned (runs longest), a
    NaN in its right-hand side, indefinite (breaks down at alpha), zero
    (converged before the first step), and a negative scaling (breaks down
    at beta)."""
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    eig = np.stack([np.geomspace(1.0, 3.0, n), np.geomspace(1.0, 1e5, n),
                    np.geomspace(1.0, 10.0, n), np.linspace(-2.0, 5.0, n),
                    np.geomspace(1.0, 10.0, n), np.geomspace(1.0, 30.0, n)])
    b = rng.normal(size=(6, n))
    b[2, 3] = np.nan
    b[4] = 0.0
    scal = rng.uniform(0.5, 2.0, size=(6, n))
    scal[5] *= -1.0
    Q, eig, b, scal = (torch.as_tensor(a, dtype=dtype) for a in (Q, eig, b, scal))
    return (lambda x: ((x @ Q) * eig) @ Q.T), b, (lambda r: scal * r)


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}[t.dtype])


@pytest.mark.parametrize("maxiter", [30, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_plain_is_the_loop_as_it_was_bitwise(dtype, maxiter):
    matvec, b, prec = _batch(dtype)
    x, it, rr = pcg(matvec, b, prec, tol=1e-6, maxiter=maxiter)
    want_x, want_it, want_rr = _frozen_pcg(matvec, b, prec, tol=1e-6, maxiter=maxiter)
    assert torch.equal(_bits(x), _bits(want_x))
    assert torch.equal(it, want_it)
    assert torch.equal(_bits(rr), _bits(want_rr))
    # every lane's state is one the test means: early, cut or long, NaN,
    # broken down at alpha, converged at once, broken down at beta
    assert int(it[4]) == 0 and bool(torch.isnan(x[2]).all())
    assert 0 < int(it[3]) < maxiter and 0 < int(it[5]) < maxiter
    assert int(it[0]) < int(it[1]) and (int(it[1]) == maxiter) == (maxiter == 30)


@pytest.mark.parametrize("maxiter", [30, 400])
def test_pcg_counts_its_plain_steps(maxiter):
    matvec, b, prec = _batch(torch.float64)
    before = trace.counters()
    _, it, _ = pcg(matvec, b, prec, tol=1e-6, maxiter=maxiter)
    after = trace.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("pcg.steps.plain", "pcg.steps.fused", "cg_update.launches")}
    assert moved == {"pcg.steps.plain": pcg_loop(it, maxiter)[0], "pcg.steps.fused": 0,
                     "cg_update.launches": 0}
    assert moved["pcg.steps.plain"] > 0


def test_plain_steps_keep_frozen_and_converged_lanes():
    """One step of CgUpdatePlain: lanes not active keep every part of their
    state; the active lanes' iteration counts move by one."""
    matvec, b, prec = _batch(torch.float64)
    B, n = b.shape
    r = torch.nan_to_num(b.clone())
    x, p = torch.zeros_like(r), prec(r)
    rz, rr = cgu.dot(r, p), cgu.dot(r, r)
    thresh = torch.where(torch.arange(B) == 1, 2 * rr, 1e-12 * rr)
    it = torch.zeros(B, dtype=torch.int64)
    dead = torch.arange(B) == 0
    u = CgUpdatePlain(x, r.clone(), p.clone(), rz, rr, thresh, it, dead)
    u.beta(prec(u.alpha(matvec(u.p))))
    frozen = dead | (rr <= thresh)  # lane 0 frozen, lane 1 converged, lane 4 zero
    assert torch.equal(frozen, torch.tensor([True, True, False, False, True, False]))
    assert torch.equal(u.it, (~frozen).long())
    assert torch.equal(u.r[frozen], r[frozen]) and torch.equal(u.p[frozen], p[frozen])
    assert torch.equal(u.x[frozen], x[frozen]) and torch.equal(u.rr[frozen], rr[frozen])
    assert not bool(u.active[frozen].any())


# ---------------------------------------------------------------------------
# the launch plan and the kernels' arithmetic, replayed


def _blocks(n, plan):
    """Each block's values as the kernels number them: for rank c, the
    (tile, pair, thread, value) grid of indices lo + 2 ((t PAIRS + j)
    THREADS + thread) + e, and whether each lies in the block's slice [lo,
    hi)."""
    for c in range(plan.cluster):
        lo = c * plan.slice
        hi = min(n, lo + plan.slice)
        tiles = -(-(hi - lo) // (2 * THREADS * PAIRS)) if hi > lo else 0
        t, j, th, e = np.meshgrid(np.arange(tiles), np.arange(PAIRS), np.arange(THREADS),
                                  np.arange(2), indexing="ij")
        idx = lo + 2 * ((t * PAIRS + j) * THREADS + th) + e
        yield idx, idx < hi


# lane lengths: the cells', the 3-D boxes', the field grid's, odd and tiny
# lanes, either side of a block's and of 16 blocks' registers, and lanes
# longer than 16 blocks hold, whose slices stream
HELD = 2 * THREADS * PAIRS  # values a block holds in registers
PLANS = [26082, 8019, 56355, 6642, 1001, 1, 3, 10, 1000, HELD, HELD + 1,
         MAX_CLUSTER * HELD, MAX_CLUSTER * HELD + 1, 70000, 300001]


@pytest.mark.parametrize("n", PLANS)
def test_launch_plan_covers_every_value_once(n):
    plan = launch_plan(n)
    assert plan.slice % 2 == 0 and plan.slice * plan.cluster >= n
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.tiles >= 1
    hits = np.zeros(n, dtype=np.int64)
    for idx, inside in _blocks(n, plan):
        np.add.at(hits, idx[inside], 1)
        # the tiles the plan counts are the kernels' own
        assert idx.shape[0] <= plan.tiles
    assert (hits == 1).all()
    # held in registers, each input read once, up to 16 blocks' worth
    assert (plan.tiles == 1) == (n <= MAX_CLUSTER * HELD)


def test_launch_plan_on_the_cells_lanes():
    """26,082 values: blocks of up to 2,048 pairs, seven a lane, held in
    registers (either dtype); the 64x16x16 box's 56,355 values fourteen a
    lane; a lane longer than 16 blocks hold streams."""
    assert launch_plan(26082) == cgu.CgPlan(7, 3726, 1)
    assert launch_plan(56355) == cgu.CgPlan(14, 4026, 1)
    assert launch_plan(200000) == cgu.CgPlan(16, 12500, 4)


@pytest.mark.parametrize("n", [0, -3, 2 ** 30 + 1, 2 ** 40])
def test_launch_plan_refuses_what_the_kernels_do_not_take(n):
    with pytest.raises(ValueError, match="n="):
        launch_plan(n)


def _replay_step(state, kp, sign, plan):
    """One loop step as the kernels compute it, block by block on the
    host (float64): the alpha step's dot from the blocks' partial sums in
    rank order, the updates on the active lanes, the r.r partials, then z =
    sign 0.5 r and the beta step. Returns the state after it."""
    x, r, p, rz, rr, thresh, it, dead = (t.numpy().copy() for t in state)
    kp = kp.numpy()
    active = ~(rr <= thresh) & ~dead
    B, n = x.shape
    blocks = list(_blocks(n, plan))
    bad = np.zeros(B, dtype=bool)
    part = np.zeros((B, plan.cluster))
    for b in np.flatnonzero(active):
        denom = sum(float((p[b, idx[m]] * kp[b, idx[m]]).sum()) for idx, m in blocks)
        bad[b] = not denom > 0
        alpha = 0.0 if bad[b] else rz[b] / (1.0 if denom == 0 else denom)
        for c, (idx, m) in enumerate(blocks):
            i = idx[m]
            x[b, i] = x[b, i] + alpha * p[b, i]
            r[b, i] = r[b, i] - alpha * kp[b, i]
            part[b, c] = (r[b, i] * r[b, i]).sum()
    z = sign.numpy()[:, None] * (0.5 * r)
    for b in np.flatnonzero(active):
        rz_n = sum(float((r[b, idx[m]] * z[b, idx[m]]).sum()) for idx, m in blocks)
        dead_n = dead[b] or bad[b] or not rz_n > 0
        beta = 0.0 if dead_n else rz_n / (1.0 if rz[b] == 0 else rz[b])
        for idx, m in blocks:
            i = idx[m]
            p[b, i] = z[b, i] + beta * p[b, i]
        rr[b] = part[b].sum()
        if not dead_n:
            rz[b] = rz_n
        it[b] += 1
        dead[b] = dead_n
    active = ~(rr <= thresh) & ~dead
    return {k: torch.as_tensor(v) for k, v in
            dict(x=x, r=r, p=p, rz=rz, rr=rr, it=it, dead=dead, active=active).items()}


def _lane_state(B, n, seed):
    """chip_smoke's states (by lane index modulo 6: active, converged,
    frozen, NaN residual, alpha breakdown with an infinity in p, beta
    breakdown), on the CPU in float64."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs, cs.cg_lane_state(B, n, torch.float64, torch.device("cpu"), seed)


@pytest.mark.parametrize("n", [10, 1001, 4099, 9000, 20000, 70000])
def test_replayed_kernels_compute_the_plain_step(n):
    """Lanes in every state; one block a lane and clusters, slices held
    and (at 70,000 values) streamed: the replay matches the plain version
    to rounding, flags and counts exactly, NaNs where it has them."""
    plan = launch_plan(n)
    cs, (state, kp, sign) = _lane_state(13, n, seed=n)
    want = cs.cg_one_step(CgUpdatePlain, state, kp, sign)
    with np.errstate(invalid="ignore"):  # 0 times an infinity, as the plain version
        got = _replay_step(state, kp, sign, plan)
    err, flags = cs.cg_state_err(got, want, before=state)
    assert flags and err <= 1e-13
    assert bool(want["dead"][4::6].all()) and bool(want["dead"][5::6].all())
    assert bool(torch.isnan(want["x"][4::6]).any(dim=1).all())  # 0 times an infinity


# ---------------------------------------------------------------------------
# the wrapper and the C interface


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _state(B=3, n=30, dtype=torch.float32, **change):
    st = {"x": _meta((B, n), dtype), "r": _meta((B, n), dtype), "p": _meta((B, n), dtype),
          "rz": _meta(B, dtype), "rr": _meta(B, dtype), "thresh": _meta(B, dtype),
          "it": _meta(B, torch.int64), "dead": _meta(B, torch.bool)}
    st.update(change)
    return st


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "CUDA device"),
    ({"x": _meta((3, 30), torch.float16)}, TypeError, "float32"),
    ({"x": _meta(30)}, ValueError, r"\(B, n\)"),
    ({"r": _meta((3, 31))}, ValueError, "r "),
    ({"p": _meta((3, 30), torch.float64)}, ValueError, "p "),
    ({"rz": _meta(4)}, ValueError, "rz "),
    ({"thresh": _meta(3, torch.float64)}, ValueError, "thresh "),
    ({"it": _meta(3, torch.int32)}, ValueError, "it "),
    ({"dead": _meta(3, torch.uint8)}, ValueError, "dead "),
    ({"r": _meta((30, 3)).T}, ValueError, "contiguous"),
], ids=["device", "half", "one-dim", "r-size", "p-dtype", "rz-size", "thresh-dtype", "it-dtype",
        "dead-dtype", "noncontiguous"])
def test_wrapper_refuses_what_the_kernels_do_not_take(change, error, match):
    before = trace.counters().get("cg_update.launches", 0)
    with pytest.raises(error, match=match):
        CgUpdateKernel(**_state(**change))
    assert trace.counters().get("cg_update.launches", 0) == before


def test_kernel_names_fall_in_no_benchmark_family():
    """The benchmark sorts device time by substrings of kernel names
    (portbench/harness/trace.py); the CG update kernels match none of them,
    so ``cublas_ms.*`` and ``elementwise_ms.*`` read what is left of their
    families. The profile tool names them in a family of their own."""
    from portbench.harness.trace import FAMILIES, family

    with open(SOURCE) as f:
        names = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", f.read()))
    assert names == {"cg_alpha_step_kernel", "cg_beta_step_kernel"}
    spec = importlib.util.spec_from_file_location(
        "profile_scaled_torch", os.path.join(ROOT, "tools", "profile_scaled_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in names:
        for t in ("float", "double"):
            # as the profiler shows it: demangled, with the instance's arguments
            shown = f"void (anonymous namespace)::{name}<{t}>((anonymous namespace)::CgArgs<{t}>)"
            assert family(shown) == "other"
            assert not any(k in shown for _, keys in FAMILIES for k in keys)
            assert tool.family(shown) == "CG update kernel"


def test_host_struct_and_entry_points_match_the_source():
    """The ctypes mirror of ``CgHost`` has the C struct's fields in order
    and type, and every C entry point has its argument types in _build."""
    from vbicm_tpu_torch import _build

    with open(SOURCE) as f:
        src = f.read()
    body = re.search(r"struct CgHost \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "int" if decl.startswith("int ") else "ptr"
        names = decl.replace("const ", "").split(None, 1)[1]
        fields += [(nm.strip().lstrip("*"), kind) for nm in names.split(",")]
    mirror = [(nm, "int" if t is cgu.ctypes.c_int else "ptr") for nm, t in cgu._CgHost._fields_]
    assert mirror == fields
    entries = dict(re.findall(r'extern "C" int (vbicm_cg_\w+)\(([^)]*)\)', src))
    assert set(entries) == {f"vbicm_cg_{k}_f{b}" for k in ("alpha_step", "beta_step", "fit")
                            for b in (32, 64)}
    for name, args in entries.items():
        assert len(_build._SIGNATURES[name]) == len(args.split(","))

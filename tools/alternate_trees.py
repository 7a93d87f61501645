"""Time the 64x16x16 box observation operator of two trees of the package in
alternation on one GPU, and the host cost of each tree's 3-D stencil
wrapper.

One worker process per tree (``--root A --root B``) builds the 64x16x16
two-level observation operator as chip_smoke.py phase 17 times it (the
golden's "bench" mesh, float32 CG at tol 3e-3 + two float64 refinements) at
``--batch`` solves. The main process then asks the workers in turn, A B B A
A B ..., ``--pairs`` times each, for one timing: the host wall time of
``--reps`` batches, the card synchronised around them. Each worker also
times, once, the host side of one ``stencil3d_affine_matvec`` call at the
batch's shape (float32): the whole wrapper (``StencilOperator3d.affine``),
its C entry point alone (the launch, ``cudaFuncSetAttribute`` included) and,
where the tree has one, the launch-plan lookup; 200 calls a sample, fewer
than the launch queue holds, so that the host never waits for the card.
Prints the card's name and power limit, one JSON line per timing, and one
JSON line per tree with the median, minimum and maximum solves/s, the
stencil launches and CG iterations a batch, and the host costs.

    python tools/alternate_trees.py --root build/parent --root . --pairs 10 --batch 64
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args):
    sys.path.insert(0, os.path.abspath(args.root))
    import dataclasses

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops import stencil3d_kernel
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver_box3d

    dev = torch.device("cuda", 0)
    with open(os.path.join(args.root, "tests", "fixtures", "scaled_3d_golden.json")) as f:
        gold = json.load(f)["bench"]
    g = gold["mesh"]
    nx, ny, nz, r = g["nx"], g["ny"], g["nz"], g["ratio"]
    mesh_kw = {"lx": g["lx"], "tip_force": tuple(g["tip_force"])}
    sec = SectionCard(stype=4)
    model = build_fem_model(beam_hex8_mesh(nx, ny, nz, **mesh_kw), sec, device=dev, dense=False)
    cells_c = (nx // r, ny // r, nz // r)
    coarse = build_fem_model(beam_hex8_mesh(*cells_c, **mesh_kw), sec, device=dev, dense=True)
    probe = gold["probe"]
    cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=probe["node_id"],
                              ele_id=probe["ele_id"], nipt_id=tuple(probe["nipt_id"]))
    solve = make_two_level_solver_box3d(model, coarse, cells_c, r, cg_dtype=torch.float32,
                                        refine_iters=2, tol=3e-3, maxiter=1500)
    fh = make_fh_fun(model, cfg, solve_free=solve)
    th = torch.randn((args.batch, 2), generator=torch.Generator().manual_seed(5),
                     dtype=torch.float64).to(dev)
    from vbicm_tpu_torch.utils import trace

    def launched():
        # trees before launches were utils.trace counters kept an attribute
        old = getattr(stencil3d_kernel.stencil3d_affine_matvec, "launches", None)
        return trace.counters().get("stencil3d_affine.launches", 0) if old is None else old

    with torch.no_grad():
        fh(th)
        torch.cuda.synchronize()
        before = launched()
        fh(th)
        torch.cuda.synchronize()
    per_batch = launched() - before
    its = torch.stack(solve.solver.last_cg_iters).double()
    print(json.dumps({"ready": True, "package": os.path.abspath(args.root)}), flush=True)

    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "run":
            with torch.no_grad():
                torch.cuda.synchronize()
                tic = time.perf_counter()
                for _ in range(args.reps):
                    fh(th)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - tic) / args.reps
            print(json.dumps({"ms": dt * 1e3, "solves_s": args.batch / dt}), flush=True)
        elif cmd == "host":
            print(json.dumps(host_costs(torch, stencil3d_kernel, StencilOperator3d(
                model, nx, ny, nz), args.batch, dev, per_batch, its)), flush=True)
        else:
            return


def host_costs(torch, kmod, op, B, dev, per_batch, its):
    """µs of host time a call: the wrapper, its C entry point, its plan."""
    from vbicm_tpu_torch import _build

    c = torch.rand((B, 2), dtype=torch.float32, device=dev) + 1.0
    u = torch.randn((B, op.W.shape[1] * op.W.shape[2] * op.W.shape[3] * 3),
                    dtype=torch.float32, device=dev)
    lib = _build.load_library()[0]
    name = "vbicm_stencil3d_affine_f32"
    real = getattr(lib, name)
    seen = []

    def record(*a):
        seen.append(a)
        return real(*a)

    # _build resolves an entry point once: empty its cache (where the tree has
    # one) around the capture, so that the recorder is the one called
    cache = getattr(_build, "_ENTRIES", {})
    cache.clear()
    setattr(lib, name, record)
    try:
        op.affine(c, u)
    finally:
        setattr(lib, name, real)
        cache.clear()
    args = seen[0]
    timed = {"wrapper_us": lambda: op.affine(c, u), "c_entry_us": lambda: real(*args)}
    plan = getattr(kmod, "launch_plan_3d", None)
    if plan is not None:
        NZ, NY, NX = op.W.shape[1:4]
        timed["plan_us"] = lambda: plan(B, NZ, NY, 3 * NX, torch.float32, dev)
    out = {"stencil3d_launches_a_batch": per_batch,
           "cg_iters_mean": its.mean(1).tolist(), "cg_iters_max": its.max(1).values.tolist()}
    for key, fn in timed.items():
        best = float("inf")
        for _ in range(7):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(200):
                fn()
            best = min(best, (time.perf_counter() - tic) / 200)
        torch.cuda.synchronize()
        out[key] = best * 1e6
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", help="a checkout whose package to time (twice)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3, help="batches a timing")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        args.root = args.root[0]
        return worker(args)
    if not args.root or len(args.root) != 2:
        raise SystemExit("give two trees: --root A --root B")
    sys.path.insert(0, ROOT)
    import torch

    from vbicm_tpu_torch.utils.timing import card_line

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    print(card_line(), flush=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", "--root",
                               root, "--batch", str(args.batch), "--reps", str(args.reps)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for root in args.root]
    try:
        for p, root in zip(procs, args.root):
            ready = p.stdout.readline()
            if not ready:
                raise SystemExit(f"the worker for {root} ended before it was ready")
            print(ready.strip(), flush=True)

        def ask(i, cmd):
            procs[i].stdin.write(cmd + "\n")
            procs[i].stdin.flush()
            line = procs[i].stdout.readline()
            if not line:
                raise SystemExit(f"the worker for {args.root[i]} ended")
            return json.loads(line)

        runs = [[], []]
        for k in range(2 * args.pairs):
            i = (k + k // 2) % 2  # A B B A A B B A ...
            res = ask(i, "run")
            runs[i].append(res["solves_s"])
            print(json.dumps({"tree": args.root[i], "timing": k, **res}), flush=True)
        for i, root in enumerate(args.root):
            host = ask(i, "host")
            print(json.dumps({
                "tree": root, "batch": args.batch, "reps": args.reps,
                "solves_s_median": statistics.median(runs[i]), "solves_s_min": min(runs[i]),
                "solves_s_max": max(runs[i]), "solves_s": runs[i], **host}), flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()
                p.wait(timeout=60)


if __name__ == "__main__":
    main()

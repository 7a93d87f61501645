"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload cooks160x80.train --seed 7 --seconds 30 --trace 0

From the root of a checkout. Set-up builds the port's objects from the
cell's configuration, makes the inputs from --seed and warms the cell's
shapes; the window then runs the cell's traffic for --seconds; the port's
output is then held to the plain reference. With --trace 0 the last line of
standard output carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics (a bounded stretch at the window's start profiled). The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result line.

Exits with an error and prints no result when there is no CUDA device (or
fewer than the cell asks for), when the port's package is not in the
checkout, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import env, manifest  # noqa: E402


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(cell, rec, trace: bool, device_kind: str) -> dict:
    from portbench.harness.runners import verdict

    correct, checks = verdict(rec, cell.limits)
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed}
    if trace:
        metrics = manifest.read_metrics(cell, rec.ctx) if rec.ctx is not None else {}
        device.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["metrics"] = metrics
        out["device"] = device
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.labelled.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(rec.e2e, setup_s=rec.setup_s)
        out["metrics"] = {k: {"value": float(values[k]), "unit": u} for k, u in units.items()}
        out["device"] = device
    out["notes"] = rec.notes
    out["checks"] = checks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.set_environment()
    try:
        cell = manifest.load_cell(args.workload)
    except (KeyError, OSError) as ex:
        fail(f"cannot load the cell: {ex}")
    if not env.program_present():
        fail(f"the port's package {env.PROGRAM} is not in the checkout at {ROOT}")

    import torch

    missing = env.chips_missing(cell.chips)
    if missing:
        fail(f"no run without the card: {missing}", 3)
    from portbench.count.peaks import peaks_for
    from portbench.harness import runners

    kind = torch.cuda.get_device_name(0)
    try:
        peaks = peaks_for(kind)
    except KeyError as ex:
        fail(str(ex))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = runners.RUNNERS[cell.traffic["kind"]](cell, args.seed, args.seconds, bool(args.trace),
                                                device, T_START, peaks=peaks)
    from vbicm_tpu_torch import _build

    rec.notes.update(compile_s=_build.load_library()[1], card=env.card_power_limit(),
                     seed=args.seed)
    bad = env.forbidden_loaded()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}")
    line = result_line(cell, rec, bool(args.trace), kind)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

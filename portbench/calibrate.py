"""Read the numbers that decide a cell's ``correct`` over many seeds in one
process, for the port as configured (the lower readings), for its control
and for planted faults (the upper readings), on the card at the cell's own
size. The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload cooks160x80.train --seeds 12 --control-seeds 3 \\
        --faults half_batch,altered --seconds 16

The control is the cell's ``control`` in ``workloads/<cell>.json``: groups
of the configuration to override, the port's own lower-precision path.
Prints one JSON line a run, and the largest sound reading and the smallest
control and fault readings of each number at the end.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=16.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 11)
    args = ap.parse_args()

    env.set_environment()
    cell = manifest.load_cell(args.workload)
    import torch

    from portbench import faults
    from portbench.harness import runners

    with open(os.path.join(manifest.BENCH_DIR, "workloads", args.workload + ".json")) as f:
        control = json.load(f)["control"]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    run_cell = runners.RUNNERS[cell.traffic["kind"]]
    plan = [("sound", args.first_seed + k, None) for k in range(args.seeds)]
    plan += [("control", args.first_seed + 1000 + k, None) for k in range(args.control_seeds)]
    for fault in filter(None, args.faults.split(",")):
        plan += [(fault, args.first_seed + 2000 + k, fault) for k in range(args.control_seeds)]
    readings = {}
    for what, seed, fault in plan:
        t0 = time.perf_counter()
        overrides = control if what == "control" else None
        if fault:
            with faults.plant(cell.traffic["kind"], fault):
                rec = run_cell(cell, seed, args.seconds, False, device, t0, overrides=overrides)
        else:
            rec = run_cell(cell, seed, args.seconds, False, device, t0, overrides=overrides)
        readings.setdefault(what, []).append(rec.checks)
        print(json.dumps({"run": what, "seed": seed, "checks": rec.checks, "e2e": rec.e2e,
                          "failed": rec.failed, "seconds": time.perf_counter() - t0}),
              flush=True)
    summary = {}
    for name in readings["sound"][0]:
        summary[name] = {"sound_max": max(r[name] for r in readings["sound"])}
        for what, recs in readings.items():
            if what != "sound":
                summary[name][what + "_min"] = min(r[name] for r in recs)
    print(json.dumps({"summary": summary, "card": env.card_power_limit()
                      if device.type == "cuda" else "cpu"}), flush=True)
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()

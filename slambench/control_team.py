#!/usr/bin/env python3
"""The readings that set the team cell's limits: the program's and its
controls'.

    python3 slambench/control_team.py --workload forest_team3.demo \
        --seeds 1,2 --seconds 51

For each seed, in one process on the card: the cell's set-up and window
as a benchmark run makes them; every compared number of the program's
outputs (judges/team.py readings, with each robot's solve and its skipped
form: `_robot<r>_in_excess` is what that full solve would read had it
returned its input); then the control's, the plain reference put in the
program's place (judges/team.py control_side): its decisions with
positions in bf16 (team_decisions' control), its associations and its
solves' optima in TF32. Prints one JSON line per seed. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from slambench import run
    from slambench.drivers import team
    from slambench.judges import team as J
    from slambench.reference import precision
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    _, conf = run.cell_of(manifest, args.workload)
    cfg = run.load_json(ROOT, conf["file"])
    work = run.load_json(ROOT, "slambench", "workloads",
                         f"{args.workload}.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        drv = team.Driver(cfg, work, seed, DEVICE, False)
        drv.setup()
        try:
            n, _ = drv.window(args.seconds)
        finally:
            drv.close()
        prog = J.program_side(drv.rec)
        out = {"seed": seed, "keyframes": n,
               "program": J.readings(cfg, work, drv.traffic, prog, DEVICE)}
        side = J.control_side(cfg, work, drv.traffic, prog, precision.tf32,
                              precision.bf16)
        out["control"] = J.readings(cfg, work, drv.traffic, side, DEVICE)
        print(json.dumps(out, default=float), flush=True)
        del drv, prog, side
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

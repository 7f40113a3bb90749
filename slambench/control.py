#!/usr/bin/env python3
"""The readings that set a cell's limits: the program's, its control's,
and a skipped full solve's.

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process on the card: the cell's set-up and a window
of `--seconds` (long enough to hold the sampled keyframes and the first
mission's last full solve); every compared number of the program's
outputs and of the control's, the plain reference put in the program's
place at TF32 (slambench/judge.py control_side); then the same set-up and
window again with the program's full solve returning its input unchanged,
and its numbers. Prints one JSON line per seed. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"


def _window(cfg, work, seed, seconds):
    from slambench import judge
    from slambench.drivers import solo
    drv = solo.Driver(cfg, work, seed, DEVICE, False)
    drv.setup()
    try:
        n, _ = drv.window(seconds)
    finally:
        drv.close()
    return drv, n, judge.program_side(drv.rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from slambench import judge, run
    from slambench.reference import precision
    from slide_slam_tpu_torch.runtime import engine
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    _, conf = run.cell_of(manifest, args.workload)
    cfg = run.load_json(ROOT, conf["file"])
    work = run.load_json(ROOT, "slambench", "workloads",
                         f"{args.workload}.json")
    solve_full = engine.solve_full
    for seed in (int(s) for s in args.seeds.split(",")):
        drv, n, prog = _window(cfg, work, seed, args.seconds)
        out = {"seed": seed, "keyframes": n,
               "program": judge.readings(cfg, work, drv.traffic, prog,
                                         DEVICE)}
        side = judge.control_side(cfg, work, drv.traffic, prog,
                                  precision.tf32, DEVICE)
        out["tf32"] = judge.readings(cfg, work, drv.traffic, side, DEVICE)
        del drv, prog, side
        torch.cuda.empty_cache()
        engine.solve_full = lambda cfg_, state: state
        try:
            drv, n, prog = _window(cfg, work, seed, args.seconds)
        finally:
            engine.solve_full = solve_full
        out["solve_skipped"] = judge.readings(cfg, work, drv.traffic, prog,
                                              DEVICE)
        out["solve_skipped"]["keyframes"] = n
        print(json.dumps(out), flush=True)
        del drv, prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

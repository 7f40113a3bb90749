"""Run-to-run spread of the small multi-robot mission on the card.

chip_smoke.py's phase card_vs_cpu:mission runs the 2-robot x 50-keyframe
sync mission (chip_smoke.small_mission, the mission of
tests/test_torch_mission.py) once on the card and once on the CPU and holds
the poses to a tolerance. The card's atomic scatter sums add in a different
order on every run, so this script measures how far card runs land from
the CPU run and from each other: `--runs` plain card runs, then
`--deterministic` runs with torch.use_deterministic_algorithms(True), then
one CPU run. Prints one JSON line per run (per-robot stamp-matched ATE, the
largest position gap to the CPU run and to the first card run of the same
mode, on each node's own chain and on its replayed peer chain) and the
card's name and power limit. Needs one card.

    python scripts/mission_card_spread.py [--runs 4] [--deterministic 2]
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

# cuBLAS needs a fixed workspace to be deterministic; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from slide_slam_tpu_torch import config  # noqa: E402
from slide_slam_tpu_torch.io import synthetic  # noqa: E402
from slide_slam_tpu_torch.runtime.mission import \
    MultiRobotMission  # noqa: E402


def run(device):
    cfg, trajs, logs, rel = chip_smoke.small_mission(config, synthetic)
    t0 = time.perf_counter()
    nodes = MultiRobotMission(cfg, logs, relative_meas=rel,
                              async_runtime=False, use_input_manager=True,
                              device=device).run(intra_lc=True).nodes
    wall = time.perf_counter() - t0
    chains = [[n.trajectory_of(r) for r in range(len(nodes))] for n in nodes]
    ates = [synthetic.stamp_matched_ate(n.optimized_trajectory(),
                                        n.key_stamps, log, traj)
            for n, log, traj in zip(nodes, logs, trajs)]
    return dict(chains=chains, ate_m=ates, wall_s=wall,
                merged=sorted([n.robot_id, int(p)] for n in nodes
                              for p in n.dbm.loop_closure_tf),
                landmarks=[n.landmark_counts() for n in nodes])


def gaps(a, b):
    """Largest position gap on own chains and on replayed peer chains."""
    out = {"own": 0.0, "peer": 0.0}
    for me, (ca, cb) in enumerate(zip(a["chains"], b["chains"])):
        for rid, (x, y) in enumerate(zip(ca, cb)):
            kind = "own" if rid == me else "peer"
            out[kind] = max(out[kind],
                            float(np.abs(x[:, 4:7] - y[:, 4:7]).max()))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--deterministic", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = []
    for i in range(args.runs + args.deterministic):
        det = i >= args.runs
        torch.use_deterministic_algorithms(det, warn_only=True)
        card.append((det, run("cuda")))
    torch.use_deterministic_algorithms(False)
    cpu = run("cpu")
    first = {}
    for det, r in card:
        first.setdefault(det, r)
        print(json.dumps(dict(
            deterministic=det, wall_s=r["wall_s"], ate_m=r["ate_m"],
            merged_same=r["merged"] == cpu["merged"],
            landmarks_same=r["landmarks"] == cpu["landmarks"],
            gap_to_cpu_m=gaps(r, cpu),
            gap_to_first_card_run_m=gaps(r, first[det]))))
    print(json.dumps(dict(device="cpu", wall_s=cpu["wall_s"],
                          ate_m=cpu["ate_m"])))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

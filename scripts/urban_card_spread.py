"""Card against CPU on the urban raw-LiDAR mission, keyframe by keyframe.

chip_smoke.py's card_vs_cpu:urban holds the card to the CPU over the urban
mission's first keyframes. This script follows the two further: it runs
the first `--keyframes` keyframes (chip_smoke.run_mission: the simulator
labeller, the outdoor classes with the car branch, the urban capacity)
`--runs` times on the card, `--deterministic` more times with
torch.use_deterministic_algorithms(True), and once on the CPU. For each card
run it prints one JSON line: the first keyframe whose cylinder or cuboid
matches or measurement counts differ from the CPU run's and from the first
card run's, the largest pose gap to each before that keyframe and at the
keyframes in GAPS_AT, and the landmarks, ATE and median root error at the
keyframe counts in SNAPSHOTS (the first periodic full solve comes at
keyframe 32). Then the CPU run's line and the card's name and power
limit.

    python scripts/urban_card_spread.py [--keyframes 50] [--runs 2]
        [--deterministic 1]

`--devices cpu` runs the CPU alone (no card needed) and prints its line.
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
from slide_slam_tpu_torch.io import synthetic  # noqa: E402

SNAPSHOTS = (8, 25, 31, 32, 50)
GAPS_AT = (7, 24, 30, 31, 32, 40, 49)     # 0-based keyframe indices


def run(mission, device, n):
    per_kf, snap = [], {}

    def record(i, node, frontend, obs, fe_s, be_s):
        per_kf.append(dict(
            cyl=node.last_step.cyl_matches.cpu().numpy(),
            cub=node.last_step.cub_matches.cpu().numpy(),
            n_meas=len(obs.get("cyl_root", [])),
            n_cub=len(obs.get("cub_pose", [])),
            pose=node.last_step.pose.cpu().numpy()))
        if i + 1 in SNAPSHOTS:
            est = node.optimized_trajectory()
            snap[i + 1] = dict(
                landmarks=node.landmark_counts(),
                ate_optimized_m=synthetic.ate_rmse(
                    est, mission.traj[:len(est)], align=False),
                median_root_error_m=float(np.median(
                    chip_smoke.root_errors(node, mission.world))))

    t0 = time.perf_counter()
    chip_smoke.run_mission(mission, device, n, record, urban=True)
    return dict(per_kf=per_kf, snapshots=snap,
                wall_s=time.perf_counter() - t0)


def compare(a, b):
    """First keyframe (0-based) where a decision or count differs, the
    largest pose gap before it, and the pose gap at each of GAPS_AT."""
    first, what = None, None
    for i, (x, y) in enumerate(zip(a["per_kf"], b["per_kf"])):
        diff = [k for k in ("n_meas", "n_cub") if x[k] != y[k]]
        diff += [k for k in ("cyl", "cub") if not np.array_equal(x[k], y[k])]
        if diff:
            first, what = i, diff
            break
    gap = [float(np.abs(x["pose"] - y["pose"]).max())
           for x, y in zip(a["per_kf"], b["per_kf"])]
    upto = len(gap) if first is None else first
    return dict(first_differing_keyframe=first, differs_in=what,
                max_pose_gap_before=max(gap[:upto]) if upto else None,
                pose_gap_at={k: gap[k] for k in GAPS_AT if k < len(gap)})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--keyframes", type=int, default=50)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--devices", default="cuda,cpu",
                   help="'cuda,cpu' (the card's runs and one CPU run) or "
                   "'cpu' (the CPU run alone)")
    args = p.parse_args()
    card_runs = args.devices.split(",")[0] == "cuda"
    if card_runs and not torch.cuda.is_available():
        print("FAIL: needs a CUDA card (or --devices cpu)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mission = synthetic.make_lidar_mission(n_cars=chip_smoke.URBAN_CARS)
    card = []
    if card_runs:
        for i in range(args.runs + args.deterministic):
            det = i >= args.runs
            torch.use_deterministic_algorithms(det, warn_only=True)
            card.append((det, run(mission, "cuda", args.keyframes)))
        torch.use_deterministic_algorithms(False)
    cpu = run(mission, "cpu", args.keyframes)
    for det, r in card:
        print(json.dumps(dict(
            device="cuda", deterministic=det, wall_s=r["wall_s"],
            snapshots=r["snapshots"],
            vs_cpu=compare(r, cpu),
            vs_first_card_run=compare(r, card[0][1]))))
    print(json.dumps(dict(device="cpu", wall_s=cpu["wall_s"],
                          snapshots=cpu["snapshots"])))
    if card_runs:
        print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

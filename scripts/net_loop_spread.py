"""Spread of chip_smoke.py's slice:net_in_the_loop over trainings of the net.

chip_smoke.py trains the full-width RangeSegmentator on the card on 16
simulator-labelled scans of the urban loop and gates the map that the
trained net makes over the loop's first keyframes. Training on the card
is not bit-reproducible by default (cuDNN picks and reorders its
convolution algorithms), so the gate reads a different net on every run.
This script trains the net `--repeats` times for each step count in
`--steps`, in each mode of `--modes` ("plain": cuDNN autotuned;
"deterministic": cuDNN's deterministic algorithms, and
torch.use_deterministic_algorithms(True) while training), drives the
first 50 urban keyframes with each net as the segmenter and prints one
JSON line per training: seconds, final loss, a checksum of the weights,
IoU on the training scans and on the loop's other scans, and at keyframes
25 and 50 the landmarks, the ATE and the map's median root error. Then
the card's name and power limit. Needs one card.

    python scripts/net_loop_spread.py [--steps 200,400] [--repeats 2]
        [--modes plain,deterministic]
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
from slide_slam_tpu_torch.frontend import segmentation as seg  # noqa: E402
from slide_slam_tpu_torch.frontend import \
    train_segmentation as ts  # noqa: E402
from slide_slam_tpu_torch.io import synthetic  # noqa: E402

SNAPSHOTS = (25, 50)


def loop(urban, model, n=chip_smoke.NET_LOOP_KEYFRAMES):
    snap = {}

    def record(i, node, frontend, obs, fe_s, be_s):
        if i + 1 in SNAPSHOTS:
            est = node.optimized_trajectory()
            snap[i + 1] = dict(
                landmarks=node.landmark_counts(),
                ate_optimized_m=synthetic.ate_rmse(
                    est, urban.traj[:len(est)], align=False),
                median_root_error_m=float(np.median(
                    chip_smoke.root_errors(node, urban.world))))

    chip_smoke.run_mission(urban, "cuda", n, record, urban=True,
                           segment_fn=lambda x: seg.segment(model, x))
    return snap


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", default="200,400")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--modes", default="plain,deterministic")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    urban = synthetic.make_lidar_mission(n_cars=chip_smoke.URBAN_CARS)
    train = chip_smoke.training_set(urban, chip_smoke.NET_TRAIN_SCANS)
    held = chip_smoke.training_set(
        urban, [k for k in range(chip_smoke.NET_LOOP_KEYFRAMES)
                if k not in chip_smoke.NET_TRAIN_SCANS])
    for mode in args.modes.split(","):
        det = mode == "deterministic"
        for steps in (int(s) for s in args.steps.split(",")):
            for rep in range(args.repeats):
                torch.use_deterministic_algorithms(det, warn_only=True)
                torch.backends.cudnn.deterministic = det
                torch.backends.cudnn.benchmark = not det
                model = seg.RangeSegmentator(
                    num_classes=chip_smoke.NET_CLASSES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, metrics = ts.train_segmentator(
                    model, *train, steps=steps, lr=chip_smoke.NET_TRAIN_LR,
                    batch=2, seed=0, device="cuda")
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                torch.use_deterministic_algorithms(False)
                checksum = float(sum(w.detach().double().abs().sum()
                                     for w in model.parameters()))
                iou = [ts.mean_iou(chip_smoke.predict(model, d[0]), d[1],
                                   d[2], chip_smoke.NET_CLASSES)
                       for d in (train, held)]
                print(json.dumps(dict(
                    mode=mode, steps=steps, repeat=rep, train_s=train_s,
                    final_loss=metrics["final_loss"],
                    weight_checksum=checksum, iou_train=iou[0],
                    iou_held_out=iou[1], at_keyframe=loop(urban, model))),
                    flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

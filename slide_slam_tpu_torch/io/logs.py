"""Measurement-log persistence (processed-bag equivalent; copy of
slide_slam_tpu/io/logs.py, numpy only).

The reference consumes rosbags of SemanticMeasSyncOdom messages; this module
defines the portable npz container for the same stream so runs are
reproducible without ROS: per-keyframe odometry pose + body-frame object
measurements (+ optional ground truth for evaluation).
"""
from __future__ import annotations

import numpy as np

from .synthetic import Keyframe, RobotLog


def save_log(path: str, log: RobotLog):
    ks = log.keyframes
    n = len(ks)
    flat = {
        "robot_id": np.int32(log.robot_id),
        "stamps": np.asarray([k.stamp for k in ks], np.float64),
        "odom_pose": np.stack([k.odom_pose for k in ks]) if n else np.zeros((0, 7)),
        "true_pose": np.stack([k.true_pose for k in ks]) if n else np.zeros((0, 7)),
    }
    # ragged per-keyframe arrays -> concatenated + offsets
    for name, dim in [("cyl_root", 3), ("cyl_ray", 3), ("cyl_radius", 0),
                      ("cyl_label", 0), ("cub_pose", 7), ("cub_scale", 3),
                      ("cub_label", 0), ("ell_pose", 7), ("ell_scale", 3),
                      ("ell_label", 0)]:
        parts = [np.asarray(getattr(k, name)) for k in ks]
        counts = np.asarray([len(p) for p in parts], np.int32)
        if parts and counts.sum() > 0:
            cat = np.concatenate(
                [p.reshape(len(p), dim) if dim else p.reshape(len(p))
                 for p in parts], axis=0)
        else:
            cat = np.zeros((0, dim) if dim else (0,), np.float32)
        flat[name] = cat
        flat[name + "__counts"] = counts
    np.savez_compressed(path, **flat)


def load_log(path: str) -> RobotLog:
    z = np.load(path)
    n = len(z["stamps"])
    log = RobotLog(robot_id=int(z["robot_id"]))
    offsets = {}
    for name in ["cyl_root", "cyl_ray", "cyl_radius", "cyl_label", "cub_pose",
                 "cub_scale", "cub_label", "ell_pose", "ell_scale", "ell_label"]:
        offsets[name] = np.concatenate([[0], np.cumsum(z[name + "__counts"])])
    for i in range(n):
        kw = {}
        for name in offsets:
            a, b = offsets[name][i], offsets[name][i + 1]
            kw[name] = z[name][a:b]
        log.keyframes.append(Keyframe(
            stamp=float(z["stamps"][i]),
            odom_pose=z["odom_pose"][i].astype(np.float32),
            true_pose=z["true_pose"][i].astype(np.float32),
            **kw))
    return log


def load_trajectory_tum(path: str) -> np.ndarray:
    """Read `stamp x y z qx qy qz qw` rows -> [N, 8]."""
    return np.loadtxt(path).reshape(-1, 8)


def save_reference_style_map(path: str, compact_map: np.ndarray):
    """Write Vector7d rows in the reference's fixture format
    (robotNMap_*.txt: `label x y z [dims...]`)."""
    np.savetxt(path, np.asarray(compact_map), fmt="%.6f")

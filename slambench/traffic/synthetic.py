"""Frozen copy of the traffic generators of
slide_slam_tpu_torch/io/synthetic.py (commit e8ab756): the forest world,
the lawnmower and loop paths, observation rendering with noise and dropout,
odometry integration (`make_log`) and ATE. Same seed, same data as the
program's copy had at that commit. The dense LiDAR scans are not made here:
see raycast.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import se3np as se3

# semantic labels follow scan2shape class ids
# (process_cloud_node_outdoor_class_info.yaml:15-34): tree=8, lightpole=9,
# car=5; indoor chair/table get small ids.
TREE, LIGHTPOLE, CAR, CHAIR, TABLE = 8, 9, 5, 1, 2


@dataclass
class World:
    cyl_root: np.ndarray   # [NC, 3]
    cyl_ray: np.ndarray    # [NC, 3]
    cyl_radius: np.ndarray
    cyl_label: np.ndarray
    cub_pose: np.ndarray   # [NK, 7]
    cub_scale: np.ndarray
    cub_label: np.ndarray
    ell_pos: np.ndarray    # [NE, 3]
    ell_scale: np.ndarray
    ell_label: np.ndarray


@dataclass
class Keyframe:
    stamp: float
    odom_pose: np.ndarray          # [7] drifting odometry pose
    true_pose: np.ndarray          # [7] ground truth
    cyl_root: np.ndarray           # body frame observations
    cyl_ray: np.ndarray
    cyl_radius: np.ndarray
    cyl_label: np.ndarray
    cub_pose: np.ndarray
    cub_scale: np.ndarray
    cub_label: np.ndarray
    ell_pose: np.ndarray
    ell_scale: np.ndarray
    ell_label: np.ndarray


@dataclass
class RobotLog:
    robot_id: int
    keyframes: List[Keyframe] = field(default_factory=list)


def make_forest_world(rng: np.random.Generator, n_trees=120, n_poles=20,
                      n_cars=15, extent=60.0) -> World:
    def uniform_xy(n):
        return rng.uniform(-extent, extent, size=(n, 2))

    nc = n_trees + n_poles
    cyl_xy = uniform_xy(nc)
    cyl_root = np.concatenate([cyl_xy, np.zeros((nc, 1))], axis=1)
    ray = rng.normal(0, 0.02, size=(nc, 3)) + np.array([0, 0, 1.0])
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    radius = np.concatenate([
        rng.uniform(0.15, 0.5, n_trees), rng.uniform(0.08, 0.15, n_poles)])
    cyl_label = np.concatenate([
        np.full(n_trees, TREE), np.full(n_poles, LIGHTPOLE)]).astype(np.int32)

    cub_xy = uniform_xy(n_cars)
    yaws = rng.uniform(-np.pi, np.pi, n_cars)
    cub_pose = np.stack([
        np.asarray(se3.from_xyz_yaw(x, y, 0.8, w))
        for (x, y), w in zip(cub_xy, yaws)]) if n_cars else np.zeros((0, 7))
    cub_scale = np.stack([
        rng.uniform(3.8, 4.8, n_cars), rng.uniform(1.6, 2.0, n_cars),
        rng.uniform(1.4, 1.7, n_cars)], axis=1)
    cub_label = np.full(n_cars, CAR, np.int32)

    n_ell = 10
    ell_pos = np.concatenate([uniform_xy(n_ell), np.full((n_ell, 1), 0.5)], axis=1)
    ell_scale = rng.uniform(0.4, 1.2, size=(n_ell, 3))
    ell_label = rng.choice([CHAIR, TABLE], n_ell).astype(np.int32)

    return World(cyl_root.astype(np.float32), ray.astype(np.float32),
                 radius.astype(np.float32), cyl_label,
                 cub_pose.astype(np.float32), cub_scale.astype(np.float32),
                 cub_label, ell_pos.astype(np.float32),
                 ell_scale.astype(np.float32), ell_label)


def lawnmower_trajectory(n_steps: int, extent=50.0, rows=4, step=1.0,
                         z=0.5) -> np.ndarray:
    """[N, 7] ground-truth key poses sweeping the area in a lawnmower path."""
    poses = []
    x, y, yaw = -extent * 0.8, -extent * 0.8, 0.0
    row_len = int(1.6 * extent / step)
    row_gap = 1.6 * extent / max(rows - 1, 1)
    k = 0
    for r in range(rows):
        for i in range(row_len):
            poses.append(np.asarray(se3.from_xyz_yaw(x, y, z, yaw)))
            x += step * np.cos(yaw)
            y += step * np.sin(yaw)
            k += 1
            if k >= n_steps:
                return np.stack(poses).astype(np.float32)
        # turn 180, shift one row
        yaw = yaw + np.pi if r % 2 == 0 else yaw - np.pi
        y += row_gap
    while len(poses) < n_steps:
        poses.append(poses[-1])
    return np.stack(poses[:n_steps]).astype(np.float32)


def loop_trajectory(n_steps: int, radius=30.0, z=0.5,
                    laps: float = 1.0) -> np.ndarray:
    """Circular loop revisiting the start — exercises loop closure.

    laps > 1 keeps driving around: from the second lap on every pose is a
    genuine revisit of a >=1-lap-older pose, so the loop-closure region
    (cylinderMapManager.cpp:114-158 semantics: within 10 m xy of a pose
    >=30 poses old) is active for a sustained stretch of the mission, like
    the reference's forest demo loops."""
    poses = []
    for i in range(n_steps):
        th = 2 * np.pi * laps * i / (n_steps - 1)
        x, y = radius * np.cos(th) - radius, radius * np.sin(th)
        yaw = th + np.pi / 2
        poses.append(np.asarray(se3.from_xyz_yaw(x, y, z, yaw)))
    return np.stack(poses).astype(np.float32)


def render_observations(world: World, pose: np.ndarray,
                        rng: np.random.Generator, max_range=25.0,
                        pos_noise=0.05, dropout=0.1):
    """Objects within max_range, expressed in the body frame + noise."""
    inv = se3.inverse(np.asarray(pose))
    out = {}

    def visible(world_xyz):
        d = np.linalg.norm(world_xyz - np.asarray(pose)[4:7], axis=1)
        vis = (d < max_range) & (rng.uniform(size=len(d)) > dropout)
        idx = np.nonzero(vis)[0]
        # NEAREST FIRST: downstream packing truncates to max_scan_objects,
        # and a sensor keeps its close detections — world-order truncation
        # kept a random scatter across the whole range disk, which in
        # dense worlds falls outside the top-K DA submap and floods the
        # map with duplicates (r5 fixture diagnosis)
        return idx[np.argsort(d[idx], kind="stable")]

    ci = visible(world.cyl_root)
    root_b = se3.apply(inv, world.cyl_root[ci])
    ray_b = se3.rotate(inv, world.cyl_ray[ci])
    out["cyl_root"] = (root_b + rng.normal(0, pos_noise, root_b.shape)).astype(np.float32)
    out["cyl_ray"] = ray_b.astype(np.float32)
    out["cyl_radius"] = (world.cyl_radius[ci]
                         + rng.normal(0, 0.01, len(ci))).astype(np.float32)
    out["cyl_label"] = world.cyl_label[ci]

    ki = visible(world.cub_pose[:, 4:7])
    pose_b = se3.compose(inv[None], world.cub_pose[ki])
    pose_b[:, 4:7] += rng.normal(0, pos_noise, (len(ki), 3))
    out["cub_pose"] = pose_b.astype(np.float32)
    out["cub_scale"] = (world.cub_scale[ki]
                        + rng.normal(0, 0.02, (len(ki), 3))).astype(np.float32)
    out["cub_label"] = world.cub_label[ki]

    ei = visible(world.ell_pos)
    identq = np.tile(np.array([1.0, 0, 0, 0], np.float32), (len(ei), 1))
    ell_world = np.concatenate([identq, world.ell_pos[ei]], axis=1)
    ell_b = se3.compose(inv[None], ell_world)
    ell_b[:, 4:7] += rng.normal(0, pos_noise, (len(ei), 3))
    out["ell_pose"] = ell_b.astype(np.float32)
    out["ell_scale"] = world.ell_scale[ei].astype(np.float32)
    out["ell_label"] = world.ell_label[ei]
    return out


def make_log(world: World, traj: np.ndarray, robot_id=0, seed=0,
             odom_drift_sigma=0.0, t0=1000.0, dt=0.5,
             max_range=25.0, pos_noise=0.05, dropout=0.1,
             yaw_drift_bias=0.0) -> RobotLog:
    """Replay ground-truth poses into a measurement log with drifting odom.

    Odometry pose = integral of true relative motions perturbed by noise and
    an optional systematic yaw-rate bias (the classic drift mode)."""
    rng = np.random.default_rng(seed + 17 * robot_id)
    log = RobotLog(robot_id=robot_id)
    odom = traj[0].copy()
    for i, pose in enumerate(traj):
        if i > 0:
            rel = se3.between(traj[i - 1], pose)
            noise = np.zeros(6, np.float32)
            if odom_drift_sigma > 0:
                noise[:3] += rng.normal(0, odom_drift_sigma * 0.3, 3)
                noise[3:] += rng.normal(0, odom_drift_sigma, 3)
            noise[2] += yaw_drift_bias
            rel_noisy = se3.retract(rel, noise)
            odom = se3.compose(odom, rel_noisy)
        obs = render_observations(world, pose, rng, max_range, pos_noise, dropout)
        log.keyframes.append(Keyframe(
            stamp=t0 + i * dt, odom_pose=odom.astype(np.float32),
            true_pose=pose, **obs))
    return log


def ate_rmse(est: np.ndarray, truth: np.ndarray, align=True) -> float:
    """Absolute trajectory error (RMSE of positions), with optional SE(3)
    Umeyama alignment (standard ATE protocol)."""
    est_t = est[:, 4:7] if est.shape[1] == 7 else est
    tru_t = truth[:, 4:7] if truth.shape[1] == 7 else truth
    if align and len(est_t) >= 3:
        mu_e, mu_t = est_t.mean(0), tru_t.mean(0)
        E, T = est_t - mu_e, tru_t - mu_t
        H = E.T @ T
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1, 1, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        est_t = (R @ E.T).T + mu_t
    return float(np.sqrt(np.mean(np.sum((est_t - tru_t) ** 2, axis=1))))


def stamp_matched_ate(est: np.ndarray, stamps, log: RobotLog,
                      truth: np.ndarray) -> float:
    """ATE of a node's own trajectory (est [N, 7], one stamp each) against
    ground truth matched BY STAMP: a mission fed through the input manager
    adds keyframes for relative-measurement events too, so est rows can
    outnumber log keyframes (the JAX package's bench.py:136)."""
    by_stamp = {round(k.stamp, 6): t[4:7]
                for k, t in zip(log.keyframes, truth)}
    pairs = [(e, by_stamp[round(s, 6)])
             for e, s in zip(est[:, 4:7], stamps) if round(s, 6) in by_stamp]
    e = np.asarray([p[0] for p in pairs])
    t = np.asarray([p[1] for p in pairs])
    return float(np.sqrt(np.mean(np.sum((e - t) ** 2, axis=1))))

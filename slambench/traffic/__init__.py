"""The one traffic generator: a workload's `traffic` parameters and the
configuration's deployment, made into a mission from the seed.

`generator` "forest_solo": the configuration's world drawn by the frozen
make_forest_world (cars and ellipsoids removed), a path of the workload's
kind, odometry integrated by the frozen make_log, and per keyframe either
dense scans ray-cast on the device (`scans`) or the log's cylinder
measurements with noise and dropout (`measurements`).

The mission (world, path, every noise draw) comes from the workload's
`mission_seed`; the run's seed places the whole of it in the map frame:
a yaw about the vertical and a shift in the plane, drawn from the seed,
applied to the world and to the true path before anything is measured.
What the robot senses in its body frame is then the same in every run up
to rounding, and so is the work: the seed changes the frame and the
keyframes the judge samples, not how long the solves take (the full
solve's iterations follow the data, and would otherwise swing several-
fold from seed to seed).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import raycast, synthetic


class Traffic:
    def __init__(self, world, traj, odom, scans=None, obs=None,
                 max_range=None):
        self.world, self.traj, self.odom = world, traj, odom
        self.scans: Optional[List[raycast.DenseScan]] = scans
        self.obs: Optional[List[dict]] = obs
        self.n_keyframes = len(traj)
        if scans is not None:
            # the largest class a scan hands the pipeline: its points
            # within the pipeline's range, the ground's included
            self.class_max = np.array([
                max([int((s.labels[np.linalg.norm(s.points, axis=1)
                                   < max_range] == lab).sum())
                     for lab in np.unique(s.labels)] or [0])
                for s in scans])
        else:
            self.class_max = np.array([len(o["cyl_radius"]) for o in obs])
        self.densest = int(np.argmax(self.class_max))

    def warm_order(self):
        """Keyframes, the densest first."""
        return np.argsort(-self.class_max, kind="stable")


def _path(p: dict):
    if p["kind"] != "lawnmower":
        raise ValueError(f"unknown path kind {p['kind']!r}")
    return synthetic.lawnmower_trajectory(
        p["n_keyframes"], extent=p["extent"], rows=p["rows"], step=p["step"])


def make_traffic(cfg: dict, traffic: dict, seed: int, device) -> Traffic:
    if traffic["generator"] != "forest_solo":
        raise ValueError(f"unknown generator {traffic['generator']!r}")
    w = cfg["world"]
    mission = int(traffic["mission_seed"])
    world = synthetic.make_forest_world(
        np.random.default_rng(mission), n_trees=w["n_trees"],
        n_poles=w["n_poles"], n_cars=0, extent=w["extent"])
    for name in ("ell_pos", "ell_scale", "ell_label"):
        setattr(world, name, getattr(world, name)[:0])
    traj = _path(traffic["path"])
    frame = traffic["frame"]
    rng = np.random.default_rng(seed)
    place = synthetic.se3.from_xyz_yaw(
        *rng.uniform(-frame["shift_m"], frame["shift_m"], 2), 0.0,
        rng.uniform(-np.pi, np.pi))
    world.cyl_root = synthetic.se3.apply(place, world.cyl_root).astype(
        np.float32)
    world.cyl_ray = synthetic.se3.rotate(place, world.cyl_ray).astype(
        np.float32)
    traj = synthetic.se3.compose(place[None], traj)
    m = traffic.get("measurements", {})
    log = synthetic.make_log(
        world, traj, seed=mission,
        odom_drift_sigma=traffic["odom_drift_sigma"],
        max_range=m.get("max_range", cfg["sensor"]["range_m"]),
        pos_noise=m.get("pos_noise", 0.05), dropout=m.get("dropout", 0.1))
    odom = np.stack([k.odom_pose for k in log.keyframes])
    if "scans" in traffic:
        s = traffic["scans"]
        scans = raycast.cast(world, traj, cfg["sensor"], cfg["heights_m"],
                             s["range_noise_m"], mission, device)
        cap = cfg["pipeline"]["max_points_per_class"]
        t = Traffic(world, traj, odom, scans=scans,
                    max_range=cfg["pipeline"]["max_range"])
        if t.class_max.max() > cap:
            raise ValueError(
                f"a scan holds {t.class_max.max()} points of one class, more "
                f"than the configuration's max_points_per_class {cap}")
        return t
    obs = [{k: v for k, v in vars(kf).items()
            if k not in ("stamp", "odom_pose", "true_pose")}
           for kf in log.keyframes]
    return Traffic(world, traj, odom, obs=obs)

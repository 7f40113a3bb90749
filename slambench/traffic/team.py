"""The team's traffic: a deployment's world, each robot's path and
measurement log, and the relative sightings between robots, made by the
frozen generators (synthetic.py) from the configuration's own seeds; and
each robot's keyframes in the order the program's input manager hands them
to its node.

The relative sightings are a frozen copy of the program's
`io/synthetic.relative_measurements` (commit 15c47a3) with its noise and
distance as parameters: at every stamp where int(2 * stamp) % period == 0,
the lower-id robot of each pair whose true poses lie within `max_dist_m`
sees the other, with `noise_m` of translation noise. The world and the
sightings draw from one generator, in that order.

Nothing here depends on the run's seed: every run replays the same
mission, so the work is the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import se3np as se3
from . import synthetic


@dataclass
class Sighting:
    """One robot seeing another (the program's scheduler.RelativeMeas
    fields)."""
    stamp: float
    relative_pose: np.ndarray   # [7] observer -> observed
    robot_index: int            # the robot seen
    odom_pose: np.ndarray       # the observer's odometry at the stamp


def relative_sightings(logs: List[synthetic.RobotLog],
                       rng: np.random.Generator, max_dist_m: float,
                       period: int, noise_m: float
                       ) -> List[Tuple[int, Sighting]]:
    out = []
    by_stamp: Dict[float, dict] = {}
    for log in logs:
        for kf in log.keyframes:
            by_stamp.setdefault(round(kf.stamp, 3), {})[log.robot_id] = kf
    for stamp, robots in sorted(by_stamp.items()):
        ids = sorted(robots)
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                a, b = robots[ids[i]], robots[ids[j]]
                d = np.linalg.norm(a.true_pose[4:7] - b.true_pose[4:7])
                if d < max_dist_m and int(stamp * 2) % period == 0:
                    rel = se3.between(a.true_pose, b.true_pose)
                    rel[4:7] += rng.normal(0, noise_m, 3)
                    out.append((ids[i], Sighting(
                        stamp=float(stamp), relative_pose=rel,
                        robot_index=ids[j], odom_pose=a.odom_pose)))
    return out


def _path(p: dict, n: int) -> np.ndarray:
    if p["kind"] == "loop":
        return synthetic.loop_trajectory(n, radius=p["radius"],
                                         laps=p["laps"])
    if p["kind"] == "lawnmower":
        return synthetic.lawnmower_trajectory(n, extent=p["extent"],
                                              rows=p["rows"], step=p["step"])
    raise ValueError(f"unknown path kind {p['kind']!r}")


@dataclass
class Keyframe:
    """One keyframe as a node integrates it: its stamp, the odometry pose
    handed over, and its measurements (None for the keyframe a sighting
    adds)."""
    stamp: float
    odom: np.ndarray
    obs: Optional[dict]


class TeamTraffic:
    def __init__(self, world, trajs, logs, sightings):
        self.world, self.trajs, self.logs = world, trajs, logs
        self.sightings = sightings
        stamps = [kf.stamp for log in logs for kf in log.keyframes]
        self.t0, self.t1 = min(stamps), max(stamps)
        self.n_robots = len(logs)
        self._seq: Dict[int, List[Keyframe]] = {}

    def sequence(self, robot: int) -> List[Keyframe]:
        """Robot `robot`'s keyframes in the order its node integrates them
        through the input manager: at each stamp, one keyframe for each of
        its own sightings (the sighting's synced odometry, no
        measurements), then the log's keyframe."""
        if robot not in self._seq:
            seen: Dict[float, int] = {}
            for obs_id, s in self.sightings:
                if obs_id == robot:
                    seen[s.stamp] = seen.get(s.stamp, 0) + 1
            out = []
            for kf in self.logs[robot].keyframes:
                for _ in range(seen.get(kf.stamp, 0)):
                    out.append(Keyframe(kf.stamp, kf.odom_pose, None))
                out.append(Keyframe(kf.stamp, kf.odom_pose, {
                    k: v for k, v in vars(kf).items()
                    if k not in ("stamp", "odom_pose", "true_pose")}))
            self._seq[robot] = out
        return self._seq[robot]


def make_traffic(cfg: dict) -> TeamTraffic:
    """The configuration's mission (`world`, `robots`, `measurements`,
    `sightings`, `keyframes_per_robot`)."""
    w, m, s = cfg["world"], cfg["measurements"], cfg["sightings"]
    n = int(cfg["keyframes_per_robot"])
    rng = np.random.default_rng(int(w["seed"]))
    world = synthetic.make_forest_world(
        rng, n_trees=w["n_trees"], n_poles=w["n_poles"], n_cars=w["n_cars"],
        extent=w["extent"])
    trajs = [_path(r["path"], n) for r in cfg["robots"]]
    logs = [synthetic.make_log(
        world, t, robot_id=i, seed=int(r["log_seed"]), t0=m["t0"],
        dt=m["dt"], max_range=m["max_range"],
        odom_drift_sigma=m["odom_drift_sigma"], pos_noise=m["pos_noise"],
        dropout=m["dropout"], yaw_drift_bias=m["yaw_drift_bias"])
        for i, (r, t) in enumerate(zip(cfg["robots"], trajs))]
    sightings = relative_sightings(logs, rng, s["max_dist_m"], s["period"],
                                   s["noise_m"])
    return TeamTraffic(world, trajs, logs, sightings)

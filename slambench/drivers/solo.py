"""One robot of a deployment, driven closed loop through the program.

Set-up makes the traffic from the seed, builds the program's objects from
the configuration, and warms up the cell's own shapes: a few keyframes of
the densest scans on a node of their own and one full solve. The window
then replays the mission as fast as the program takes it: each keyframe's
scan (or measurement set) is handed to the program only after the last
keyframe's pose is on the host, and when the mission ends a new node (and
frontend) starts it again. A keyframe's latency runs from the hand-over
to its pose, with the card synchronised.

While the window runs the loop keeps, on keyframes drawn from the seed,
what the program produced (its DBSCAN inputs and labels, its cylinder
measurements, the map and pose it associated against and its decisions)
and the states around the first mission's last full solve: references to
tensors the program made anyway, plus small copies on the device. Nothing
is read back or judged until the window has closed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .. import judge as JUDGE  # noqa: F401  (run.py judges with it)
from ..traffic import make_traffic

WARM_KEYFRAMES = 4


def _program_config(cfg: dict):
    """The program's SlamConfig, PipelineConfig and frontend config, built
    from the configuration file's `slam`, `pipeline` and `sensor` groups."""
    from slide_slam_tpu_torch import config as pc
    from slide_slam_tpu_torch.frontend import pipeline as pp
    from slide_slam_tpu_torch.frontend.lidar_pipeline import \
        LidarFrontendConfig
    slam = cfg["slam"]
    scfg = getattr(pc, slam["preset"])()
    cap = dict(slam["capacity"])
    capacity = getattr(pc, cap.pop("preset"))(**cap)
    scfg = scfg.replace(capacity=capacity, **slam["replace"])
    scfg = scfg.replace(solver=dataclasses.replace(scfg.solver,
                                                   **slam["solver"]))
    stated = (slam["association"]["submap_k"],
              slam["association"]["match_thresh_m"],
              slam["noise"]["cylinder"], slam["noise"]["bearing"])
    if (scfg.capacity.submap_k_cylinder, scfg.cylinder_match_thresh,
            scfg.noise.cylinder, scfg.noise.bearing) != stated:
        raise ValueError("the program's association or noise settings are "
                         "not the configuration's")
    pipe = cfg["pipeline"]
    classes = getattr(pp, pipe["classes_preset"])()
    stated = {c["label"]: c for c in cfg["classes"]["cylinders"]}
    for c in classes:
        if c.model == "ground":
            if c.label != cfg["classes"]["ground"]:
                raise ValueError("the program's ground class is not the "
                                 "configuration's")
            continue
        s = stated.get(c.label)
        if s is None or (c.eps_noise, c.min_samples_noise, c.eps_cluster,
                         c.min_samples_cluster) != (
                s["eps_noise"], s["min_samples_noise"], s["eps_cluster"],
                s["min_samples_cluster"]):
            raise ValueError(f"class {c.name}: the program's gates are not "
                             "the configuration's")
    keys = ("max_range", "max_points_per_class", "max_points_per_instance",
            "ground_patch_size", "breast_height", "default_radius")
    pcfg = pp.PipelineConfig(classes=classes,
                             radius_cutoff=tuple(pipe["radius_cutoff"]),
                             **{k: pipe[k] for k in keys})
    sen = cfg["sensor"]
    fcfg = LidarFrontendConfig(sen["rows"], sen["cols"], sen["fov_up_deg"],
                               sen["fov_down_deg"], desired_period=0.0)
    return scfg, pcfg, fcfg


class Solo:
    """The closed-loop solo cell. `device` is "cuda" in every benchmark
    run; the tests drive it on the CPU at a tiny size."""

    def __init__(self, cfg: dict, work: dict, seed: int, device: str,
                 trace: bool):
        self.cfg, self.work, self.seed = cfg, work, int(seed)
        self.device = torch.device(device)
        self.trace = bool(trace)
        self.cuda = self.device.type == "cuda"
        self.rec: Dict = {"spans": {"frontend_ms": [], "step_ms": [],
                                    "step_full_solve": [],
                                    "full_solve_ms": []},
                          "capture": {"scans": [], "steps": [],
                                      "solve": None},
                          "profiled_dbscan": []}
        self._episode_kf = -1
        self._episode = -1
        self._profiling = False
        self._full_solve_ran = False

    # ------------------------------------------------------------------
    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup(self):
        from slide_slam_tpu_torch.frontend import clustering
        from slide_slam_tpu_torch.runtime import engine
        self.scfg, self.pcfg, self.fcfg = _program_config(self.cfg)
        self.traffic = make_traffic(self.cfg, self.work["traffic"], self.seed,
                                    self.device)
        K = self.traffic.n_keyframes
        rng = np.random.default_rng(self.seed)
        lo, hi = self.work["judge"]["sample_range"]
        self.sample = set(rng.choice(np.arange(lo, min(hi, K)),
                                     self.work["judge"]["samples"],
                                     replace=False).tolist())
        if self.traffic.scans is not None:
            self.sample.add(int(self.traffic.densest))
        lo, n = self.work["trace"]["keyframes"]
        self.profile_range = range(lo, lo + n)
        self._wrap(clustering, engine)
        self._warm_up()

    def _wrap(self, clustering, engine):
        """Wrap the program's DBSCAN entry, keyframe step and full solve
        at runtime, in this process only: keep what the judge and the
        per-layer readers need, and (traced runs) time the full solve
        between two synchronisations."""
        cluster, step, full = (clustering.two_stage_cluster_batch,
                               engine.keyframe_step_fused, engine.solve_full)
        drv = self

        def cluster_w(points, valid, params):
            labels = cluster(points, valid, params)
            if drv._episode == 0 and drv._episode_kf in drv.sample:
                drv._scan_rec["dbscan"] = (points, valid, params, labels)
            if drv._profiling:
                drv.rec["profiled_dbscan"].append((points, valid, params))
            return labels

        def step_w(cfg, state, robot_id, odom_and_rel, packed, *a, **k):
            keep = drv._episode == 0 and drv._episode_kf in drv.sample
            if keep:
                P = cfg.capacity.max_poses_per_robot
                n = state.pose_count[robot_id].clone()
                snap = dict(
                    pose_count=n, prev_pose=state.poses[
                        robot_id * P + torch.clamp(n.long() - 1, min=0)
                    ].clone(),
                    cyl_count=state.cyl_count.clone(),
                    root=state.cyl_root.clone(), ray=state.cyl_ray.clone(),
                    label=state.cyl_label.clone(), packed=packed)
            out_state, out = step(cfg, state, robot_id, odom_and_rel, packed,
                                  *a, **k)
            if keep:
                snap["matches"] = out.cyl_matches
                snap["kf"] = drv._episode_kf
                drv.rec["capture"]["steps"].append(snap)
            return out_state, out

        def full_w(cfg, state):
            if drv.trace:
                drv.sync()
                t0 = time.perf_counter()
            out = full(cfg, state)
            if drv.trace:
                drv.sync()
                drv.rec["spans"]["full_solve_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
            drv._full_solve_ran = True
            if drv._episode == 0:
                drv.rec["capture"]["solve"] = dict(
                    state_in=state, state_out=out, episode=drv._episode,
                    kf=drv._episode_kf)
            return out

        clustering.two_stage_cluster_batch = cluster_w
        engine.keyframe_step_fused = step_w
        engine.solve_full = full_w

        def restore():
            (clustering.two_stage_cluster_batch, engine.keyframe_step_fused,
             engine.solve_full) = cluster, step, full
        self.close = restore

    def _new_episode(self):
        from slide_slam_tpu_torch.frontend.lidar_pipeline import LidarFrontend
        from slide_slam_tpu_torch.runtime.node import SlamNode
        node = SlamNode(self.scfg, robot_id=0, device=self.device)
        frontend = None
        if self.traffic.scans is not None:
            holder = self._labels_holder = {"image": None}
            frontend = LidarFrontend(lambda _x: holder["image"], self.fcfg,
                                     self.pcfg, device=self.device)
        return node, frontend

    def _mark(self, name: str):
        """A named host range in the profiler's trace, while it records."""
        if self._profiling:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()

    def _keyframe(self, node, frontend, k: int, i: int):
        """Keyframe k of the mission as the i-th of its node, handed over
        and finished: returns its latency."""
        t = self.traffic
        stamp = 1000.0 + 0.5 * i
        t0 = time.perf_counter()
        if frontend is not None:
            scan = t.scans[k]
            self._labels_holder["image"] = scan.label_image
            if self.trace:
                self.sync()
                f0 = time.perf_counter()
            with self._mark("frontend"):
                obs = frontend.process_scan(stamp, scan.points,
                                            np.zeros(len(scan.points),
                                                     np.float32), t.odom[k])
            if self.trace:
                self.sync()
                self.rec["spans"]["frontend_ms"].append(
                    (time.perf_counter() - f0) * 1e3)
        else:
            obs = t.obs[k]
        if self.trace:
            self.sync()
        s0 = time.perf_counter()
        self._full_solve_ran = False
        with self._mark("step"):
            node.process_keyframe(stamp, t.odom[k], obs)
            self.sync()
        t1 = time.perf_counter()
        if self.trace:
            self.rec["spans"]["step_ms"].append((t1 - s0) * 1e3)
            self.rec["spans"]["step_full_solve"].append(self._full_solve_ran)
        if frontend is not None and self._episode == 0 and \
                k in self.sample:
            self._scan_rec["obs"] = obs
        return t1 - t0

    def _warm_up(self):
        """The densest scans through a node of their own, then one full
        solve on its state: every kernel and buffer size of the cell."""
        node, frontend = self._new_episode()
        order = self.traffic.warm_order()[:WARM_KEYFRAMES]
        self._episode = -1
        for i, k in enumerate(order):
            self._keyframe(node, frontend, int(k), i)
        from slide_slam_tpu_torch.runtime import engine
        node.state = engine.solve_full(node.cfg, node.state)
        self.sync()
        for v in self.rec["spans"].values():
            v.clear()
        self.rec["capture"]["solve"] = None

    # ------------------------------------------------------------------
    def window(self, seconds: float):
        """Keyframes back to back for `seconds`; returns (keyframes
        finished inside the window, their latencies in seconds)."""
        K = self.traffic.n_keyframes
        lat: List[float] = []
        prof = None
        start = time.perf_counter()
        deadline = start + seconds
        self._episode = 0
        while time.perf_counter() < deadline:
            node, frontend = self._new_episode()
            for k in range(K):
                if time.perf_counter() >= deadline:
                    break
                self._episode_kf = k
                if self._episode == 0 and k in self.sample:
                    self._scan_rec = {"kf": k}
                if self.trace and self._episode == 0:
                    if k == self.profile_range.start:
                        prof = self._start_profile()
                    if k == self.profile_range.stop and prof is not None:
                        self._stop_profile(prof)
                        prof = None
                dt = self._keyframe(node, frontend, k, k)
                if self._episode == 0 and k in self.sample and \
                        frontend is not None:
                    self.rec["capture"]["scans"].append(self._scan_rec)
                if time.perf_counter() <= deadline:
                    lat.append(dt)
            self._episode += 1
        if prof is not None:
            self._stop_profile(prof)
        self._episode = -1
        return len(lat), lat

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        self._profiling = True
        return prof

    def _stop_profile(self, prof):
        self.sync()
        prof.__exit__(None, None, None)
        self._profiling = False
        self.rec["profile"] = prof
Driver = Solo

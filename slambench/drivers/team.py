"""A deployment's robot team on one card, driven closed loop through the
program's MultiRobotMission.

Set-up makes the mission from the configuration (traffic/team.py), builds
the program's SlamConfig from it, warms the searches up (SlideMatch, and
SlideGraph with CLIPPER at the association counts a mission reaches, on
maps of their own) and installs the decision capture
(drivers/team_capture.py) before the first event. It then runs the first
episode's events through sim stamp t0 + `setup.resume_after_s`: by then
every node has found its peers and folded their chains. The window resumes
that episode, its events as fast as the program takes them; when they end
it runs the episode's finals without the final solve, closes the mission
and starts a new episode from keyframe 0, until the window ends; then it
stops the mission between two events and closes it. A keyframe's latency
is one SlamNode.process_keyframe call that the input manager makes, from
the call to its step done on the card (synchronised), its fold of peers
included. The window's keyframes are counted by episode and printed on
standard error (`window_keyframes`): those of the resumed episode, the
merged team, and those of the new ones, which start unmerged.

Kept for the judge (judges/team.py), references to the program's own
tensors and small host copies, nothing read back from the card until the
window has closed. What is judged runs after the resume stamp, in the
window:

* on keyframes drawn from the seed (by each node's own count) in
  `judge.sample_range` of the resumed episode, and in
  `judge.restart_sample_range` of the first new episode where the window
  reaches it: what the step associated against and decided, as the solo
  driver keeps it;
* each node's first periodic full solve after the resume stamp: the
  states around it, the node's keyframe stamps and its merge transforms;
* every fold of peer keyframes in the first episode: the packets folded
  (stamp, key pose, relative odometry), the node's transform for the peer
  and the rows handed to engine.replay_batch.

With --trace 1 the program's spans are on for the whole window, and a
torch.profiler session records the stretch of the first episode between
the sim stamps t0 + `trace.stamps`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..judges import team as JUDGE  # noqa: F401  (run.py judges with it)
from ..traffic import team as team_traffic
from . import team_capture


def _program_config(cfg: dict):
    """The program's SlamConfig from the configuration's `slam` group,
    checked against its `closures` group (the judge's settings)."""
    from slide_slam_tpu_torch import config as pc
    slam = cfg["slam"]
    cap = dict(slam["capacity"])
    capacity = getattr(pc, cap.pop("preset"))(**cap)
    scfg = pc.SlamConfig().replace(number_of_robots=slam["number_of_robots"],
                                   capacity=capacity, **slam["replace"])
    scfg = scfg.replace(
        solver=dataclasses.replace(scfg.solver, **slam["solver"]),
        noise=dataclasses.replace(scfg.noise, **slam["noise"]))
    a = slam["association"]
    if (scfg.capacity.submap_k_cylinder, scfg.cylinder_match_thresh,
            scfg.capacity.max_scan_objects) != (
            a["submap_k"], a["match_thresh_m"], a["max_scan_objects"]):
        raise ValueError("the program's association settings are not the "
                         "configuration's")
    if json.loads(json.dumps(team_capture.settings(scfg))) != \
            cfg["closures"]:
        raise ValueError("the program's closure and merge settings are not "
                         "the configuration's `closures`")
    return scfg


def warm_searches(scfg, device):
    """One untimed pass of SlideMatch (inter and intra) and of SlideGraph
    with CLIPPER at the association counts a mission reaches, on random
    maps, so that cuFFT plans and the allocator's growth stay out of the
    window."""
    from slide_slam_tpu_torch.place_recognition import clipper
    from slide_slam_tpu_torch.place_recognition.slidegraph import SlideGraph
    from slide_slam_tpu_torch.place_recognition.slidematch import \
        PlaceRecognition
    rng = np.random.default_rng(0)
    objs = np.zeros((200, 7), np.float32)
    objs[:, 0] = rng.integers(0, 3, 200)
    objs[:, 1:3] = rng.uniform(-35, 35, (200, 2))
    objs[:, 4] = 0.3
    pr = PlaceRecognition(scfg.place_recognition, device=device)
    pr.find_transformation(objs, objs, intra=False)
    pr.find_transformation(objs[:32], objs[:32], intra=True)
    SlideGraph(scfg.slidegraph, device=device).find_inter_loop_closure(
        objs, objs)
    params = clipper.ClipperParams(sigma=scfg.slidegraph.sigma,
                                   epsilon=scfg.slidegraph.epsilon)
    for m in (50, 100, 200, 400, 900, 1800):
        pts = rng.normal(size=(m, 2)).astype(np.float32)
        clipper.dense_clique_inliers(pts, pts + 0.01, params, device=device)


class Team:
    """The closed-loop team cell. `device` is "cuda" in every benchmark
    run; the tests drive it on the CPU at a tiny size."""

    def __init__(self, cfg: dict, work: dict, seed: int, device: str,
                 trace: bool):
        self.cfg, self.work, self.seed = cfg, work, int(seed)
        self.device = torch.device(device)
        self.trace = bool(trace)
        self.cuda = self.device.type == "cuda"
        self.rec: Dict = {"closures": None,
                          "map": {"steps": [], "solves": [], "folds": [],
                                  "drops": {}, "refines_first": None}}
        self._episode = -1
        self._resumed = False     # set-up has reached the resume stamp
        self._in_window = False
        self._deadline = float("inf")
        self._lat: List[float] = []
        self._window_kf: Dict[int, int] = {}   # episode -> keyframes
        self._ctx = None          # (node, own keyframe index) in a step
        self._periodic = None     # the node whose periodic solve runs
        self._fold = None         # the fold record being filled
        self._profiling = False
        self._restore = []
        self.mission = None

    # ------------------------------------------------------------------
    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup(self):
        from slide_slam_tpu_torch.runtime import mission as pm
        if not hasattr(pm.MultiRobotMission, "advance"):
            raise RuntimeError("the program's MultiRobotMission cannot pause "
                               "and resume an episode (no `advance`)")
        self.scfg = _program_config(self.cfg)
        self.traffic = team_traffic.make_traffic(self.cfg)
        self.t0 = self.traffic.t0
        j = self.work["judge"]
        rng = np.random.default_rng(self.seed)
        # {episode: {(robot, own keyframe index)}}: the resumed episode's,
        # then the first new episode's
        self.sample = {}
        for ep, key in ((0, "sample_range"), (1, "restart_sample_range")):
            lo, hi = j[key]
            self.sample[ep] = set()
            for r in range(self.traffic.n_robots):
                seq = self.traffic.sequence(r)
                idx = [i for i in range(lo, min(hi, len(seq)))
                       if seq[i].obs is not None]
                self.sample[ep] |= {(r, int(i)) for i in
                                    rng.choice(idx, j["samples"],
                                               replace=False)}
        self.rec["map"]["sampled"] = {ep: len(v)
                                      for ep, v in self.sample.items()}
        warm_searches(self.scfg, self.device)
        self._wrap()
        self._new_episode()
        s = self.work["setup"]
        self.mission.advance(until_stamp=self.t0 + s["resume_after_s"])
        self._resumed = True
        # where the window's decisions start in the capture
        self.rec["map"]["setup_marks"] = {
            k: len(v) for k, v in self.rec["closures"].items()}

    def _new_episode(self):
        from slide_slam_tpu_torch.runtime import scheduler
        from slide_slam_tpu_torch.runtime.mission import MultiRobotMission
        t = self.traffic
        rel = [(rid, scheduler.RelativeMeas(**vars(s)))
               for rid, s in t.sightings]
        self._episode += 1
        if self._episode == 1:
            # the merges polished in the first episode
            self.rec["map"]["refines_first"] = len(
                self.rec["closures"]["refines"])
        self.mission = MultiRobotMission(
            self.scfg, t.logs, relative_meas=rel, use_input_manager=True,
            device=self.device)
        self.mission.start(intra_lc=self.work["setup"]["intra_lc"])

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._restore.append((owner, name, orig))

    def _wrap(self):
        """Wrap, in this process only, the program's keyframe entry, step,
        periodic and full solves, and peer folds: time each keyframe and
        keep what the judge reads."""
        from slide_slam_tpu_torch.place_recognition import (slidegraph,
                                                            slidematch)
        from slide_slam_tpu_torch.runtime import engine
        from slide_slam_tpu_torch.runtime import node as node_mod
        cap = team_capture.Capture().install(slidematch, slidegraph,
                                             node_mod)
        self._restore.append((cap, None, None))
        self.rec["closures"] = cap.rec
        drv = self
        keep = self.rec["map"]
        node_cls = node_mod.SlamNode

        def keyframe(orig):
            def wrapped(node, stamp, odom_pose, obs):
                drv._ctx = (node, len(node.key_poses))
                t0 = time.perf_counter()
                with drv._mark("step"):
                    out = orig(node, stamp, odom_pose, obs)
                    drv.sync()
                t1 = time.perf_counter()
                drv._ctx = None
                if drv._in_window and t1 <= drv._deadline:
                    drv._lat.append(t1 - t0)
                    ep = drv._episode
                    drv._window_kf[ep] = drv._window_kf.get(ep, 0) + 1
                return out
            return wrapped

        def step(orig):
            def wrapped(cfg, state, robot_id, odom_and_rel, packed, *a, **k):
                ctx = drv._ctx
                if drv._episode == 0 and ctx is not None:
                    keep["drops"][(robot_id, ctx[1])] = bool(a[0])
                hit = (drv._resumed and ctx is not None and (robot_id, ctx[1])
                       in drv.sample.get(drv._episode, ()))
                if hit:
                    P = cfg.capacity.max_poses_per_robot
                    n = state.pose_count[robot_id].clone()
                    snap = dict(
                        robot=robot_id, kf=ctx[1], episode=drv._episode,
                        pose_count=n,
                        prev_pose=state.poses[
                            robot_id * P + torch.clamp(n.long() - 1, min=0)
                        ].clone(),
                        cyl_count=state.cyl_count.clone(),
                        root=state.cyl_root.clone(),
                        ray=state.cyl_ray.clone(),
                        label=state.cyl_label.clone(), packed=packed)
                out_state, out = orig(cfg, state, robot_id, odom_and_rel,
                                      packed, *a, **k)
                if hit:
                    snap["matches"] = out.cyl_matches
                    keep["steps"].append(snap)
                return out_state, out
            return wrapped

        def periodic(orig):
            def wrapped(node, k=1):
                drv._periodic = node
                try:
                    return orig(node, k)
                finally:
                    drv._periodic = None
            return wrapped

        def full(orig):
            def wrapped(cfg, state):
                out = orig(cfg, state)
                node = drv._periodic
                if (node is not None and drv._episode == 0 and drv._resumed
                        and node.robot_id not in
                        {x["robot"] for x in keep["solves"]}):
                    keep["solves"].append(dict(
                        robot=node.robot_id, state_in=state, state_out=out,
                        stamps=list(node.key_stamps),
                        tfs={int(r): np.array(tf, np.float64) for r, tf in
                             node.dbm.loop_closure_tf.items()},
                        folds=len(keep["folds"])))
                return out
            return wrapped

        def replay(orig):
            def wrapped(node):
                if drv._episode != 0:
                    return orig(node)
                pending = []
                for rid, rec in node.dbm.records.items():
                    tf = node.dbm.loop_closure_tf.get(rid)
                    if rid == node.robot_id or tf is None or \
                            rec.bookmark_fg >= len(rec.packets):
                        continue
                    ps = rec.packets[rec.bookmark_fg:]
                    pending.append(dict(
                        peer=int(rid), first=int(rec.bookmark_fg),
                        tf=np.array(tf, np.float64),
                        stamps=np.array([p.stamp for p in ps]),
                        key_pose=np.stack([p.key_pose for p in ps]),
                        rel_odom=np.stack([p.rel_odom for p in ps]),
                        rows=[]))
                if not pending:
                    return orig(node)
                drv._fold = dict(robot=node.robot_id, peers=pending,
                                 at=float(node.key_stamps[-1]))
                try:
                    return orig(node)
                finally:
                    keep["folds"].append(drv._fold)
                    drv._fold = None
            return wrapped

        def replay_batch(orig):
            def wrapped(cfg, state, robot_id, poses_and_rels, *a, **k):
                if drv._fold is not None:
                    for p in drv._fold["peers"]:
                        if p["peer"] == robot_id:
                            p["rows"].append(poses_and_rels)
                return orig(cfg, state, robot_id, poses_and_rels, *a, **k)
            return wrapped

        self._patch(node_cls, "process_keyframe", keyframe)
        self._patch(node_cls, "_maybe_full_solve", periodic)
        self._patch(node_cls, "replay_peers", replay)
        self._patch(engine, "keyframe_step_fused", step)
        self._patch(engine, "solve_full", full)
        self._patch(engine, "replay_batch", replay_batch)

    def close(self):
        """Close the mission, then restore what set-up wrapped."""
        if self.mission is not None:
            self.mission.close()
        while self._restore:
            owner, name, orig = self._restore.pop()
            if name is None:
                owner.close()
            else:
                setattr(owner, name, orig)

    def _mark(self, name: str):
        """A named host range in the profiler's trace, while it records."""
        if self._profiling:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    def window(self, seconds: float):
        """The mission's events back to back for `seconds`; returns
        (keyframes finished inside the window, their latencies in
        seconds)."""
        from slide_slam_tpu_torch.runtime import profiling

        def stop():
            return time.perf_counter() >= self._deadline
        if self.trace:
            profiling.reset()
            profiling.enable()
        self._deadline = time.perf_counter() + seconds
        self._in_window = True
        try:
            if self.trace:
                a, b = self.work["trace"]["stamps"]
                self.mission.advance(until_stamp=self.t0 + a, stop=stop)
                if not stop():
                    prof = self._start_profile()
                    try:
                        self.mission.advance(until_stamp=self.t0 + b,
                                             stop=stop)
                    finally:
                        self._stop_profile(prof)
            while not stop():
                if not self.mission.advance(stop=stop):
                    self.mission.finish(final_solve=False)
                    self.mission.close()
                    self._new_episode()
        finally:
            self._in_window = False
            if self.trace:
                profiling.disable()
        self.mission.close()
        counts = [self._window_kf.get(ep, 0)
                  for ep in range(self._episode + 1)]
        self.rec["map"]["window_kf"] = counts
        print("window_keyframes " + json.dumps(
            {"resumed_episode": counts[0], "new_episodes": counts[1:]}),
            file=sys.stderr)
        return len(self._lat), list(self._lat)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        self._profiling = True
        return prof

    def _stop_profile(self, prof):
        self.sync()
        prof.__exit__(None, None, None)
        self._profiling = False
        self.rec["profile"] = prof


Driver = Team

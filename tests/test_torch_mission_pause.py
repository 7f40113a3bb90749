"""A MultiRobotMission episode paused and resumed (runtime/mission.py
`start`, `advance`, `finish`, `close`) and the team's spans
(runtime/profiling.py), on the CPU.

The mission is test_torch_mission.py's small world (40 trees, 6 poles, 4
cars) with two robots of KEYFRAMES keyframes, small capacities and a short
thorough-solve budget, run
synchronously through the input manager with intra-LC attempts and
relative sightings; its merges are accepted in the finals' confirmation
rounds. A run paused at two stamps and resumed, with the tracer on, equals
the uninterrupted run without it: the same decisions and merges, the
poses bit for bit; its spans hold the team's, keyed by robot and stamp.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import profiling
from slide_slam_tpu_torch.runtime.mission import MultiRobotMission
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYFRAMES = 16
PAUSES = (3.0, 6.3)   # sim seconds after the first stamp
TEAM_SPANS = ("closure.search", "closure.apply", "mission.replay",
              "comm.exchange")


def _mission(async_runtime=False):
    cfg, _, logs, rel = chip_smoke.small_mission(tconfig, synthetic)
    cfg = cfg.replace(
        capacity=dataclasses.replace(
            cfg.capacity, max_poses_per_robot=32, max_cylinders=128,
            max_cylinder_factors=2048, max_cuboid_factors=256,
            max_point_factors=256, max_between_factors=32),
        solver=dataclasses.replace(cfg.solver, full_solve_every=8,
                                   max_outer_iterations=4,
                                   pcg_max_iterations=64))
    for log in logs:
        log.keyframes = log.keyframes[:KEYFRAMES]
    last = max(log.keyframes[-1].stamp for log in logs)
    rel = [(r, m) for r, m in rel if m.stamp <= last]
    return MultiRobotMission(cfg, logs, relative_meas=rel,
                             async_runtime=async_runtime,
                             use_input_manager=True, device="cpu")


def _outcome(report):
    """Every node's decisions, merges and state."""
    return [dict(
        merged={r: np.asarray(tf) for r, tf in n.dbm.loop_closure_tf.items()},
        pending=sorted(n._pending_inter_tf), stamps=list(n.key_stamps),
        counts=(n.num_attempts_intra, n.num_success_intra,
                n.num_attempts_inter, n.num_success_inter,
                n.num_rel_factors),
        folded=dict(n._peer_pose_count), state=n.state)
        for n in report.nodes]


@pytest.fixture(scope="module")
def runs():
    """(the uninterrupted run's outcome, the paused and resumed run's, the
    latter's spans)."""
    whole = _outcome(_mission().run(intra_lc=True))
    m = _mission()
    profiling.reset()
    profiling.enable()
    try:
        m.start(intra_lc=True)
        for dt in PAUSES:
            assert m.advance(until_stamp=m.t0 + dt)
        paused = _outcome(m.finish())
    finally:
        profiling.disable()
    spans = profiling.spans()["spans"]
    profiling.reset()
    return whole, paused, spans


def test_paused_and_resumed_equals_uninterrupted(runs):
    whole, paused, _ = runs
    assert any(o["merged"] for o in whole), "the mission merged nothing"
    for a, b in zip(whole, paused):
        assert a["counts"] == b["counts"]
        assert a["pending"] == b["pending"]
        assert a["stamps"] == b["stamps"]
        assert a["folded"] == b["folded"]
        assert sorted(a["merged"]) == sorted(b["merged"])
        for r in a["merged"]:
            assert np.array_equal(a["merged"][r], b["merged"][r])
        for f in a["state"]._fields:
            assert torch.equal(getattr(a["state"], f),
                               getattr(b["state"], f)), f


def test_the_team_spans_are_keyed_by_robot_and_stamp(runs):
    _, _, spans = runs
    names = {s["name"] for s in spans}
    for name in TEAM_SPANS:
        assert name in names, name
    for s in spans:
        if s["name"].split(".")[0] in ("closure", "mission", "comm"):
            rid, stamp = s["key"]
            assert rid in (-1, 0, 1) and stamp is not None, s
    graph = [s for s in spans if s["name"] == "closure.search"
             and s["attrs"]["kind"] == "slidegraph"]
    assert any(s["attrs"].get("clipper_iters", 0) > 0 for s in graph)
    for s in graph:
        assert set(s["attrs"]) >= {"peers", "found"}
    applied = [s for s in spans if s["name"] == "closure.apply"]
    assert sum(s["attrs"]["merged"] for s in applied) >= 2
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "closure.polish":
            assert by_id[s["parent"]]["name"] == "closure.apply"
    replay = [s for s in spans if s["name"] == "mission.replay"]
    assert all(s["attrs"]["poses_replayed"] > 0 for s in replay)
    assert any(s["attrs"]["first_fold"] for s in replay)
    assert all(s["attrs"]["bundle_bytes"] >= 0 for s in spans
               if s["name"] == "comm.exchange")


def test_closing_mid_search_applies_the_job_and_ends_the_workers(
        monkeypatch):
    """A search still running when the mission stops is waited for and
    applied by close(), and the worker pool's threads end."""
    applied = []

    def slow_search(self, stamp=None):
        def job():
            time.sleep(0.3)
            return {}
        return self.pool.submit(job)

    def apply_closure(self, kind, res, stamp=None):
        applied.append((self.robot_id, kind, res))
    monkeypatch.setattr(SlamNode, "submit_inter_loop_closure", slow_search)
    monkeypatch.setattr(SlamNode, "apply_closure", apply_closure)
    m = _mission(async_runtime=True)
    m.start()
    assert m.advance(stop=lambda: bool(m._jobs))
    inflight = [rid for rid, _ in m._jobs]
    assert inflight and not applied
    m.close()
    assert not m._jobs
    assert [a[0] for a in applied] == inflight
    assert m.pool._threads
    assert not any(t.is_alive() for t in m.pool._threads)
    assert not any(t.is_alive() and t in m.pool._threads
                   for t in threading.enumerate())


def test_the_solo_step_opens_no_team_span():
    cfg, _, logs, _ = chip_smoke.small_mission(tconfig, synthetic)
    cfg = cfg.replace(number_of_robots=1,
                      capacity=dataclasses.replace(cfg.capacity,
                                                   max_poses_per_robot=16))
    node = SlamNode(cfg, 0, device="cpu")
    profiling.reset()
    profiling.enable()
    try:
        for kf in logs[0].keyframes[:6]:
            node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    finally:
        profiling.disable()
    names = {s["name"] for s in profiling.spans()["spans"]}
    profiling.reset()
    assert "kf" in names
    assert not {n for n in names
                if n.split(".")[0] in ("closure", "mission", "comm")}

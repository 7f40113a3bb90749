"""The port's tracer (runtime/profiling.py) on a tiny solo mission, CPU only.

Off, it records no span and keeps the per-name totals under their names;
on, each keyframe and scan has one keyed root with its children nested
inside it as the hierarchy says; the program's results are bit-equal with
tracing on and off; solver.pcg's exported iteration count is its own
device counter; a torch.profiler session turns tracing on without a single
profiler event of the tracer's; the span buffer is bounded and counts what
it drops; threads keep their own parents.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.factorgraph import solver
from slide_slam_tpu_torch.frontend import lidar_pipeline as tlp
from slide_slam_tpu_torch.frontend.pipeline import (PipelineConfig,
                                                   forest_classes)
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import profiling
from slide_slam_tpu_torch.runtime.node import SlamNode

N_KF = 9
EVERY = 4
CAPACITY = dict(
    max_poses_per_robot=32, max_cylinders=128, max_cuboids=64, max_points=32,
    max_scan_objects=32, max_cylinder_factors=512, max_cuboid_factors=128,
    max_point_factors=64, max_between_factors=8)
# phase_report()'s keys for this mission before the spans came: the
# periodic full solve and the pose fetch run every EVERY keyframes
TOTALS = {"kf_host_pack", "kf_dispatch", "periodic_full_solve", "pose_fetch"}
# span -> its parent (or parents) in the keyframe's and the scan's hierarchy
PARENT = {"kf_host_pack": "kf", "kf_dispatch": "kf",
          "periodic_full_solve": "kf", "step.body": "kf_dispatch",
          "solve": ("kf_dispatch", "periodic_full_solve"),
          "solve.build": "solve",
          "solve.pcg": "solve", "pcg.block": "solve.pcg",
          "sync.pcg_stop": "pcg.block", "solve.line_search": "solve",
          "sync.accept": "solve.line_search",
          "sync.pose_fetch": "kf",
          "scan.project": "scan", "scan.split": "scan",
          "scan.dbscan": "scan", "scan.fit": "scan",
          "scan.body_frame": "scan", "sync.point_labels": "scan.project",
          "sync.dbscan_labels": "scan.dbscan",
          "sync.cylinders": "scan.fit", "sync.body_frame": "scan.body_frame"}
SCAN_ORDER = ["scan.project", "scan.split", "scan.dbscan", "scan.fit",
              "scan.body_frame"]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    world = synthetic.make_forest_world(rng, n_trees=14, n_poles=2,
                                        n_cars=0, extent=14.0)
    traj = synthetic.lawnmower_trajectory(N_KF, extent=12.0, rows=1,
                                          step=1.0)
    scans = [synthetic.simulate_lidar_scan(world, p, rng) for p in traj]
    return world, traj, scans


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.reset()
    profiling.phase_reset()
    yield
    profiling.disable()
    profiling.reset()


def _mission(scene):
    """The scans through the frontend and a solo node: (node, obs)."""
    world, traj, scans = scene
    torch.manual_seed(0)
    cfg = tconfig.SlamConfig(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=tconfig.CapacityConfig(**CAPACITY))
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 full_solve_every=EVERY))
    holder = {"pose": traj[0]}
    frontend = tlp.LidarFrontend(
        tlp.ground_truth_segmenter(world, lambda: holder["pose"]),
        tlp.LidarFrontendConfig(height=16, width=256, desired_period=0.0),
        PipelineConfig(classes=forest_classes(), max_range=22.0),
        device="cpu")
    node = SlamNode(cfg, robot_id=0, device="cpu")
    node.pose_refresh_every = EVERY
    obs_all = []
    for i, scan in enumerate(scans):
        holder["pose"] = traj[i]
        stamp = 1000.0 + 0.5 * i
        obs = frontend.process_scan(stamp, scan,
                                    np.zeros(len(scan), np.float32), traj[i])
        obs_all.append(obs)
        node.process_keyframe(stamp, traj[i], obs)
    return node, obs_all


@pytest.fixture(scope="module")
def traced(scene):
    """The mission with tracing on, and its exported spans."""
    profiling.reset()
    profiling.enable()
    try:
        node, obs = _mission(scene)
    finally:
        profiling.disable()
    out = profiling.spans()
    profiling.reset()
    return node, obs, out


def test_off_records_no_span_and_keeps_the_totals(scene):
    _mission(scene)
    assert profiling.spans() == {"spans": [], "dropped": 0}
    assert set(profiling.phase_report()) == TOTALS
    assert profiling.phase_counts() == {
        "kf_host_pack": N_KF, "kf_dispatch": N_KF,
        "periodic_full_solve": N_KF // EVERY, "pose_fetch": N_KF // EVERY}


def test_each_keyframe_and_scan_has_one_keyed_root(traced):
    _, _, out = traced
    spans = out["spans"]
    assert out["dropped"] == 0
    by_id = {s["id"]: s for s in spans}
    stamps = [(0, 1000.0 + 0.5 * i) for i in range(N_KF)]
    for root in ("kf", "scan"):
        rs = sorted((s for s in spans if s["name"] == root),
                    key=lambda s: s["start_ns"])
        assert [s["key"] for s in rs] == stamps
        assert all(s["parent"] is None for s in rs)
    for s in spans:
        if s["parent"] is None:
            assert s["name"] in ("kf", "scan"), s["name"]
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["key"] == p["key"]
        assert p["name"] in PARENT[s["name"]], (s["name"], p["name"])
    kids = {}
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append(s)
    for s in spans:
        names = [c["name"] for c in kids.get(s["id"], [])]
        if s["name"] == "pcg.block":
            assert names == ["sync.pcg_stop"]
        elif s["name"] == "solve.line_search":
            assert names == ["sync.accept"]
        elif s["name"] == "scan":
            assert names == SCAN_ORDER
        elif s["name"] == "kf":
            assert names[:2] == ["kf_host_pack", "kf_dispatch"]
            assert s["attrs"]["full_solve"] == \
                ("periodic_full_solve" in names)
        elif s["name"] == "solve":
            assert names[0] == "solve.build"
            assert names.count("solve.build") == names.count("solve.pcg") \
                >= 1
    full = [s for s in spans if s["name"] == "periodic_full_solve"]
    assert len(full) == 2
    fetches = [s for s in spans if s["name"] == "sync.pose_fetch"]
    assert len(fetches) == N_KF // EVERY
    for s in spans:
        if s["name"] == "sync.pcg_stop" or s["name"] == "sync.accept":
            assert s["attrs"]["host_reads"] == 1
        if s["name"] == "solve.pcg":
            assert isinstance(s["attrs"]["pcg_iters"], int)
        if s["name"] == "solve.line_search":
            assert s["attrs"]["ls_graph"] == 0      # eager off the card


def test_results_are_bit_equal_with_tracing_on_and_off(scene, traced):
    on, obs_on, _ = traced
    off, obs_off = _mission(scene)
    for a, b in zip(obs_on, obs_off):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for f in off.state._fields:
        np.testing.assert_array_equal(getattr(on.state, f).numpy(),
                                      getattr(off.state, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(np.stack(on.key_poses),
                                  np.stack(off.key_poses))


def _spd(n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, n), generator=g, dtype=torch.float64)
    return (a @ a.T + n * torch.eye(n, dtype=torch.float64)).float()


@pytest.mark.parametrize("system,n,max_iters,tol,want", [
    ("identity", 24, 48, 1e-6, 1),
    ("spd", 40, 12, 0.0, 12)])
def test_pcg_iters_is_the_solvers_own_count(system, n, max_iters, tol, want):
    h = torch.eye(n) if system == "identity" else _spd(n, 1)
    b = torch.randn((n,), generator=torch.Generator().manual_seed(2))
    profiling.enable()
    solver.pcg(lambda x: h @ x, b, lambda r: r, max_iters, tol)
    profiling.disable()
    spans = profiling.spans()["spans"]
    (pcg,) = [s for s in spans if s["name"] == "solve.pcg"]
    assert pcg["attrs"]["pcg_iters"] == want
    blocks = [s for s in spans if s["name"] == "pcg.block"]
    assert len(blocks) == (1 if want == 1 else -(-max_iters //
                                                 solver.PCG_BLOCK))


def test_a_profiler_session_turns_tracing_on_unseen(scene):
    from torch.profiler import ProfilerActivity, profile
    world, traj, _ = scene
    kfs = synthetic.make_log(world, traj[:4]).keyframes
    node = SlamNode(tconfig.SlamConfig(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=tconfig.CapacityConfig(**CAPACITY)), device="cpu")
    node.process_keyframe(999.0, kfs[0].odom_pose, vars(kfs[0]))
    assert profiling.spans()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in (1, 2):
            node.process_keyframe(999.0 + i, kfs[i].odom_pose, vars(kfs[i]))
    spans = profiling.spans()["spans"]
    assert [s["key"] for s in spans if s["name"] == "kf"] == \
        [(0, 1000.0), (0, 1001.0)]
    names = {s["name"] for s in spans}
    assert {"kf", "kf_dispatch", "solve", "solve.pcg", "pcg.block",
            "sync.pcg_stop", "sync.accept"} <= names
    assert not names & {e.name for e in prof.events()}
    node.process_keyframe(1002.0, kfs[3].odom_pose, vars(kfs[3]))
    assert len(profiling.spans()["spans"]) == len(spans)


def test_the_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    profiling.enable()
    for i in range(8):
        with profiling.phase("kf", key=(0, float(i))):
            pass
    profiling.disable()
    out = profiling.spans()
    assert [s["key"] for s in out["spans"]] == [(0, float(i))
                                                for i in range(5)]
    assert out["dropped"] == 3
    profiling.reset()
    assert profiling.spans() == {"spans": [], "dropped": 0}


def test_threads_nest_their_own_spans():
    n_threads, n = 16, 50

    def work(robot):
        for i in range(n):
            with profiling.phase("kf", key=(robot, float(i))):
                with profiling.phase("kf_dispatch"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        profiling.disable()
    spans = profiling.spans()["spans"]
    assert len(spans) == 2 * n_threads * n
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s["name"] == "kf_dispatch":
            p = by_id[s["parent"]]
            assert p["name"] == "kf" and p["thread"] == s["thread"]
            assert p["key"] == s["key"]
        else:
            assert s["parent"] is None

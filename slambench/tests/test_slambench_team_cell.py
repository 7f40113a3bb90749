"""The team cell (drivers/team.py, judges/team.py, traffic/team.py) on the
CPU at a tiny size.

A traced run through run.run_cell gives a well-formed line: the cell's
checks under their limits and the five team metrics read from the
window's spans; what it judged ran in the window. A second run, set-up
and then the mission advanced past the judged solves, plants one fault a
robot, and each reads over the map check's limit on its own robot: robot
0's first periodic full solve after the resume stamp returns its input (a
skipped full solve), robot 1 drops the first relative factor it would add,
and robot 2 folds its peers' keyframes under transforms 0.1 m off. The
mission is then left and a new episode started, whose drawn keyframes are
judged too.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from conftest import ROOT  # noqa: E402

CELL = "forest_team3.demo"
METRICS = ("mission.replay_ms_per_kf", "closure.apply_ms_per_kf",
           "closure.wait_ms_per_kf", "closure.search_ms_p50",
           "comm.exchange_ms_per_kf")
SOLVE_AT = 36      # the first periodic full solve after the resume stamp
RESUME_AFTER_S = 17.0


def tiny_team(cfg, work):
    """The cell cut to a CPU test's size: 3 robots x 40 keyframes in a
    66-object forest over +-20 m; exchanges every 2.5 s and inter searches
    every 2 s of sim time, so that the team merges by keyframe ~25; a full
    solve every 12 keyframes. Set-up runs through t0 + 17 s (each node has
    taken 28-35 keyframes: the input manager holds them 3 s, and robot 1's
    sightings add keyframes), so the keyframes judged, 36-39, and the
    solves judged, robot 0's at 36, run in the window."""
    cfg["keyframes_per_robot"] = 40
    cfg["world"].update(seed=0, n_trees=60, n_poles=6, n_cars=4,
                        extent=20.0)
    cfg["robots"] = [
        {"path": {"kind": "loop", "radius": 8.0, "laps": 1.5},
         "log_seed": 5},
        {"path": {"kind": "lawnmower", "extent": 16.0, "rows": 3,
                  "step": 1.2}, "log_seed": 6},
        {"path": {"kind": "lawnmower", "extent": 18.0, "rows": 3,
                  "step": 1.2}, "log_seed": 7}]
    cfg["measurements"].update(odom_drift_sigma=0.01, yaw_drift_bias=0.0)
    cfg["sightings"].update(max_dist_m=15.0, period=4)
    cfg["slam"]["capacity"] = dict(
        preset="CapacityConfig", max_poses_per_robot=64, max_cylinders=256,
        max_cuboids=64, max_points=64, max_scan_objects=48,
        max_cylinder_factors=12288, max_cuboid_factors=2048,
        max_point_factors=2048, max_between_factors=64,
        submap_k_cylinder=96)
    cfg["slam"]["association"]["max_scan_objects"] = 48
    cfg["slam"]["replace"].update(
        inter_robot_place_recognition_frequency=0.5,
        communication_wait_time=2.5)
    cfg["slam"]["solver"]["full_solve_every"] = 12
    work["setup"]["resume_after_s"] = RESUME_AFTER_S
    work["judge"].update(sample_range=[36, 40])
    work["trace"]["stamps"] = [18.4, 19.6]


@pytest.fixture(scope="module")
def traced():
    """(the line, the judge's readings) of one traced tiny run."""
    from slambench import run
    from slambench.judges import team as J
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    kept = {}
    readings = J.readings

    def keep(*a, **k):
        kept["values"] = readings(*a, **k)
        return kept["values"]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    J.readings = keep
    try:
        line, _ = run.run_cell(manifest, CELL, 2 ** 31 + 101, 60.0, True,
                               "cpu", tiny_team)
    finally:
        J.readings = readings
        torch.set_num_threads(n)
    return line, kept["values"]


def test_tiny_traced_run_gives_a_well_formed_line(traced):
    from slambench import run
    line, values = traced
    work = run.load_json(ROOT, "slambench", "workloads", f"{CELL}.json")
    back = json.loads(json.dumps(line))
    assert list(back)[-1] == "checks"
    assert set(back["checks"]) == set(work["limits"])
    assert back["correct"] is True, back["checks"]
    assert back["attempted"] > 0
    assert set(back["metrics"]) == set(METRICS)
    for m in back["metrics"].values():
        assert m["value"] >= 0
    # the team merged in set-up, and the judged graphs hold peer chains
    assert values["_setup_merges_accepted"] >= 3
    # the judged keyframes ran in the window: each of the resumed
    # episode's, and the new episode's that the window reached
    assert values["_matched_keyframes"] == 6
    assert values["_window_kf_resumed"] + values["_window_kf_new"] == \
        back["attempted"]
    if values["_window_kf_new"] >= 3 * 9:
        assert values["_matched_keyframes_new_episode"] == 6
    for r in range(3):
        assert values[f"_robot{r}_folds"] > 0
        assert values[f"_robot{r}_factor_gap"] < 1e-3
    assert values["_robot1_rel_factors"] >= values["_robot1_rel_due"] > 0


@pytest.fixture(scope="module")
def planted():
    """The judge's readings of a set-up whose program carries one fault a
    robot."""
    from slambench import run
    from slambench.drivers import team
    from slambench.judges import team as J
    from slide_slam_tpu_torch.runtime import engine, scheduler
    from slide_slam_tpu_torch.runtime.node import SlamNode
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    _, conf = run.cell_of(manifest, CELL)
    cfg = run.load_json(ROOT, conf["file"])
    work = run.load_json(ROOT, "slambench", "workloads", f"{CELL}.json")
    tiny_team(cfg, work)
    saved = (engine.solve_full, SlamNode._maybe_full_solve, SlamNode._replay,
             scheduler.find_relative_measurement_matches)
    solve_full, periodic, replay, matches = saved
    skip, dropped = [False], []

    def full(cfg_, state):
        return state if skip[0] else solve_full(cfg_, state)

    def periodic_skip(node, k=1):
        skip[0] = node.robot_id == 0 and len(node.key_poses) == SOLVE_AT
        try:
            return periodic(node, k)
        finally:
            skip[0] = False

    def replay_off(node, pending, first_fold):
        if node.robot_id == 2:
            off = []
            for rid, rec, tf, n in pending:
                tf = np.array(tf, np.float32)
                tf[4] += 0.1
                off.append((rid, rec, tf, n))
            pending = off
        return replay(node, pending, first_fold)

    def drop_first(feasible, counter, stamps, host):
        out = matches(feasible, counter, stamps, host)
        if host == 1 and out and not dropped:
            dropped.append(out.pop(0))
        return out
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    engine.solve_full = full
    SlamNode._maybe_full_solve = periodic_skip
    SlamNode._replay = replay_off
    scheduler.find_relative_measurement_matches = drop_first
    try:
        drv = team.Driver(cfg, work, 2 ** 31 + 5, "cpu", False)
        drv.setup()
        drv.mission.advance(until_stamp=drv.t0 + RESUME_AFTER_S + 6.0)
        drv.mission.close()
        drv._new_episode()
        drv.mission.advance(until_stamp=drv.t0 + 8.0)
        drv.close()
    finally:
        (engine.solve_full, SlamNode._maybe_full_solve, SlamNode._replay,
         scheduler.find_relative_measurement_matches) = saved
        torch.set_num_threads(n)
    assert dropped
    side = J.program_side(drv.rec)
    return J.readings(cfg, work, drv.traffic, side), work["limits"]


def test_a_skipped_full_solve_reads_over_the_limit(planted):
    values, limits = planted
    assert values["_robot0_factor_gap"] < 1e-3
    assert values["_robot0_excess"] > limits["solve_cost_excess"]
    assert values["solve_cost_excess"] > limits["solve_cost_excess"]


def test_a_dropped_relative_factor_reads_bad(planted):
    values, _ = planted
    assert values["_robot1_rel_factors"] < values["_robot1_rel_due"]
    assert values["_robot1_excess"] == 1e9


def test_peers_folded_under_a_transform_off_read_bad(planted):
    values, _ = planted
    assert values["_robot2_folds"] > 0
    assert values["_robot2_factor_gap"] > 0.09
    assert values["_robot2_excess"] == 1e9


def test_a_new_episodes_drawn_keyframes_are_judged(planted):
    values, _ = planted
    assert values["_matched_keyframes"] == 6
    assert values["_matched_keyframes_new_episode"] == 6
    assert values["match_mismatch"] == 0

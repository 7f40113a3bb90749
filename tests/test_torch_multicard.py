"""The team across processes: the port's discovery mission
(parallel/team_mission.py) against the JAX package's multi-chip dry run
(__graft_entry__._run_spmd_mission), the mission over a two-process gloo
group against one process, and the launcher that starts such a group
(parallel/multiprocess.launch) when a rank fails.

Tolerances: the mission's inputs (world, packets, compact maps) exactly
equal; the TFs found, pose counts and landmark counts identical; poses
within 1e-4 m of the JAX mission's (the JAX test's own bound,
tests/test_spmd.py:145); the two-process run within 1e-6 m of the
one-process run (the same arithmetic per robot on this CPU); the TFs
SlideMatch found within 1e-4 of the JAX mission's.

The whole mission through JAX is `slow`, like the JAX package's own test of
it (test_spmd_8dev_vs_1dev_parity): its team step compiles for ~23 s and
each SlideMatch search with the default yaw sweep takes ~4.5 s on this CPU.
Tier 1 holds the mission's search to the dry run's search loop instead, on
the maps the port's mission holds at its search, with the yaw sweep off in
both packages (~1 s a search through JAX). JAX and the JAX package are
imported inside the tests that use them: the ranks that `launch` spawns
import this module to find their function, and then pay for torch alone.
"""
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from slide_slam_tpu_torch.config import (CapacityConfig,
                                         PlaceRecognitionConfig, SlamConfig)
from slide_slam_tpu_torch.parallel import multiprocess as mp
from slide_slam_tpu_torch.parallel import team_mission as tm


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other parity tests (the workers of a
    test run share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POSE_TOL = 1e-4
TF_TOL = 1e-4
GROUP_POSE_TOL = 1e-6

# tests/test_spmd.py's tiny_cfg
CAP = dict(max_poses_per_robot=16, max_cylinders=64, max_cuboids=32,
           max_points=32, max_scan_objects=8, max_cylinder_factors=128,
           max_cuboid_factors=64, max_point_factors=64,
           max_between_factors=8)


def tiny_cfgs(n_robots, **place_recognition):
    """The two packages' tiny configurations; `place_recognition` overrides
    fields of both PlaceRecognitionConfigs."""
    from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
    from slide_slam_tpu.config import \
        PlaceRecognitionConfig as JPlaceRecognitionConfig
    from slide_slam_tpu.config import SlamConfig as JSlamConfig
    j = JSlamConfig(number_of_robots=n_robots,
                    capacity=JCapacityConfig(**CAP),
                    solver=JSlamConfig().solver.__class__(
                        max_outer_iterations=2, pcg_max_iterations=16),
                    place_recognition=JPlaceRecognitionConfig(
                        **place_recognition))
    t = SlamConfig(number_of_robots=n_robots, capacity=CapacityConfig(**CAP),
                   solver=SlamConfig().solver.__class__(
                       max_outer_iterations=2, pcg_max_iterations=16),
                   place_recognition=PlaceRecognitionConfig(
                       **place_recognition))
    return j, t


def _folded_gap(poses_a, poses_b, counts):
    return chip_smoke.folded_gap(poses_a, poses_b, counts,
                                 CAP["max_poses_per_robot"])


def test_mission_inputs_equal_jax():
    """The world, the robots' frames, every step's packets and a replica's
    compact map are the dry run's, exactly."""
    import jax
    import __graft_entry__ as ge
    from slide_slam_tpu.geometry import se3np as jse3np
    jcfg, tcfg = tiny_cfgs(3)
    jroot, jradius = ge._dryrun_world(np.random.default_rng(42))
    root, radius = tm.dryrun_world(np.random.default_rng(42))
    np.testing.assert_array_equal(root, jroot)
    np.testing.assert_array_equal(radius, jradius)
    frames = tm.robot_frames(3)
    np.testing.assert_array_equal(np.stack(frames), np.stack([
        np.asarray(jse3np.from_xyz_yaw(0.8 * r, 0.4 * (r % 3), 0.0, 0.0),
                   np.float32) for r in range(3)]))
    for k in range(5):
        jp = jax.tree_util.tree_leaves(
            ge._packets_for_step(jcfg, jroot, jradius, frames, k))
        tp = tm.packets_for_step(tcfg, root, radius, frames, k, range(3),
                                 "cpu")
        tp_rows = tm.packets_for_step(tcfg, root, radius, frames, k, [1, 2],
                                      "cpu")
        leaves = [tp.pose_est, tp.rel_odom, *tp.cyl, *tp.cub, *tp.ell]
        rows = [tp_rows.pose_est, tp_rows.rel_odom, *tp_rows.cyl,
                *tp_rows.cub, *tp_rows.ell]
        assert len(jp) == len(leaves)
        for j, t, t12 in zip(jp, leaves, rows):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            np.testing.assert_array_equal(t12.numpy(), np.asarray(j)[1:])
    rng = np.random.default_rng(3)
    graph = type("G", (), dict(
        cyl_count=np.array([5, 0, 7], np.int32),
        cyl_label=rng.integers(0, 9, (3, 64)).astype(np.int32),
        cyl_root=rng.normal(size=(3, 64, 3)).astype(np.float32),
        cyl_radius=rng.uniform(size=(3, 64)).astype(np.float32)))
    for r in range(3):
        np.testing.assert_array_equal(
            tm.compact_map(graph.cyl_label[r], graph.cyl_root[r],
                           graph.cyl_radius[r], int(graph.cyl_count[r])),
            ge._replica_compact_map(graph, r))


def test_discovery_mission_in_one_process():
    """The port's one-process mission (2 robots, 4 steps): both TFs found by
    SlideMatch at step 2, so each replica holds its own 4 keyframes and
    one of its peer's (the counts the dry run gives for these steps), and
    every replica has a cylinder map; the TF set is the one the search
    returned, on the maps it reports."""
    _, tcfg = tiny_cfgs(2)
    res = tm.run_team_mission(tcfg, 4, device="cpu")
    assert res.found == [(0, 1), (1, 0)]
    np.testing.assert_array_equal(res.state.graph.pose_count.numpy(),
                                  [[4, 1], [1, 4]])
    np.testing.assert_array_equal(res.state.tf_valid.numpy(),
                                  np.ones((2, 2), bool))
    assert (res.state.graph.cyl_count.numpy() > 0).all()
    assert [len(m) for m in res.maps] == [9, 9]


def test_discovery_search_matches_jax():
    """The mission's SlideMatch TF discovery against the dry run's search
    loop (__graft_entry__._run_spmd_mission, with the JAX package's
    _replica_compact_map, PlaceRecognition and set_tf) on the maps the
    port's one-process mission holds at its search: 2 robots, 3 steps (the
    search after the last), the yaw sweep off in both packages (the frames
    differ by a translation). The maps searched equal the dry run's, the
    same (owner, peer) pairs are found, and the TF tables agree: validity
    exactly, values within 1e-4."""
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from slide_slam_tpu.geometry import se3 as jse3
    from slide_slam_tpu.geometry import se3np as jse3np
    from slide_slam_tpu.parallel import multirobot as jmr
    from slide_slam_tpu.place_recognition.slidematch import \
        PlaceRecognition as JPlaceRecognition
    jcfg, tcfg = tiny_cfgs(2, disable_yaw_search=True)
    res = tm.run_team_mission(tcfg, 3, device="cpu")
    graph_np = SimpleNamespace(**{
        f: getattr(res.state.graph, f).numpy()
        for f in ("cyl_count", "cyl_label", "cyl_root", "cyl_radius")})
    maps = [ge._replica_compact_map(graph_np, r) for r in range(2)]
    assert [len(m) for m in maps] == [len(m) for m in res.maps]
    for got, want in zip(res.maps, maps):
        np.testing.assert_array_equal(got, want)
    # the TF tables jmr.make_spmd_state starts from (its graph is not used)
    jstate = jmr.SpmdState(
        None, jnp.broadcast_to(jse3.identity()[None, None], (2, 2, 7)),
        jnp.eye(2, dtype=bool))
    pr = JPlaceRecognition(jcfg.place_recognition)
    found, tf_valid = [], np.asarray(jstate.tf_valid)
    for owner in range(2):
        for peer in range(2):
            if owner == peer or tf_valid[owner, peer]:
                continue
            ok, tf = pr.find_inter_loop_closure(maps[owner], maps[peer])
            if ok:
                jstate = jmr.set_tf(jstate, owner, peer,
                                    jse3np.from_matrix(tf))
                found.append((owner, peer))
    assert len(found) >= 1 and res.found == found
    np.testing.assert_array_equal(res.state.tf_valid.numpy(),
                                  np.asarray(jstate.tf_valid))
    np.testing.assert_allclose(res.state.tf_vals.numpy(),
                               np.asarray(jstate.tf_vals), rtol=0,
                               atol=TF_TOL)


@pytest.mark.slow
def test_discovery_mission_matches_jax_one_device_mesh():
    """The whole mission, 2 robots x 8 steps (discovery at step 4), against
    __graft_entry__._run_spmd_mission on a one-device JAX mesh: the same
    TFs found, pose and landmark counts identical, every folded pose within
    1e-4 m, every replica with a cylinder map."""
    import jax
    from jax.sharding import Mesh
    import __graft_entry__ as ge
    jcfg, tcfg = tiny_cfgs(2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("robot",))
    jstate, n_found = ge._run_spmd_mission(mesh, jcfg, 8)
    res = tm.run_team_mission(tcfg, 8, device="cpu")
    assert n_found >= 1 and len(res.found) == n_found
    counts = np.asarray(jstate.graph.pose_count)
    np.testing.assert_array_equal(res.state.graph.pose_count.numpy(), counts)
    np.testing.assert_array_equal(res.state.tf_valid.numpy(),
                                  np.asarray(jstate.tf_valid))
    np.testing.assert_array_equal(res.state.graph.cyl_count.numpy(),
                                  np.asarray(jstate.graph.cyl_count))
    assert (np.diag(counts) == 8).all() and (counts > 0).all()
    gap = _folded_gap(res.state.graph.poses.numpy(),
                      np.asarray(jstate.graph.poses), counts)
    assert gap <= POSE_TOL, gap
    np.testing.assert_allclose(res.state.tf_vals.numpy(),
                               np.asarray(jstate.tf_vals), atol=TF_TOL)


def _mission_rank(cfg, n_steps):
    torch.set_num_threads(1)
    res = tm.run_team_mission(cfg, n_steps, device="cpu")
    return dict(robots=res.robots, found=res.found,
                poses=res.state.graph.poses.numpy(),
                counts=res.state.graph.pose_count.numpy(),
                cyl=res.state.graph.cyl_count.numpy(),
                gathers=mp.local_batch_to_global.calls)


@pytest.mark.slow
def test_two_process_gloo_mission_equals_one_process():
    """The mission with 4 robots over a two-process gloo group (2 robots a
    process; packets, TF tables and cylinder maps all-gathered) equals the
    one-process mission: the same TFs, counts identical, poses within
    1e-6 m."""
    _, cfg = tiny_cfgs(4)
    outs = mp.launch(_mission_rank, 2, args=(cfg, 4), device="cpu",
                     timeout_s=300)
    one = tm.run_team_mission(cfg, 4, device="cpu")
    assert [o["robots"] for o in outs] == [[0, 1], [2, 3]]
    assert all(o["gathers"] > 0 for o in outs)
    found = sorted(p for o in outs for p in o["found"])
    assert found == sorted(one.found) and len(found) >= 1
    counts = np.concatenate([o["counts"] for o in outs])
    np.testing.assert_array_equal(counts, one.state.graph.pose_count.numpy())
    np.testing.assert_array_equal(np.concatenate([o["cyl"] for o in outs]),
                                  one.state.graph.cyl_count.numpy())
    poses = np.concatenate([o["poses"] for o in outs])
    gap = _folded_gap(poses, one.state.graph.poses.numpy(), counts)
    assert gap <= GROUP_POSE_TOL, gap


def _failing_rank(how, waiting):
    """Rank 1 fails as `how` says; rank 0 creates the file `waiting` and
    waits for rank 1 in an all_reduce."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        if how == "raises":
            raise ValueError("rank 1 fails on purpose")
        if how == "exits":
            os._exit(3)
        time.sleep(3600)
    open(waiting, "w").close()
    dist.all_reduce(torch.ones(1))
    return dist.get_rank()


@pytest.mark.parametrize("how,timeout_s", [
    ("raises", 30.0), ("hangs", 12.0),
    pytest.param("exits", 30.0, marks=pytest.mark.slow)])
def test_launch_fails_when_a_rank_fails(how, timeout_s, tmp_path):
    """A rank that raises or dies fails the launch at once, and one that
    hangs at the launch's timeout, while its peer waits for it in an
    all_reduce (the timeout is longer than the ~4 s, ~9 s under a loaded
    test run, that two processes importing torch take to form the group);
    no rank outlives the launch. The dead rank's case is `slow`."""
    import multiprocessing
    waiting = tmp_path / "rank0_in_all_reduce"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        mp.launch(_failing_rank, 2, args=(how, str(waiting)), device="cpu",
                  timeout_s=timeout_s)
    elapsed = time.monotonic() - t0
    if how == "hangs":
        assert waiting.exists(), "the launch ended before rank 0 waited"
        assert timeout_s <= elapsed < timeout_s + 15.0, elapsed
    else:
        assert elapsed < 20.0, elapsed
    assert multiprocessing.active_children() == []

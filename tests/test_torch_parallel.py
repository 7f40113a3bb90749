"""The port's team step (parallel/multirobot.py) against the JAX package's
`build_spmd_step` on the 8-device CPU mesh of tests/conftest.py: the cases
of tests/test_spmd.py.

Tolerances: every integer (pose counts, TF validity, landmark counts)
identical; poses within 1e-4 m after three steps with incremental solves
(the JAX test's own 8-vs-1-device bound); gossiped TFs within 1e-5.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
from slide_slam_tpu.config import SlamConfig as JSlamConfig
from slide_slam_tpu.geometry import se3 as jse3
from slide_slam_tpu.parallel import multirobot as jmr
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.parallel import multirobot as mr

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POSE_TOL = 1e-4
TF_TOL = 1e-5

CAP = dict(max_poses_per_robot=16, max_cylinders=64, max_cuboids=32,
           max_points=32, max_scan_objects=8, max_cylinder_factors=128,
           max_cuboid_factors=64, max_point_factors=64,
           max_between_factors=8)


def tiny_cfgs(n_robots):
    """tests/test_spmd.py's tiny_cfg in both packages."""
    j = JSlamConfig(number_of_robots=n_robots,
                    capacity=JCapacityConfig(**CAP),
                    solver=JSlamConfig().solver.__class__(
                        max_outer_iterations=2, pcg_max_iterations=16))
    t = SlamConfig(number_of_robots=n_robots, capacity=CapacityConfig(**CAP),
                   solver=SlamConfig().solver.__class__(
                       max_outer_iterations=2, pcg_max_iterations=16))
    return j, t


@pytest.fixture(scope="module")
def jax8():
    """The JAX step on the 8-device mesh, compiled once for the module."""
    jcfg, tcfg = tiny_cfgs(8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("robot",))
    return jcfg, tcfg, mesh, jmr.build_spmd_step(jcfg, mesh)


def _run_both(jax8, tfs, n_steps):
    """n_steps of both packages' team step from empty states with `tfs`
    ({(owner, peer): pose7}) set first; returns (JAX state, port state,
    the port's input state of the last step)."""
    jcfg, tcfg, mesh, jstep = jax8
    js = jmr.make_spmd_state(jcfg, mesh)
    ts = mr.make_spmd_state(tcfg, device="cpu")
    for (o, p), tf in tfs.items():
        js = jmr.set_tf(js, o, p, tf)
        ts = mr.set_tf(ts, o, p, tf)
    jp = jmr.make_example_packets(jcfg)
    tp = mr.make_example_packets(tcfg, device="cpu")
    tstep = mr.build_spmd_step(tcfg, device="cpu")
    before = ts
    for _ in range(n_steps):
        js = jstep(js, jp)
        before, ts = ts, tstep(ts, tp)
    return js, ts, before


def _assert_same(js, ts):
    counts = np.asarray(js.graph.pose_count)
    np.testing.assert_array_equal(ts.graph.pose_count.numpy(), counts)
    np.testing.assert_array_equal(ts.tf_valid.numpy(), np.asarray(js.tf_valid))
    np.testing.assert_array_equal(ts.graph.cyl_count.numpy(),
                                  np.asarray(js.graph.cyl_count))
    np.testing.assert_array_equal(ts.graph.overflow.numpy(),
                                  np.asarray(js.graph.overflow))
    P = CAP["max_poses_per_robot"]
    jposes = np.asarray(js.graph.poses)
    for r in range(counts.shape[0]):
        for rr in range(counts.shape[1]):
            sl = slice(rr * P, rr * P + int(counts[r, rr]))
            np.testing.assert_allclose(ts.graph.poses.numpy()[r, sl],
                                       jposes[r, sl], atol=POSE_TOL)
    return counts


def test_spmd_step_runs_and_counts(jax8):
    js, ts, before = _run_both(jax8, {}, 1)
    counts = _assert_same(js, ts)
    assert (np.diag(counts) == 1).all()
    assert (counts - np.diag(np.diag(counts))).sum() == 0
    # the step leaves its input unchanged
    assert int(before.graph.pose_count.sum()) == 0


def test_spmd_streaming_merge_with_tf(jax8):
    tf = np.asarray(se3np.from_xyz_yaw(1.0, 0.0, 0.0, 0.0), np.float32)
    js, ts, before = _run_both(jax8, {(0, 1): tf}, 2)
    counts = _assert_same(js, ts)
    assert counts[0, 0] == 2 and counts[0, 1] == 2 and counts[1, 0] == 0
    assert int(before.graph.pose_count[0, 1]) == 1


def test_spmd_tf_gossip(jax8):
    """0 knows 1, 1 knows 2 -> after one step 0 knows 2 transitively."""
    t12 = np.asarray(se3np.from_xyz_yaw(1.0, 2.0, 0.0, 0.0), np.float32)
    t21 = np.asarray(se3np.from_xyz_yaw(0.0, 5.0, 0.0, 0.0), np.float32)
    js, ts, _ = _run_both(jax8, {(0, 1): t12, (1, 2): t21}, 1)
    _assert_same(js, ts)
    assert bool(ts.tf_valid[0, 2])
    expect = np.asarray(jse3.compose(jnp.asarray(t12), jnp.asarray(t21)))
    np.testing.assert_allclose(ts.tf_vals[0, 2].numpy(), expect, atol=TF_TOL)
    np.testing.assert_allclose(ts.tf_vals.numpy(), np.asarray(js.tf_vals),
                               atol=TF_TOL)


def test_spmd_all_tfs_three_steps_match_8dev(jax8):
    """tests/test_spmd.py:114's layout parity in the port's terms: every
    TF seeded (run_spmd_mission_step), three steps, every replica folds
    every robot's packets; the port's one-card layout against the JAX
    8-device mesh, pose by pose."""
    tfs = {(o, p): np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
           for o in range(8) for p in range(8) if o != p}
    js, ts, _ = _run_both(jax8, tfs, 3)
    counts = _assert_same(js, ts)
    assert (counts == 3).all()
    assert (ts.graph.cyl_count.numpy() > 0).all()


def test_spmd_13_robots_bounded():
    """MAX_NUM_ROBOTS = 13 (graph.h:11): two steps of 13 replicas, robot 0
    knowing robot 1; counts as in tests/test_spmd.py:80, within a time
    bound (the port has no compile; the step loops over the robots)."""
    _, cfg = tiny_cfgs(13)
    state = mr.set_tf(mr.make_spmd_state(cfg, device="cpu"), 0, 1,
                      se3np.from_xyz_yaw(1.0, 0.0, 0.0, 0.0))
    step = mr.build_spmd_step(cfg, device="cpu")
    packets = mr.make_example_packets(cfg, device="cpu")
    t0 = time.perf_counter()
    for _ in range(2):
        state = step(state, packets)
    elapsed = time.perf_counter() - t0
    counts = state.graph.pose_count.numpy()
    assert counts.shape == (13, 13)
    assert (np.diag(counts) == 2).all()
    assert counts[0, 1] == 2 and counts[1, 0] == 0
    assert elapsed < 60.0, f"13-robot team steps took {elapsed:.0f} s"


MP_CAP = dict(max_poses_per_robot=32, max_cylinders=64, max_cuboids=32,
              max_points=32, max_scan_objects=16, max_cylinder_factors=256,
              max_cuboid_factors=128, max_point_factors=128,
              max_between_factors=8)

MP_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.parallel import multiprocess as mp

dist = mp.initialize(mp.ProcessSpec({init!r}, world_size=2, rank={rank},
                                    device="cpu"))
assert dist.get_backend() == "gloo"
cfg = SlamConfig(number_of_robots=8, capacity=CapacityConfig(**{cap!r}))
poses, counts, dt = mp.run_spmd_mission_step(cfg, n_steps=3, device="cpu")
print("RESULT" + json.dumps(dict(local_rows=poses.shape[0],
                                 counts=counts.tolist(),
                                 poses=poses.tolist(), step_s=dt)))
dist.destroy_process_group()
"""


def test_one_process_mission_step_matches_jax(jax8):
    """parallel/multiprocess.run_spmd_mission_step with no process group
    (this process holds all 8 robots) against the body of the JAX
    package's run_spmd_mission_step (every TF seeded with identity frames,
    the example packets, 1 + 3 steps) on the 8-device CPU mesh: every
    replica folded all 8 packets in each step, poses within 2e-4 m
    (tests/test_multiprocess.py's bound)."""
    from slide_slam_tpu_torch.parallel import multiprocess as mp
    jcfg, tcfg, mesh, jstep = jax8
    poses, counts, _ = mp.run_spmd_mission_step(tcfg, n_steps=3,
                                                 device="cpu")
    assert (counts == 4).all(), counts
    js = jmr.make_spmd_state(jcfg, mesh)._replace(
        tf_vals=jnp.broadcast_to(jnp.asarray([1., 0, 0, 0, 0, 0, 0]),
                                 (8, 8, 7)),
        tf_valid=jnp.ones((8, 8), bool))
    packets = jmr.make_example_packets(jcfg)
    for _ in range(4):
        js = jstep(js, packets)
    np.testing.assert_array_equal(counts, np.asarray(js.graph.pose_count))
    np.testing.assert_allclose(poses, np.asarray(js.graph.poses), atol=2e-4)


@pytest.mark.slow
def test_two_process_gloo_mission_step_matches_one_process():
    """tests/test_multiprocess.py's layout over a two-process gloo group:
    each process holds 4 of the 8 robots (rank -> robots map, packets and
    TF tables all-gathered by local_batch_to_global); together they equal
    the one-process step to 1e-6 m (the same arithmetic per robot) and
    every replica folded all 8 packets in each of the 4 steps."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from slide_slam_tpu_torch.parallel import multiprocess as mp
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_WORKER.format(
            repo=repo, init=f"tcp://localhost:{port}", rank=r, cap=MP_CAP)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se[-3000:]
        line = [x for x in so.splitlines() if x.startswith("RESULT")][-1]
        outs.append(json.loads(line[len("RESULT"):]))
    assert [o["local_rows"] for o in outs] == [4, 4]
    combined = np.asarray(outs[0]["poses"] + outs[1]["poses"], np.float32)
    counts = np.asarray(outs[0]["counts"] + outs[1]["counts"])
    assert (counts == 4).all(), counts
    cfg = SlamConfig(number_of_robots=8, capacity=CapacityConfig(**MP_CAP))
    poses_1p, counts_1p, _ = mp.run_spmd_mission_step(cfg, n_steps=3,
                                                      device="cpu")
    np.testing.assert_array_equal(counts, counts_1p)
    np.testing.assert_allclose(combined, poses_1p, atol=1e-6, rtol=0)
    print("two-process gloo team step: max |dpose| against one process "
          f"{np.abs(combined - poses_1p).max():.3e}, "
          f"{outs[0]['step_s']:.3f} s per step")

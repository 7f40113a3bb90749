"""The port's ctypes binding to the C++ runtime core (slide_slam_tpu_torch/
native.py, built with g++ into slide_slam_tpu_torch/_build/): the cases of
tests/test_native.py, with the JAX package's Python scheduler as the
reference, and the native case of tests/test_mission_runtime.py:78 on the
port's mission. Where g++ is missing each test skips with that reason.

Tolerances: queue decisions, stamps and labels identical; decoded floats
equal to the encoded ones (the codec copies f32 bytes); the mission's
trajectories with native and Python queues within 1e-5 m (the same
keyframes in the same order, so the same solves).
"""
from collections import deque

import numpy as np
import pytest
import torch

from slide_slam_tpu.comm.database import packet_from_obs as jpacket_from_obs
from slide_slam_tpu.runtime import scheduler as jsch
from slide_slam_tpu_torch import native
from slide_slam_tpu_torch.comm.database import packet_from_obs
from slide_slam_tpu_torch.config import SlamConfig
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.input_manager import InputManager
from slide_slam_tpu_torch.runtime.mission import MultiRobotMission
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _toolchain():
    if not native.available():
        pytest.skip("no g++: the native runtime core cannot be built here")


def pose(x=0.0):
    return se3np.from_xyz_yaw(x, 0.0, 0.0, 0.0)


def test_empty():
    kind, *_ = native.NativeQueues().pick_next(1000.0, 3.0, 0.5)
    assert kind == 0


def test_odom_pick_and_pop_semantics():
    q = native.NativeQueues()
    for i in range(100):
        q.push_odom(float(i), pose(1.0))
    q.set_latest_odom(0.0, pose(0.0))
    kind, stamp, _, _ = q.pick_next(76.0, 3.0, 0.5)
    assert (kind, stamp, q.sizes()[0]) == (1, 73.0, 27)
    kind, *_ = q.pick_next(76.0, 3.0, 1.5)
    assert kind == 0 and q.sizes()[0] == 27


def test_obs_vs_rel_ordering():
    q = native.NativeQueues()
    q.push_observation(1.0, pose(), {"id": "obs"})
    q.push_relative(10.0, pose(), {"id": "rel"}, 1, False)
    kind, _, _, obj = q.pick_next(1000.0, 3.0, 0.5)
    assert kind == 2 and obj["id"] == "obs"
    q.pop(2)
    kind, _, _, obj = q.pick_next(1000.0, 3.0, 0.5)
    assert kind == 3 and obj["id"] == "rel"


def test_matches_jax_python_scheduler_randomized():
    """200 random events: the port's C++ queues pick what the JAX
    package's Python scheduler picks."""
    rng = np.random.default_rng(0)
    q = native.NativeQueues()
    odom_q, obs_q, rel_q = deque(), deque(), deque()
    t = 0.0
    latest = jsch.StampedPose(stamp=0.0, pose=pose(0.0))
    q.set_latest_odom(0.0, pose(0.0))
    for trial in range(200):
        t += rng.uniform(0.1, 0.6)
        kind_event = rng.integers(0, 3)
        x = rng.uniform(0, 5)
        if kind_event == 0:
            q.push_odom(t, pose(x))
            odom_q.append(jsch.StampedPose(stamp=t, pose=pose(x)))
        elif kind_event == 1:
            q.push_observation(t, pose(x), None)
            obs_q.append(jsch.Observation(
                stamped_pose=jsch.StampedPose(stamp=t, pose=pose(x))))
        else:
            rel_q.append(jsch.RelativeMeas(stamp=t, relative_pose=pose(),
                                           robot_index=1, odom_pose=pose(x)))
            q.push_relative(t, pose(x), None, 1, False)
        now = t + rng.uniform(0, 5)
        got = q.pick_next(now, 3.0, 0.5)[0]
        want = jsch.pick_next_measurement(odom_q, obs_q, rel_q, latest, now,
                                          3.0, 0.5)
        assert got == want, (trial, got, want)
        for k, dq in ((1, odom_q), (2, obs_q), (3, rel_q)):
            if want == k:
                dq.popleft()
        if want != 0:
            q.pop(want)


def _obs(rng):
    return {
        "cyl_root": rng.normal(size=(3, 3)).astype(np.float32),
        "cyl_ray": rng.normal(size=(3, 3)).astype(np.float32),
        "cyl_radius": rng.uniform(0.1, 0.5, 3).astype(np.float32),
        "cyl_label": np.array([8, 8, 9], np.int32),
        "cub_pose": rng.normal(size=(2, 7)).astype(np.float32),
        "cub_scale": rng.uniform(1, 3, (2, 3)).astype(np.float32),
        "cub_label": np.array([5, 5], np.int32),
        "ell_pose": rng.normal(size=(1, 7)).astype(np.float32),
        "ell_scale": rng.uniform(0.2, 1, (1, 3)).astype(np.float32),
        "ell_label": np.array([2], np.int32),
    }


def test_wire_codec_roundtrip_matches_jax_packet():
    """A port packet round-trips through the C codec, and equals the JAX
    package's packet of the same observation field by field."""
    obs = _obs(np.random.default_rng(1))
    p = packet_from_obs(1234.5678, pose(3.0), pose(0.1), obs)
    jp = jpacket_from_obs(1234.5678, pose(3.0), pose(0.1), obs)
    q = native.decode_packet(native.encode_packet(p))
    assert q.stamp == p.stamp == jp.stamp
    for k in p.__dataclass_fields__:
        if k == "stamp":
            continue
        np.testing.assert_array_equal(np.asarray(getattr(q, k)),
                                      np.asarray(getattr(p, k)), err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(p, k)),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def test_empty_packet():
    p = packet_from_obs(1.0, pose(), pose(), {})
    q = native.decode_packet(native.encode_packet(p))
    assert len(q.cyl_radius) == 0 and len(q.cub_label) == 0


def test_input_manager_use_native():
    """InputManager(use_native=True) takes the C++ queues here (g++ is
    present) and routes an observation stream as the Python queues do."""
    cfg = SlamConfig(number_of_robots=1)
    nodes = [SlamNode(cfg, robot_id=0, device="cpu") for _ in range(2)]
    ims = [InputManager(cfg, nodes[0], use_native=True),
           InputManager(cfg, nodes[1], use_native=False)]
    assert ims[0].use_native and not ims[1].use_native
    for i in range(6):
        for im in ims:
            im.on_odometry(float(i), pose(1.5 * i))
            im.on_observation(float(i) + 0.5, pose(1.5 * i + 0.2), {})
    done = [im.tick(100.0) for im in ims]
    assert done[0] == done[1] > 0
    assert nodes[0].key_stamps == nodes[1].key_stamps


@pytest.mark.usefixtures("one_torch_thread")
def test_mission_native_queue_backend():
    """tests/test_mission_runtime.py:78 on the port, at 20 keyframes per
    robot: the C++ queue backend gives the same keyframe sequence and
    trajectories as the Python queues."""
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=40, n_poles=6,
                                        n_cars=4, extent=25.0)
    trajs = [synthetic.loop_trajectory(20, radius=9.0, laps=0.6),
             synthetic.lawnmower_trajectory(20, extent=20.0, rows=2,
                                            step=1.2)]
    logs = [synthetic.make_log(world, t, robot_id=r, seed=5 + r,
                               odom_drift_sigma=0.01, pos_noise=0.03)
            for r, t in enumerate(trajs)]
    cfg = SlamConfig(number_of_robots=2)
    missions = [MultiRobotMission(cfg, logs, async_runtime=False,
                                  use_input_manager=True,
                                  use_native_queues=nq, device="cpu")
                for nq in (False, True)]
    assert [[im.use_native for im in m.input_managers.values()]
            for m in missions] == [[False, False], [True, True]]
    reps = [m.run(intra_lc=False) for m in missions]
    for a, b in zip(*(r.nodes for r in reps)):
        assert a.key_stamps == b.key_stamps and len(a.key_stamps) > 10
        np.testing.assert_allclose(a.optimized_trajectory(),
                                   b.optimized_trajectory(), atol=1e-5)
    assert torch.get_num_threads() == 1

"""The measurement scheduler and the input manager: the PyTorch port against
the JAX package (tests/test_scheduler.py, tests/test_input_manager.py).

The scheduler is host code copied into the port: every scenario of the
reference's input_test.cpp / sloam_test.cpp ports runs through both modules
and must give identical picks, queue states and matches. The input manager
drives a node from raw odometry and observation streams in both packages:
identical keyframe stamps, landmark counts and overflow, poses within
1e-3 m / 1e-3 rad (f32 solver sums in another order). The native C++ queue
core is not ported and must raise.
"""
from collections import deque

import numpy as np
import pytest

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.runtime import scheduler as jsch
from slide_slam_tpu.runtime.input_manager import InputManager as JIM
from slide_slam_tpu.runtime.node import SlamNode as JNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import scheduler as tsch
from slide_slam_tpu_torch.runtime.input_manager import InputManager as TIM
from slide_slam_tpu_torch.runtime.node import SlamNode as TNode

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POS_TOL = 1e-3
ROT_TOL = 1e-3


def _helpers(sch):
    def sp(stamp, x=0.0):
        return sch.StampedPose(stamp=stamp, pose=np.asarray(
            se3np.from_xyz_yaw(x, 0.0, 0.0, 0.0), np.float32))

    def obs(stamp, x=0.0):
        return sch.Observation(stamped_pose=sp(stamp, x))

    def rel(stamp, robot=1, only_odom=False):
        ident = np.asarray(se3np.identity(), np.float32)
        return sch.RelativeMeas(stamp=stamp, relative_pose=ident,
                                robot_index=robot, odom_pose=ident,
                                only_use_odom=only_odom)
    return sp, obs, rel


def _pick_scenarios(sch):
    """(name, result) of the tests/test_scheduler.py pick cases; the result
    holds the pick and the queues' stamps after it."""
    sp, obs, rel = _helpers(sch)
    out = []

    def run(name, o, ob, r, latest, now, tol, dist):
        kind = sch.pick_next_measurement(o, ob, r, latest, now, tol, dist)
        out.append((name, kind, [e.stamp for e in o],
                    [e.stamped_pose.stamp for e in ob], [e.stamp for e in r]))

    run("empty", deque(), deque(), deque(), sp(0.0), 1000.0, 3.0, 0.5)
    run("odom", deque([sp(1.0, 1.0)]), deque(), deque(), sp(0.0), 1000.0,
        3.0, 0.5)
    run("obs", deque(), deque([obs(1.0)]), deque(), sp(0.0), 1000.0, 3.0,
        0.5)
    run("rel", deque(), deque(), deque([rel(1.0)]), sp(0.0), 1000.0, 3.0,
        0.5)
    run("obs_first", deque(), deque([obs(1.0)]), deque([rel(10.0)]),
        sp(0.0), 1000.0, 3.0, 0.5)
    run("rel_first", deque(), deque([obs(10.0)]), deque([rel(1.0)]),
        sp(0.0), 1000.0, 3.0, 0.5)
    big = deque(sp(float(i), 1.0) for i in range(100))
    run("big_odom", big, deque(), deque(), sp(0.0), 76.0, 3.0, 0.5)
    run("big_odom_not_moved", big, deque(), deque(), sp(0.0), 76.0, 3.0, 1.5)
    for name, ob_t, r_t in (("delay_odom", 10.0, 10.0),
                            ("delay_obs", 1.0, 10.0),
                            ("delay_rel", 10.0, 1.0)):
        run(name, deque([sp(1.0, 1.0)]), deque([obs(ob_t)]),
            deque([rel(r_t)]), sp(0.0), 10.0, 8.0, 0.5)
    run("pop_stale", deque(sp(float(i), 1.0) for i in range(12)),
        deque(obs(float(i), 1.0) for i in range(12)),
        deque(rel(float(i)) for i in range(12)), sp(10.0), 12.0, 3.0, 0.5)
    return out


def test_pick_next_measurement_matches_jax():
    t, j = _pick_scenarios(tsch), _pick_scenarios(jsch)
    assert t == j
    assert [x[1] for x in t] == [0, 1, 2, 3, 2, 3, 1, 0, 1, 2, 3, 0]


def test_index_closest_stamp_matches_jax():
    for stamps, s in (([], 10.0), ([5.0], 10.0), ([5.0, 15.0, 12.0], 11.0),
                      ([5.0, 15.0, 12.0], 13.5), ([5.0, 15.0, 12.0], 13.4)):
        assert tsch.index_closest_stamp(stamps, s) == \
            jsch.index_closest_stamp(stamps, s)


def _match_scenarios(sch):
    _, _, rel = _helpers(sch)
    out = []
    for feas, counter, stamps in (
            ([], [0, 0], {}),
            ([rel(5.0)], [0, 0], {0: [], 1: []}),
            ([rel(5.0)], [1, 1], {0: [5.0], 1: [5.0]}),
            ([rel(5.0), rel(7.000001)], [2, 2],
             {0: [5.0, 7.0], 1: [5.0, 7.0]}),
            ([rel(10.0)], [3, 3], {0: [5.0, 7.0, 9.008],
                                   1: [5.0, 7.0, 10.002]}),
            ([rel(2.0)], [1, 1], {0: [4.0], 1: [4.0]})):
        m = sch.find_relative_measurement_matches(feas, counter, stamps, 0)
        out.append(([(x.index_host, x.index_other, x.meas.stamp) for x in m],
                    [f.stamp for f in feas]))
    for bad in (rel(1.0, robot=0), rel(1.0, robot=1, only_odom=True)):
        with pytest.raises(ValueError):
            sch.find_relative_measurement_matches([bad], [0, 0],
                                                  {0: [], 1: []}, 0)
    return out


def test_find_relative_measurement_matches_matches_jax():
    t, j = _match_scenarios(tsch), _match_scenarios(jsch)
    assert t == j
    assert [len(x[0]) for x in t] == [0, 0, 1, 2, 0, 0]
    assert t[4][1] == [10.0] and t[5][1] == []


# ---------------------------------------------------------------------------
# Input manager (inputNode.cpp main loop)
# ---------------------------------------------------------------------------
def _im_cfg(config):
    return config.SlamConfig(
        number_of_robots=2, odom_freq_filter=2, msg_delay_tolerance=0.5,
        capacity=config.CapacityConfig(
            max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
            max_points=64, max_scan_objects=32, max_cylinder_factors=512,
            max_cuboid_factors=256, max_point_factors=256,
            max_between_factors=16))


def _drive(im, log):
    """Raw odometry at 4x the keyframe rate (the filter keeps 1/2), the
    synced observation, a high-frequency pose query and a tick per
    keyframe, then a final flush tick (tests/test_input_manager.py)."""
    for kf in log.keyframes:
        for k in range(4):
            im.on_odometry(kf.stamp - 0.4 + 0.1 * k, kf.odom_pose)
        im.on_observation(kf.stamp, kf.odom_pose, vars(kf))
        im.high_freq_pose(kf.stamp, kf.odom_pose)
        im.tick(kf.stamp + 1.0)
    im.tick(log.keyframes[-1].stamp + 10.0)


@pytest.fixture(scope="module")
def driven():
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=5, n_cars=5,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(15, extent=16.0, rows=1, step=1.5)
    log = synthetic.make_log(world, traj, dt=1.0)
    jnode = JNode(_im_cfg(jconfig), robot_id=0)
    jim = JIM(_im_cfg(jconfig), jnode)
    _drive(jim, log)
    tnode = TNode(_im_cfg(tconfig), robot_id=0, device="cpu")
    tim = TIM(_im_cfg(tconfig), tnode)
    _drive(tim, log)
    return jnode, jim, tnode, tim, log


def test_input_manager_main_loop_matches_jax(driven):
    jnode, jim, tnode, tim, log = driven
    assert tnode.key_stamps == jnode.key_stamps
    assert len(tnode.key_poses) >= len(log.keyframes) - 1
    assert tnode.landmark_counts() == jnode.landmark_counts()
    assert tnode.landmark_counts()["cylinders"] > 5
    assert tnode.overflow_report() == jnode.overflow_report()
    t, j = tnode.optimized_trajectory(), jnode.optimized_trajectory()
    np.testing.assert_allclose(t[:, 4:7], j[:, 4:7], atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=ROT_TOL, rtol=0)
    truth = np.stack([k.true_pose for k in log.keyframes])
    assert synthetic.ate_rmse(t, truth[:len(t)], align=False) < 1.0
    # the high-frequency pose log (drift compensation TF) agrees too
    assert len(tim.high_freq_log) == len(jim.high_freq_log)
    for a, b in zip(tim.high_freq_log, jim.high_freq_log):
        np.testing.assert_allclose(a.slam_to_vio, b.slam_to_vio, atol=1e-3)


def test_high_freq_pose_and_odom_filter_match_jax():
    for config, IM, Node, kw in ((jconfig, JIM, JNode, {}),
                                 (tconfig, TIM, TNode, dict(device="cpu"))):
        cfg = _im_cfg(config)
        im = IM(cfg, Node(cfg, robot_id=0, **kw))
        vio = se3np.from_xyz_yaw(1.0, 2.0, 0.0, 0.1)
        out = im.high_freq_pose(0.0, vio)
        np.testing.assert_allclose(out.pose, vio, atol=1e-6)
        np.testing.assert_allclose(out.slam_to_vio, se3np.identity(),
                                   atol=1e-6)
        for i in range(10):
            im.on_odometry(float(i), se3np.from_xyz_yaw(i * 1.0, 0, 0, 0))
        assert [e.stamp for e in im.odom_queue] == [1.0, 3.0, 5.0, 7.0, 9.0]


def test_native_queues_raise():
    """use_native=True no longer raises (native.py is ported): as in the JAX
    package, the input manager takes the C++ queues where the library
    builds, and the Python queues otherwise."""
    from slide_slam_tpu_torch import native
    cfg = _im_cfg(tconfig)
    node = TNode(cfg, robot_id=0, device="cpu")
    im = TIM(cfg, node, use_native=True)
    assert im.use_native == native.available()
    assert not TIM(cfg, node).use_native

"""Intra-robot loop closure through SlamNode (the sloamNode.cpp:355-486
path): the PyTorch port (on the CPU) against the JAX package.

A drifting 1.35-lap loop (60 keyframes, yaw drift bias) through a forest;
from keyframe 45 on, every third keyframe attempts a closure (gate,
candidate search over the refreshed chain, SlideMatch on the compact-map
submap, fit and consistency gates, closure factor, thorough solve). This
is tests/test_intra_loop_closure.py's setup on a shorter loop. Tolerances:
* attempts, successes, the closure factors' pose slots and the landmark
  counts identical;
* closure relative poses within 1e-3 m / 1e-3 rad;
* trajectory within 1 cm and ATE within 5 mm of the JAX package's (f32
  solver sums in another order, carried through three thorough solves).
"""
import numpy as np
import pytest

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.place_recognition.slidematch import \
    SlideMatchDims as JDims
from slide_slam_tpu.runtime.node import SlamNode as JNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.place_recognition.slidematch import \
    SlideMatchDims as TDims
from slide_slam_tpu_torch.runtime.node import SlamNode as TNode

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAJ_TOL = 1e-2
ATE_TOL = 5e-3
REL_TOL = 1e-3
DIMS = dict(fine_grid=512, max_objects=256, n_yaw=24, rescore_topk=32)


def lc_cfg(config):
    """tests/test_intra_loop_closure.py's closure config, one robot."""
    return config.SlamConfig(
        number_of_robots=1, lc_candidate_min_poses_old=40, lc_min_pose_idx=10,
        capacity=config.CapacityConfig(
            max_poses_per_robot=128, max_cylinders=512, max_cuboids=256,
            max_points=128, max_scan_objects=48, max_cylinder_factors=4096,
            max_cuboid_factors=2048, max_point_factors=1024,
            max_between_factors=32),
        place_recognition=config.PlaceRecognitionConfig(
            search_xy_step_size=0.25, search_yaw_step_size_degrees=5.0,
            match_threshold_position=0.75, min_num_inliers=6,
            min_num_map_objects_to_start=5,
            match_x_half_range_intra=6.0, match_y_half_range_intra=6.0,
            match_yaw_half_range_intra=15.0))


@pytest.fixture(scope="module")
def loops():
    rng = np.random.default_rng(3)
    world = synthetic.make_forest_world(rng, n_trees=80, n_poles=12,
                                        n_cars=10, extent=35.0)
    traj = synthetic.loop_trajectory(60, radius=14.0, laps=1.35)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.012,
                             yaw_drift_bias=0.0015, pos_noise=0.02,
                             dropout=0.05, max_range=18.0, seed=5)
    nodes = (JNode(lc_cfg(jconfig), robot_id=0,
                   slidematch_dims=JDims(**DIMS)),
             TNode(lc_cfg(tconfig), robot_id=0,
                   slidematch_dims=TDims(**DIMS), device="cpu"))
    for node in nodes:
        for i, kf in enumerate(log.keyframes):
            node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
            if i > 44 and i % 3 == 0:
                node.attempt_intra_loop_closure()
    return nodes + (log, traj)


def test_closure_decisions_identical(loops):
    jnode, tnode, log, _ = loops
    assert (tnode.num_attempts_intra, tnode.num_success_intra) == \
        (jnode.num_attempts_intra, jnode.num_success_intra)
    assert tnode.num_success_intra >= 2
    n = int(tnode.state.bf_count)
    assert n == int(jnode.state.bf_count) == tnode.num_success_intra
    np.testing.assert_array_equal(tnode.state.bf_i[:n].numpy(),
                                  np.asarray(jnode.state.bf_i)[:n])
    np.testing.assert_array_equal(tnode.state.bf_j[:n].numpy(),
                                  np.asarray(jnode.state.bf_j)[:n])
    t_rel = tnode.state.bf_rel[:n].numpy()
    np.testing.assert_allclose(t_rel, np.asarray(jnode.state.bf_rel)[:n],
                               atol=REL_TOL, rtol=0)
    assert tnode.landmark_counts() == jnode.landmark_counts()
    assert tnode.overflow_report() == jnode.overflow_report()
    # each closure's relative pose is close to the truth
    P = tnode.cfg.capacity.max_poses_per_robot
    for i, j, rel in zip(tnode.state.bf_i[:n].numpy(),
                         tnode.state.bf_j[:n].numpy(), t_rel):
        true_rel = se3np.between(log.keyframes[i % P].true_pose,
                                 log.keyframes[j % P].true_pose)
        assert np.linalg.norm(rel[4:7] - true_rel[4:7]) < 1.0


def test_closed_loop_trajectory_matches(loops):
    jnode, tnode, log, traj = loops
    t, j = tnode.optimized_trajectory(), jnode.optimized_trajectory()
    np.testing.assert_allclose(t[:, 4:7], j[:, 4:7], atol=TRAJ_TOL, rtol=0)
    ate_t = synthetic.ate_rmse(t, traj, align=False)
    ate_j = synthetic.ate_rmse(j, traj, align=False)
    odom = np.stack([kf.odom_pose for kf in log.keyframes])
    assert abs(ate_t - ate_j) < ATE_TOL, (ate_t, ate_j)
    assert ate_t < 0.8 * synthetic.ate_rmse(odom, traj, align=False)

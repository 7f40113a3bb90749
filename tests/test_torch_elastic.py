"""Robot join / crash / restart of the port against the JAX package, on the
cases of tests/test_elastic_mission.py: the same three-robot logs, the same
exchanges, each package's own nodes (and checkpoint module for the restore).

Tolerances: database lengths and per-robot pose counts identical (the JAX
tests' assertions hold for both), own trajectories within 1e-2 m and
replayed peer chains within 2.5e-2 m (those of tests/test_torch_mission.py:
f32 sums in another order, amplified by the full solves of a replay).
"""
import numpy as np
import pytest

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.io import checkpoint as jckpt
from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.io import checkpoint as tckpt
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import one_torch_thread  # noqa: F401
from test_elastic_mission import N_KF, T_CRASH, db_len, exchange, feed

TRAJ_TOL = 1e-2
PEER_TOL = 2.5e-2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CAPACITY = dict(
    max_poses_per_robot=128, max_cylinders=512, max_cuboids=256,
    max_points=128, max_scan_objects=48, max_cylinder_factors=4096,
    max_cuboid_factors=2048, max_point_factors=1024, max_between_factors=64)


class Package:
    """One package's node constructor and checkpoint functions."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.cfg = jconfig.SlamConfig(
                number_of_robots=3, communication_wait_time=3.0,
                capacity=jconfig.CapacityConfig(**CAPACITY))
        else:
            self.cfg = tconfig.SlamConfig(
                number_of_robots=3, communication_wait_time=3.0,
                capacity=tconfig.CapacityConfig(**CAPACITY))

    def node(self, rid):
        if self.name == "jax":
            return JSlamNode(self.cfg, rid, prior_tf_known=True)
        return SlamNode(self.cfg, rid, prior_tf_known=True, device="cpu")

    def restore(self, node, path):
        if self.name == "jax":
            jckpt.save_node(path, node)
            return jckpt.load_node(path, self.cfg)
        tckpt.save_node(path, node)
        return tckpt.load_node(path, self.cfg, device="cpu")


@pytest.fixture(scope="module")
def logs():
    """The logs of tests/test_elastic_mission.py, from the port's copy of
    io/synthetic (the same numbers)."""
    rng = np.random.default_rng(11)
    world = synthetic.make_forest_world(rng, n_trees=60, n_poles=10,
                                        n_cars=8, extent=30.0)
    base = synthetic.lawnmower_trajectory(N_KF, extent=22.0, rows=2, step=2.0)
    out = []
    for r, (dx, dy) in enumerate([(0.0, 0.0), (7.0, 5.0), (-6.0, 4.0)]):
        traj = base.copy()
        traj[:, 4] += dx
        traj[:, 5] += dy
        out.append(synthetic.make_log(world, traj, robot_id=r, seed=20 + r,
                                      odom_drift_sigma=0.005, pos_noise=0.02,
                                      dropout=0.05, dt=0.5, t0=1000.0))
    return out


def _outcome(nodes):
    """Every node's database lengths and pose counts, per robot."""
    return [([len(n.dbm.host_record().packets) if rid == n.robot_id
              else db_len(n, rid) for rid in range(3)],
             [int(n.state.pose_count[rid]) for rid in range(3)])
            for n in nodes]


def _assert_close(nodes, jnodes):
    for n, j in zip(nodes, jnodes):
        for rid in range(3):
            a, b = n.trajectory_of(rid), np.asarray(j.trajectory_of(rid))
            assert a.shape == b.shape
            tol = TRAJ_TOL if rid == n.robot_id else PEER_TOL
            np.testing.assert_allclose(a[:, 4:7], b[:, 4:7], atol=tol, rtol=0)


def _join(pkg, logs):
    n0, n1 = pkg.node(0), pkg.node(1)
    feed(n0, logs[0], 0, T_CRASH)
    feed(n1, logs[1], 0, T_CRASH)
    exchange([n0, n1], now=1010.0)
    n2 = pkg.node(2)
    nodes = [n0, n1, n2]
    for n, log in zip(nodes, logs):
        feed(n, log, T_CRASH, N_KF)
    exchange(nodes, now=1020.0, rounds=2)
    before = _outcome(nodes)
    for n in nodes:
        n.replay_peers()
    return nodes, before


def _crash(pkg, logs, tmp_path=None):
    nodes = [pkg.node(r) for r in range(3)]
    for n, log in zip(nodes, logs):
        feed(n, log, 0, T_CRASH)
    exchange(nodes, now=1010.0)
    nodes[1] = (pkg.node(1) if tmp_path is None
                else pkg.restore(nodes[1], str(tmp_path / pkg.name)))
    for n, log in zip(nodes, logs):
        feed(n, log, T_CRASH, N_KF)
    exchange(nodes, now=1020.0, rounds=2)
    before = _outcome(nodes)
    for n in nodes:
        n.replay_peers()
    return nodes, before


def test_robot_joins_mid_mission(logs):
    nodes, before = _join(Package("port"), logs)
    jnodes, jbefore = _join(Package("jax"), logs)
    assert before == jbefore and _outcome(nodes) == _outcome(jnodes)
    n0, n1, n2 = nodes
    assert db_len(n2, 0) == N_KF and db_len(n2, 1) == N_KF
    assert db_len(n0, 2) == N_KF - T_CRASH
    assert db_len(n1, 2) == N_KF - T_CRASH
    assert int(n0.state.pose_count[2]) == N_KF - T_CRASH
    assert int(n2.state.pose_count[0]) == N_KF
    _assert_close(nodes, jnodes)


def test_crash_and_fresh_restart(logs):
    nodes, before = _crash(Package("port"), logs)
    jnodes, jbefore = _crash(Package("jax"), logs)
    assert before == jbefore and _outcome(nodes) == _outcome(jnodes)
    n0, n1, n2 = nodes
    assert db_len(n1, 0) == N_KF and db_len(n1, 2) == N_KF
    assert db_len(n0, 1) == T_CRASH and db_len(n2, 1) == T_CRASH
    assert int(n1.state.pose_count[1]) == N_KF - T_CRASH
    assert int(n1.state.pose_count[0]) == N_KF
    assert int(n0.state.pose_count[1]) == T_CRASH
    _assert_close(nodes, jnodes)


def test_crash_and_checkpoint_restore(logs, tmp_path):
    nodes, _ = _crash(Package("port"), logs, tmp_path)
    jnodes, _ = _crash(Package("jax"), logs, tmp_path)
    assert _outcome(nodes) == _outcome(jnodes)
    for n in nodes:
        for rid in range(3):
            have = (len(n.dbm.host_record().packets) if rid == n.robot_id
                    else db_len(n, rid))
            assert have == N_KF, (n.robot_id, rid, have)
            assert int(n.state.pose_count[rid]) == N_KF
    est = nodes[1].optimized_trajectory()
    assert len(est) == N_KF
    truth = np.stack([kf.true_pose for kf in logs[1].keyframes])
    assert synthetic.ate_rmse(est, truth, align=False) < 1.0
    _assert_close(nodes, jnodes)

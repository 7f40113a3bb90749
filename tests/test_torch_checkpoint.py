"""Checkpoint / resume of the port (io/checkpoint.py, SlamNode.rebuild_mirrors)
against the JAX package, on the case of tests/test_checkpoint.py, and
checkpoints carried across the two packages in both directions.

Tolerances: a restored GraphState equals the saved one field by field, bit
for bit, dtypes included (int32 slots and counters, bool prior_valid); host
mirrors and the database equal; a restored port node continues bit for bit
like the uninterrupted one (the CPU sums in a fixed order). Across the
packages: landmark counts identical, poses within 1e-3 m after 6 more
keyframes.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.io import checkpoint as jckpt
from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.factorgraph.graph import GraphState
from slide_slam_tpu_torch.io import checkpoint as tckpt
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode
from slide_slam_tpu_torch.runtime.scheduler import RelativeMeas

from _torch_parity import one_torch_thread  # noqa: F401

POSE_TOL = 1e-3
N_SAVE = 10

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CAPACITY = dict(
    max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
    max_points=64, max_scan_objects=32, max_cylinder_factors=512,
    max_cuboid_factors=256, max_point_factors=256, max_between_factors=16)


def _cfgs(**kw):
    """tests/test_checkpoint.py's config in both packages."""
    return (jconfig.SlamConfig(number_of_robots=2, capacity=jconfig.
                               CapacityConfig(**CAPACITY), **kw),
            tconfig.SlamConfig(number_of_robots=2, capacity=tconfig.
                               CapacityConfig(**CAPACITY), **kw))


@pytest.fixture(scope="module")
def log():
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=25, n_poles=5, n_cars=5,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(16, extent=16.0, rows=1, step=1.5)
    return synthetic.make_log(world, traj, odom_drift_sigma=0.01)


def _feed(node, log, lo, hi):
    for kf in log.keyframes[lo:hi]:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))


def _assert_state_equal(got: GraphState, want):
    for f in GraphState._fields:
        a = getattr(got, f)
        b = np.asarray(getattr(want, f).cpu() if isinstance(
            getattr(want, f), torch.Tensor) else getattr(want, f))
        assert a.cpu().numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.cpu().numpy(), b, err_msg=f)
    assert got.pose_count.dtype == torch.int32
    assert got.prior_valid.dtype == torch.bool


def _assert_host_equal(got, want):
    assert got.robot_id == want.robot_id
    assert got.key_stamps == want.key_stamps
    np.testing.assert_array_equal(np.stack(got.key_poses),
                                  np.stack(want.key_poses))
    assert all(p.dtype == np.float32 for p in got.key_poses)
    np.testing.assert_array_equal(got.latest_odom, want.latest_odom)
    assert sorted(got.dbm.records) == sorted(want.dbm.records)
    for rid, rec in want.dbm.records.items():
        g = got.dbm.records[rid]
        assert g.bookmark_fg == rec.bookmark_fg
        assert [p.stamp for p in g.packets] == [p.stamp for p in rec.packets]
        for pg, pw in zip(g.packets, rec.packets):
            np.testing.assert_array_equal(pg.key_pose, pw.key_pose)
            np.testing.assert_array_equal(pg.cyl_label, pw.cyl_label)
            np.testing.assert_array_equal(pg.cyl_root, pw.cyl_root)
    assert sorted(got.dbm.loop_closure_tf) == sorted(want.dbm.loop_closure_tf)
    for k, v in want.dbm.maps.items():
        np.testing.assert_array_equal(got.dbm.maps[k], v)


def _port_mirrors(node):
    return dict(xyz=[np.asarray(x).tolist() for x in node._xyz_hist],
                refresh=node._kf_since_refresh,
                full=node._kf_since_full_solve,
                peers=dict(node._peer_pose_count),
                rel=[(m.stamp, m.robot_index, m.relative_pose.tolist())
                     for m in node.feasible_relative_meas],
                counters=(node.num_rel_factors, node.num_attempts_intra))


def test_node_checkpoint_roundtrip(tmp_path, log):
    jcfg, cfg = _cfgs()
    node = SlamNode(cfg, robot_id=0, device="cpu")
    jnode = JSlamNode(jcfg, robot_id=0)
    _feed(node, log, 0, N_SAVE)
    _feed(jnode, log, 0, N_SAVE)

    ckpt = str(tmp_path / "ckpt")
    tckpt.save_node(ckpt, node)
    assert sorted(os.listdir(ckpt)) == ["graph.npz", "node.json",
                                        "runtime.json"]
    node2 = tckpt.load_node(ckpt, cfg, device="cpu")
    _assert_state_equal(node2.state, node.state)
    _assert_host_equal(node2, node)
    assert _port_mirrors(node2) == _port_mirrors(node)
    np.testing.assert_allclose(node2.optimized_trajectory(),
                               node.optimized_trajectory(), atol=1e-6)
    assert node2.landmark_counts() == node.landmark_counts() == \
        jnode.landmark_counts()
    assert len(node2.dbm.host_record().packets) == N_SAVE
    np.testing.assert_allclose(node.optimized_trajectory(),
                               jnode.optimized_trajectory(), atol=POSE_TOL)

    for kf in log.keyframes[N_SAVE:]:
        for n in (node, node2, jnode):
            n.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    np.testing.assert_array_equal(node2.optimized_trajectory(),
                                  node.optimized_trajectory())
    assert node2.landmark_counts() == node.landmark_counts() == \
        jnode.landmark_counts()
    np.testing.assert_allclose(node2.optimized_trajectory(),
                               jnode.optimized_trajectory(), atol=POSE_TOL)


def test_jax_checkpoint_loads_into_port(tmp_path, log):
    """A JAX save_node restored by the port's load_node: the state bit for
    bit, then 6 more keyframes on both sides."""
    jcfg, cfg = _cfgs()
    jnode = JSlamNode(jcfg, robot_id=0)
    _feed(jnode, log, 0, N_SAVE)
    ckpt = str(tmp_path / "jax")
    jckpt.save_node(ckpt, jnode)
    node = tckpt.load_node(ckpt, cfg, device="cpu")
    assert node.device.type == "cpu"
    _assert_state_equal(node.state, jnode.state)
    _assert_host_equal(node, jnode)
    assert node._xyz_hist and node._kf_since_refresh == 0
    _feed(node, log, N_SAVE, N_SAVE + 6)
    _feed(jnode, log, N_SAVE, N_SAVE + 6)
    assert node.landmark_counts() == jnode.landmark_counts()
    np.testing.assert_allclose(node.optimized_trajectory(),
                               jnode.optimized_trajectory(), atol=POSE_TOL)


def test_port_checkpoint_loads_into_jax(tmp_path, log):
    """A port save_node restored by the JAX load_node (which reads the two
    files of its own format and ignores runtime.json)."""
    jcfg, cfg = _cfgs()
    node = SlamNode(cfg, robot_id=0, device="cpu")
    _feed(node, log, 0, N_SAVE)
    ckpt = str(tmp_path / "port")
    tckpt.save_node(ckpt, node)
    with open(os.path.join(ckpt, "node.json")) as f:
        keys = sorted(json.load(f))
    jref = str(tmp_path / "jax_ref")
    jnode_ref = JSlamNode(jcfg, robot_id=0)
    _feed(jnode_ref, log, 0, 1)
    jckpt.save_node(jref, jnode_ref)
    with open(os.path.join(jref, "node.json")) as f:
        assert keys == sorted(json.load(f))
    with np.load(os.path.join(ckpt, "graph.npz")) as z, \
            np.load(os.path.join(jref, "graph.npz")) as zj:
        assert list(z.keys()) == list(zj.keys())
        assert [z[k].dtype for k in z.keys()] == \
            [zj[k].dtype for k in zj.keys()]
    jnode = jckpt.load_node(ckpt, jcfg)
    _assert_state_equal(node.state, jnode.state)
    _assert_host_equal(jnode, node)
    _feed(node, log, N_SAVE, N_SAVE + 6)
    _feed(jnode, log, N_SAVE, N_SAVE + 6)
    assert node.landmark_counts() == jnode.landmark_counts()
    np.testing.assert_allclose(node.optimized_trajectory(),
                               jnode.optimized_trajectory(), atol=POSE_TOL)


def test_restore_keeps_the_runtime_counters(tmp_path, log):
    """The mirrors that the JAX format has no key for (runtime.json): a full
    solve every 4 keyframes and a buffered sighting across the restore give
    the restored node the uninterrupted node's next keyframes bit for bit;
    without runtime.json the counters start afresh, as in the JAX node."""
    _, cfg = _cfgs()
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 full_solve_every=4))
    node = SlamNode(cfg, robot_id=0, device="cpu")
    _feed(node, log, 0, N_SAVE - 1)
    node.add_relative_measurement(RelativeMeas(
        stamp=5.0, relative_pose=np.array([1, 0, 0, 0, 1, 2, 3], np.float32),
        robot_index=1, odom_pose=np.eye(1, 7, dtype=np.float32)[0]))
    assert node.process_relative_factors() == 0
    assert node.feasible_relative_meas and node._kf_since_full_solve == 1
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_node(ckpt, node)
    restored = tckpt.load_node(ckpt, cfg, device="cpu")
    assert _port_mirrors(restored) == _port_mirrors(node)
    os.remove(os.path.join(ckpt, "runtime.json"))
    fresh = tckpt.load_node(ckpt, cfg, device="cpu")
    assert (fresh._kf_since_full_solve, fresh._kf_since_refresh,
            fresh.feasible_relative_meas) == (0, 0, [])
    _assert_state_equal(fresh.state, node.state)
    for n in (node, restored, fresh):
        _feed(n, log, N_SAVE - 1, N_SAVE + 2)
    np.testing.assert_array_equal(restored.optimized_trajectory(),
                                  node.optimized_trajectory())
    assert _port_mirrors(restored) == _port_mirrors(node)
    # the afresh node's full solve comes a keyframe later
    assert fresh._kf_since_full_solve != node._kf_since_full_solve

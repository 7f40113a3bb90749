"""The indoor two-robot RGBD team (indoor_rgbd_team.py, the slice as a whole)
through both packages on the CPU, at the SMALL camera (160 x 120) for 20
keyframes: the same frames and tag images go through each package's
OpenVocabFrontend, ApriltagMeasurer and SlamNodes, with database exchanges,
peer replay and relative factors; robot 1 is also saved and restored
mid-run by the port's checkpoint module.

Tolerances: labelled clouds' integers identical and xyz within 1e-6 m;
instance measurements identical in count and order; sightings (RelativeMeas)
identical; relative-factor and landmark counts identical; trajectories
within 1e-3 m. The restored port run equals the uninterrupted one bit for
bit (the CPU sums in a fixed order).
"""
import numpy as np
import pytest
import torch

import indoor_rgbd_team as team
from slide_slam_tpu import config as jconfig
from slide_slam_tpu.frontend import apriltag as jat
from slide_slam_tpu.frontend import open_vocab as jov
from slide_slam_tpu.frontend.tag36h11 import tag36h11_family as jfamily
from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.frontend import apriltag as tat
from slide_slam_tpu_torch.frontend import open_vocab as tov
from slide_slam_tpu_torch.frontend import rgbd as trgbd
from slide_slam_tpu_torch.frontend.tag36h11 import tag36h11_family
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import checkpoint, synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode
from slide_slam_tpu_torch.runtime.scheduler import RelativeMeas

from _torch_parity import one_torch_thread  # noqa: F401

N_KF = 20
RESTART_AT = 10
POSE_TOL = 1e-3
XYZ_TOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def scene():
    sc = team.make_scene(synthetic, se3np, n_keyframes=N_KF, cam=team.SMALL)
    return team.render_scene(se3np, sc, tag36h11_family())


def _frontend(ov, scene, **kw):
    c = scene.cam
    return ov.OpenVocabFrontend(
        team.scripted_detector(ov, scene.world, synthetic),
        ov.parse_class_info(team.class_yaml(synthetic)), c.fx, c.fy, c.cx,
        c.cy, **kw)


def _run(scene, package, tmp_path=None):
    if package == "jax":
        cfg = team.indoor_cfg(jconfig)
        return team.run_team(
            scene, lambda: _frontend(jov, scene),
            lambda r: JSlamNode(cfg, r, prior_tf_known=True),
            jat.ApriltagMeasurer(jfamily(), scene.cam.matrix(),
                                 team.TAG_SIZE_M,
                                 se3np.matrix(scene.bot_to_cam),
                                 team.tag_config(scene), host_robot_id=1),
            n_keyframes=N_KF,
            host_cloud=lambda c: trgbd.LabeledCloud(*map(np.asarray, c)))
    cfg = team.indoor_cfg(tconfig)

    def restart(node):
        path = str(tmp_path / "robot1")
        checkpoint.save_node(path, node)
        new = checkpoint.load_node(path, cfg, device="cpu")
        for f in node.state._fields:
            a, b = getattr(new.state, f), getattr(node.state, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        for key in ("key_stamps", "_kf_since_refresh", "_kf_since_full_solve",
                    "_peer_pose_count", "num_rel_factors"):
            assert getattr(new, key) == getattr(node, key), key
        for key in ("key_poses", "_xyz_hist"):
            np.testing.assert_array_equal(np.stack(getattr(new, key)),
                                          np.stack(getattr(node, key)))
        return {"saved": node, "node": new}

    return team.run_team(
        scene, lambda: _frontend(tov, scene, device="cpu"),
        lambda r: SlamNode(cfg, r, prior_tf_known=True, device="cpu"),
        tat.ApriltagMeasurer(tag36h11_family(), scene.cam.matrix(),
                             team.TAG_SIZE_M, se3np.matrix(scene.bot_to_cam),
                             team.tag_config(scene), host_robot_id=1),
        n_keyframes=N_KF, host_cloud=trgbd.host_cloud,
        restart_at=RESTART_AT if tmp_path is not None else None,
        restart=restart)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    return {"jax": _run(scene, "jax"), "port": _run(scene, "port"),
            "restart": _run(scene, "port", tmp_path_factory.mktemp("ckpt"))}


def test_team_frontend_matches_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert len(port.clouds) == len(jax.clouds) == 2 * N_KF
    for (r, i, got), (rj, ij, want) in zip(port.clouds, jax.clouds):
        assert (r, i) == (rj, ij)
        for key in ("label", "instance", "valid"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(want, key))
        np.testing.assert_allclose(got.xyz, want.xyz, atol=XYZ_TOL, rtol=0)
    n_meas = 0
    for (r, i, got), (_, _, want) in zip(port.measurements, jax.measurements):
        assert [(c, conf) for _, _, c, conf in got] == \
            [(c, conf) for _, _, c, conf in want], (r, i)
        for (p, m, _, _), (pj, mj, _, _) in zip(got, want):
            np.testing.assert_array_equal(m, mj)
            np.testing.assert_allclose(p, pj, atol=XYZ_TOL, rtol=0)
        n_meas += len(got)
    assert n_meas > N_KF


def test_team_backend_matches_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert [i for i, _ in port.sightings] == [i for i, _ in jax.sightings]
    assert port.sightings
    for (_, m), (_, mj) in zip(port.sightings, jax.sightings):
        assert type(m) is RelativeMeas
        assert (m.stamp, m.robot_index) == (mj.stamp, mj.robot_index)
        np.testing.assert_array_equal(m.relative_pose, mj.relative_pose)
    assert [n.num_rel_factors for n in port.nodes] == \
        [n.num_rel_factors for n in jax.nodes]
    assert port.nodes[1].num_rel_factors > 0
    for n, j in zip(port.nodes, jax.nodes):
        assert n.landmark_counts() == j.landmark_counts()
        assert n.overflow_report() == j.overflow_report()
        for rid in range(2):
            np.testing.assert_allclose(
                n.trajectory_of(rid), np.asarray(j.trajectory_of(rid)),
                atol=POSE_TOL, rtol=0)


def test_team_restart_equals_uninterrupted(runs):
    """Robot 1 saved, dropped and restored after keyframe 10: its state and
    mirrors were restored exactly, and the rest of the run is the
    uninterrupted run's, bit for bit."""
    port, restarted = runs["port"], runs["restart"]
    saved, node = restarted.restart["saved"], restarted.restart["node"]
    assert node is not saved and node.robot_id == 1
    for a, b in zip(port.nodes, restarted.nodes):
        assert a.landmark_counts() == b.landmark_counts()
        assert a.num_rel_factors == b.num_rel_factors
        assert a.key_stamps == b.key_stamps
        for rid in range(2):
            np.testing.assert_array_equal(a.trajectory_of(rid),
                                          b.trajectory_of(rid))
        np.testing.assert_array_equal(np.stack(a.key_poses),
                                      np.stack(b.key_poses))

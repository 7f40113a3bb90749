"""The indoor-LiDAR pipeline: the port (on the CPU, with the JAX package's
RANSAC draws) vs the JAX package, on the scenes of tests/test_lidar_indoor.py.

Every scan's body-frame centroid measurements agree: labels and counts
identical, poses and scales within 1e-4 (f32 sums in another order), the
tracks (ids, ages, expiry) identical; the JAX tests' own assertions hold
for the port.
"""
import numpy as np
import pytest

from slide_slam_tpu.frontend import lidar_indoor as jindoor
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.frontend import lidar_indoor as tindoor
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import jax_ransac_draws
from _torch_parity import one_torch_thread  # noqa: F401
from test_lidar_indoor import (CHAIR, CHAIR_RAW, FLOOR_RAW, TABLE,
                               box_points, make_scan)

TOL = 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pipes(**cfg):
    return (jindoor.IndoorLidarPipeline(jindoor.IndoorLidarConfig(**cfg)),
            tindoor.IndoorLidarPipeline(tindoor.IndoorLidarConfig(**cfg),
                                        device="cpu",
                                        ransac_draws=jax_ransac_draws))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    if want:
        np.testing.assert_array_equal(got["ell_label"], want["ell_label"])
        for key in ("ell_pose", "ell_scale"):
            np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0,
                                       err_msg=key)


def _assert_tracks(tp, jp):
    assert [(t.track_idx, t.class_label, t.age, t.last_update_scan_idx)
            for t in tp.tracker.tracks] == \
        [(t.track_idx, t.class_label, t.age, t.last_update_scan_idx)
         for t in jp.tracker.tracks]
    np.testing.assert_allclose(tp.ground_plane, jp.ground_plane, atol=1e-6)


@pytest.fixture(scope="module")
def indoor_run():
    """Five scans of floor + 2 chairs + 1 table through both pipelines."""
    rng = np.random.default_rng(3)
    jp, tp = _pipes()
    pose = np.asarray(se3np.from_xyz_yaw(0.0, 0.0, 0.6, 0.0), np.float32)
    per_scan = []
    for _ in range(5):
        xyz, labels = make_scan(rng, pose[4:7])
        per_scan.append((tp.process_scan(xyz, labels, pose),
                         jp.process_scan(xyz, labels, pose)))
    return jp, tp, pose, per_scan


def test_scans_match_jax(indoor_run):
    jp, tp, _, per_scan = indoor_run
    for got, want in per_scan:
        _assert_same(got, want)
    _assert_tracks(tp, jp)
    assert [len(g.get("ell_label", [])) for g, _ in per_scan][-1] == 3


def test_emits_centroid_measurements_with_unified_labels(indoor_run):
    _, _, pose, per_scan = indoor_run
    obs = per_scan[-1][0]
    labs = obs["ell_label"]
    assert (labs == CHAIR).sum() == 2 and (labs == TABLE).sum() == 1
    world = {tuple(np.round(c, 1)): lab for c, lab in
             [([2.0, 1.0, 0.45], CHAIR), ([4.0, -2.0, 0.45], CHAIR),
              ([-1.5, 3.0, 0.55], TABLE)]}
    mat = se3np.matrix(pose)
    for p, lab, s in zip(obs["ell_pose"], labs, obs["ell_scale"]):
        w = (mat @ np.concatenate([p[4:7], [1.0]]))[:3]
        best = min(world, key=lambda c: np.linalg.norm(w - c))
        assert np.linalg.norm(w - np.asarray(best)) < 0.25
        assert world[best] == lab
        want = [0.5, 0.5, 0.9] if lab == CHAIR else [1.6, 0.9, 0.7]
        assert np.allclose(sorted(s), sorted(want), atol=0.25), (s, want)


def test_ground_points_do_not_become_objects():
    rng = np.random.default_rng(4)
    jp, tp = _pipes()
    pose = np.asarray(se3np.from_xyz_yaw(0, 0, 0.6, 0.0), np.float32)
    for _ in range(5):
        floor = np.column_stack([rng.uniform(-5, 5, 400),
                                 rng.uniform(-5, 5, 400),
                                 rng.normal(0, 0.01, 400)])
        low = box_points(rng, [2.0, 1.0, 0.03], [0.5, 0.5, 0.05], 200)
        xyz = np.vstack([floor, low]).astype(np.float32)
        labels = np.concatenate([np.full(400, FLOOR_RAW),
                                 np.full(200, CHAIR_RAW)])
        got = tp.process_scan(xyz, labels, pose)
        assert got == {} == jp.process_scan(xyz, labels, pose)
    _assert_tracks(tp, jp)


def test_lost_tracks_expire():
    rng = np.random.default_rng(5)
    jp, tp = _pipes(num_lost_track_times_thresh=2)
    pose = np.asarray(se3np.from_xyz_yaw(0, 0, 0.6, 0.0), np.float32)
    for _ in range(4):
        xyz, labels = make_scan(rng, pose[4:7])
        _assert_same(tp.process_scan(xyz, labels, pose),
                     jp.process_scan(xyz, labels, pose))
    assert len(tp.tracker.tracks) == 3
    counts = []
    for _ in range(4):
        floor = np.column_stack([rng.uniform(-5, 5, 400),
                                 rng.uniform(-5, 5, 400),
                                 rng.normal(0, 0.01, 400)]).astype(np.float32)
        _assert_same(tp.process_scan(floor, np.full(400, FLOOR_RAW), pose),
                     jp.process_scan(floor, np.full(400, FLOOR_RAW), pose))
        counts.append(len(tp.tracker.tracks))
        _assert_tracks(tp, jp)
    assert counts[-1] == 0


def test_backend_consumes_indoor_measurements():
    """The emitted dicts feed the port's SlamNode directly: three point
    landmarks, as in the JAX test."""
    cfg = SlamConfig(number_of_robots=1, capacity=CapacityConfig(
        max_poses_per_robot=16, max_cylinders=64, max_cuboids=32,
        max_points=32, max_scan_objects=8, max_cylinder_factors=128,
        max_cuboid_factors=64, max_point_factors=64, max_between_factors=8))
    node = SlamNode(cfg, 0, device="cpu")
    rng = np.random.default_rng(6)
    _, tp = _pipes()
    for k in range(5):
        pose = np.asarray(se3np.from_xyz_yaw(0.6 * k, 0.0, 0.6, 0.0),
                          np.float32)
        xyz, labels = make_scan(rng, pose[4:7])
        node.process_keyframe(1000.0 + 0.5 * k, pose,
                              tp.process_scan(xyz, labels, pose))
    assert node.landmark_counts()["points"] == 3

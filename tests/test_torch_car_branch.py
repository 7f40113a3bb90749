"""The car branch: the port (on the CPU) vs the JAX package.

Bbox seeds (exact: min/max and one f32 mean), the hull vertex mask, the PCA
cuboid fit in each of its modes, the yaw snapping (the JAX package with
sklearn's KMeans against the port's exact 1-D 2-means), the tracker, and
ProcessCloudPipeline.process_scan with cars on the scenes of the JAX
package's frontend tests (outdoor default config and the KITTI preset).
Integer outputs (valid flags, labels, track ids, counts) are identical;
fitted values agree to 1e-4 (masked percentiles interpolate, and the f32
sums over 512 points add, in another order); snapped yaws to 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.frontend import cuboid_fit as jfit
from slide_slam_tpu.frontend import pipeline as jpipe
from slide_slam_tpu.frontend import tracker as jtrack
from slide_slam_tpu_torch.frontend import cuboid_fit as tfit
from slide_slam_tpu_torch.frontend import pipeline as tpipe
from slide_slam_tpu_torch.frontend import tracker as ttrack
from slide_slam_tpu_torch.io.synthetic import (synth_box_points,
                                               synth_tree_points)

from _torch_parity import jax_ransac_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
YAW_TOL = 1e-6


def _boxes(rng, I=6, P=512):
    """Yawed boxes of car and clutter sizes, padded to P, one below the
    point gate, one with a dense interior blob."""
    pts = np.zeros((I, P, 3), np.float32)
    mask = np.zeros((I, P), bool)
    for i in range(I):
        n = [400, 250, 3, 512, 120, 300][i % 6]
        dims = [rng.uniform(3.5, 5.0), rng.uniform(1.5, 2.1),
                rng.uniform(1.3, 1.8)]
        c = [*rng.uniform(-30, 30, 2), 0.8]
        p = synth_box_points(rng, c, dims, rng.uniform(-np.pi, np.pi), n)
        if i == 5:
            p[:150, :2] = c[:2] + rng.normal(0, 0.2, (150, 2))
        pts[i, :n] = p
        mask[i, :n] = True
    lo = np.tile(np.float32([2.0, 1.0, 0.8]), (I, 1))
    hi = np.tile(np.float32([7.0, 3.0, 2.5]), (I, 1))
    return pts, mask, lo, hi


def test_fit_bbox_seeds():
    pts, mask, _, _ = _boxes(np.random.default_rng(0))
    mask[2] = False                        # an empty instance
    want = jfit.fit_bbox_seeds(jnp.asarray(pts), jnp.asarray(mask), 0.3)
    got = tfit.fit_bbox_seeds(torch.as_tensor(pts), torch.as_tensor(mask),
                              0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 8])
def test_hull_vertex_mask(seed):
    rng = np.random.default_rng(seed)
    pts, mask, _, _ = _boxes(rng)
    blob = np.zeros((1, 512, 3), np.float32)
    blob[0, :256, :2] = rng.normal(0, 1, (256, 2))
    bmask = np.zeros((1, 512), bool)
    bmask[0, :256] = True
    pts, mask = np.concatenate([pts, blob]), np.concatenate([mask, bmask])
    want = np.asarray(jfit._hull_vertex_mask(jnp.asarray(pts),
                                             jnp.asarray(mask)))
    got = tfit._hull_vertex_mask(torch.as_tensor(pts),
                                 torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 3 <= got[-1].sum() <= tfit.N_HULL_DIRS


@pytest.mark.parametrize("mode", [
    dict(), dict(use_convex=False), dict(minmax_extents=True),
    dict(estimate_facing_dir=True)], ids=["default", "no_hull", "minmax",
                                           "facing"])
def test_fit_cuboids(mode):
    pts, mask, lo, hi = _boxes(np.random.default_rng(1))
    want = jfit.fit_cuboids(*(jnp.asarray(a) for a in (pts, mask, lo, hi)),
                            **mode)
    got = tfit.fit_cuboids(*(torch.as_tensor(a) for a in (pts, mask, lo, hi)),
                           **mode)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 3 <= got.valid.numpy().sum() < len(pts)
    for name in ("centroid", "dims", "yaw"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=0, err_msg=name)


def _yaw_sets():
    rng = np.random.default_rng(9)
    sets = {
        "two_orthogonal": np.concatenate([0.3 + rng.normal(0, 0.05, 12),
                                          0.3 + np.pi / 2
                                          + rng.normal(0, 0.05, 5)]),
        "small_n": np.array([0.3, 1.2]),
        "merged": 0.4 + np.random.default_rng(10).normal(0, 0.03, 10),
    }
    r = np.random.default_rng(11)
    for k in range(5):
        n_a, n_b = int(r.integers(3, 12)), int(r.integers(1, 3))
        a, b = r.uniform(-np.pi, np.pi, 2)
        y = np.concatenate([a + r.normal(0, 0.08, n_a),
                            b + r.normal(0, 0.08, n_b)])
        sets[f"random_{k}"] = (y + np.pi) % (2 * np.pi) - np.pi
    return sets


@pytest.mark.parametrize("name", list(_yaw_sets()))
def test_cluster_cuboid_orientation_matches_kmeans(name):
    """The JAX function runs sklearn's KMeans(2, n_init=10) here; the port
    its exact 1-D 2-means. Unequal clusters: the same snapped yaws."""
    pytest.importorskip("sklearn")
    yaws = _yaw_sets()[name]
    want = jfit.cluster_cuboid_orientation(yaws)
    got = tfit.cluster_cuboid_orientation(yaws)
    np.testing.assert_allclose(got, want, atol=YAW_TOL, rtol=0)


def _run_trackers(expire_after=None):
    rng = np.random.default_rng(5)
    out = []
    for mod in (jtrack, ttrack):
        tr = mod.MultiClassTracker({5: 2.0, 1: 1.5}, downsample_res=0.3)
        r = np.random.default_rng(5)
        for scan in range(6):
            for label in (5, 1):
                k = int(r.integers(1, 4))
                dets = np.column_stack([r.uniform(-3, 3, (k, 2)) * (scan % 3),
                                        r.uniform(1, 5, (k, 2))])
                raw = [r.normal(0, 1, (int(r.integers(20, 80)), 3))
                       for _ in range(k)]
                tr.update(label, dets, raw, scan)
            if expire_after is not None:
                tr.expire(scan, expire_after)
        out.append(tr)
    del rng
    return out


@pytest.mark.parametrize("expire_after", [None, 1])
def test_tracker_matches_jax(expire_after):
    jt, tt = _run_trackers(expire_after)
    assert len(tt.tracks) == len(jt.tracks) > 0
    for a, b in zip(tt.tracks, jt.tracks):
        assert (a.track_idx, a.class_label, a.age, a.last_update_scan_idx) \
            == (b.track_idx, b.class_label, b.age, b.last_update_scan_idx)
        for f in ("x", "y", "l", "w"):
            assert getattr(a, f) == getattr(b, f)
        np.testing.assert_array_equal(a.all_raw_points, b.all_raw_points)
        np.testing.assert_array_equal(a.xy_cov, b.xy_cov)
    ages = {5: 2, 1: 3}
    assert [t.track_idx for t in tt.aged_tracks(ages)] == \
        [t.track_idx for t in jt.aged_tracks(ages)]


def test_hungarian_and_voxels():
    cost = np.array([[0.1, 5.0], [5.0, 0.2], [9.0, 9.0]])
    assert ttrack.hungarian_assignment(cost, 2.0) == \
        jtrack.hungarian_assignment(cost, 2.0)
    pts = np.random.default_rng(0).normal(0, 1, (200, 3))
    np.testing.assert_array_equal(ttrack.voxel_downsample(pts, 0.3),
                                  jtrack.voxel_downsample(pts, 0.3))


def _car_scene(rng, kitti=False):
    """One scan of the JAX package's pipeline test scenes: ground, one car,
    trees (KITTI: dense car and tree, KITTI ids)."""
    pts, labs = [], []
    g_xy = rng.uniform(-15, 15, (300, 2))
    pts.append(np.column_stack([g_xy, np.zeros(300)]))
    if kitti:
        labs.append(np.full(300, 40))
        pts.append(synth_box_points(rng, [8.0, 2.0, 0.75], [2.0, 1.0, 0.8],
                                    0.4, 4000))
        labs.append(np.full(4000, 10))
        pts.append(synth_tree_points(rng, [4.0, -4.0, 0.0], 0.3, n=2000))
        labs.append(np.full(2000, 71))
    else:
        labs.append(np.full(300, 1))
        pts.append(synth_box_points(rng, [8.0, 2.0, 0.75], [4.4, 1.8, 1.5],
                                    0.4, 400))
        labs.append(np.full(400, 5))
        for tr in ([4.0, -4.0, 0.0], [12.0, 6.0, 0.0]):
            pts.append(synth_tree_points(rng, tr, 0.3, n=200))
            labs.append(np.full(200, 8))
    return np.concatenate(pts).astype(np.float32), np.concatenate(labs)


def assert_obs_equal(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for key in ("cyl_label", "cub_label"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("cyl_root", "cyl_ray", "cyl_radius", "cub_pose",
                "cub_scale"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                       err_msg=key)


@pytest.mark.parametrize("preset", ["outdoor", "kitti"])
def test_pipeline_scenes_match_jax(preset):
    """Four scans of the test scene through both pipelines (the port with
    the JAX package's RANSAC draws): every scan's measurements equal, cars
    emitted from the third scan on (track age gate 2)."""
    pose = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    kitti = preset == "kitti"
    if kitti:
        jcfg = dataclasses.replace(jpipe.kitti_pipeline_config(),
                                   max_points_per_class=4096)
        tcfg = dataclasses.replace(tpipe.kitti_pipeline_config(),
                                   max_points_per_class=4096)
        assert tcfg == dataclasses.replace(tcfg, classes=[
            tpipe.ClassSpec(**vars(c)) for c in jcfg.classes])
    else:
        jcfg, tcfg = jpipe.PipelineConfig(), tpipe.PipelineConfig()
    jp = jpipe.ProcessCloudPipeline(jcfg)
    tp = tpipe.ProcessCloudPipeline(tcfg, device="cpu",
                                    ransac_draws=jax_ransac_draws)
    rng = np.random.default_rng(9 if kitti else 7)
    n_cub = []
    for scan in range(4):
        xyz, lab = _car_scene(rng, kitti)
        want = jp.process_scan(xyz, lab, pose)
        got = tp.process_scan(xyz, lab, pose)
        assert_obs_equal(got, want)
        n_cub.append(len(got.get("cub_label", [])))
    assert n_cub[0] == 0 and n_cub[-1] >= 1
    assert [t.track_idx for t in tp.tracker.tracks] == \
        [t.track_idx for t in jp.tracker.tracks]

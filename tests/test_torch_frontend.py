"""Frontend pieces: the port (on the CPU) vs the JAX package.

Range projection with forced depth ties (exact: the same pixel must keep the
same point), the RANSAC ground fit fed the JAX package's own draws, the
batched cylinder fit, and one ProcessCloudPipeline.process_scan on a
simulated forest scan. Fitted values agree to 1e-4 (3x3 eigen-solves and
covariance sums round differently in the two frameworks); counts, masks,
labels and pixel indices are identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.frontend import cylinder_fit as jfit
from slide_slam_tpu.frontend import pipeline as jpipe
from slide_slam_tpu.frontend import range_projection as jrp
from slide_slam_tpu_torch.frontend import cylinder_fit as tfit
from slide_slam_tpu_torch.frontend import pipeline as tpipe
from slide_slam_tpu_torch.frontend import range_projection as trp
from slide_slam_tpu_torch.frontend.lidar_pipeline import _nearest_object_label
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic

from _torch_parity import forest_scene, jax_ransac_draws

TOL = 1e-4


def _cloud_with_ties(rng, n=600):
    """Points whose pixels collide: every third point is an exact copy of an
    earlier one (same depth, same pixel) with another remission, so which
    point a pixel keeps is visible; some rows are invalid."""
    pts = rng.normal(0, 8, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    src = rng.integers(0, n // 2, n // 3)
    pts[-len(src):] = pts[src]
    rem = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return pts, rem, valid


@pytest.mark.parametrize("hw", [(16, 64), (32, 512)])
def test_range_projection_depth_ties(hw):
    h, w = hw
    pts, rem, valid = _cloud_with_ties(np.random.default_rng(h))
    want = jrp.project(jnp.asarray(pts), jnp.asarray(rem), jnp.asarray(valid),
                       height=h, width=w)
    got = trp.project(torch.as_tensor(pts), torch.as_tensor(rem),
                      torch.as_tensor(valid), height=h, width=w)
    for name in trp.RangeImage._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the collisions are real: some pixel had several candidates
    flat = (got.proj_y.long() * w + got.proj_x.long())[torch.as_tensor(valid)]
    assert len(torch.unique(flat)) < len(flat)


def _ground_patches(rng, I=6, G=200):
    """Tilted noisy planes with outliers, sparse masks per row."""
    pts = np.zeros((I, G, 3), np.float32)
    for i in range(I):
        xy = rng.uniform(-2, 2, (G, 2))
        a, b = rng.normal(0, 0.05, 2)
        z = a * xy[:, 0] + b * xy[:, 1] + rng.normal(0, 0.02, G)
        out = rng.uniform(size=G) < 0.2
        z[out] += rng.uniform(0.3, 2.0, out.sum())
        pts[i] = np.column_stack([xy, z])
    mask = rng.uniform(size=(I, G)) < 0.6
    mask[-1, 2:] = False           # a row with too few points
    return pts, mask


def test_fit_plane_ransac_with_jax_draws():
    pts, mask = _ground_patches(np.random.default_rng(0))
    I = pts.shape[0]
    jn, jd, jc = jfit.fit_plane_ransac(jnp.asarray(pts), jnp.asarray(mask),
                                       thresh=0.1)
    tn, td, tc = tfit.fit_plane_ransac(
        torch.as_tensor(pts), torch.as_tensor(mask), thresh=0.1,
        draws=torch.as_tensor(jax_ransac_draws(I, 64)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=TOL, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL, rtol=0)


def _trunks(rng, I=5, P=128):
    pts = np.zeros((I, P, 3), np.float32)
    mask = np.zeros((I, P), bool)
    for i in range(I):
        n = [P, 90, 60, 8, 40][i]                  # one too small to fit
        c = rng.uniform(-10, 10, 2)
        r = rng.uniform(0.15, 0.45)
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(0.1, 4.0, n)
        tilt = rng.normal(0, 0.05, 2)
        pts[i, :n] = np.column_stack([c[0] + r * np.cos(th) + tilt[0] * z,
                                      c[1] + r * np.sin(th) + tilt[1] * z, z])
        mask[i, :n] = True
    normal = np.tile([[0.0, 0.0, 1.0]], (I, 1)).astype(np.float32)
    normal[1] = [0.02, -0.01, 1.0]
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = rng.uniform(-0.1, 0.1, I).astype(np.float32)
    return pts, mask, normal.astype(np.float32), d


def test_fit_cylinders():
    pts, mask, normal, d = _trunks(np.random.default_rng(1))
    want = jfit.fit_cylinders(*(jnp.asarray(a) for a in (pts, mask, normal,
                                                          d)))
    got = tfit.fit_cylinders(*(torch.as_tensor(a) for a in (pts, mask, normal,
                                                             d)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.numpy().sum() >= 3
    for name in ("root", "ray", "radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=TOL,
                                   rtol=0, err_msg=name)


def test_select_ground_patches():
    rng = np.random.default_rng(2)
    g = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    gv = rng.uniform(size=300) > 0.3
    cens = rng.uniform(-8, 8, (7, 3)).astype(np.float32)
    want = jfit.select_ground_patches(jnp.asarray(g), jnp.asarray(gv),
                                      jnp.asarray(cens), 4.0)
    got = tfit.select_ground_patches(torch.as_tensor(g), torch.as_tensor(gv),
                                     torch.as_tensor(cens), 4.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_process_scan_matches_jax():
    world, traj, odom = forest_scene()
    k = 5
    scan = synthetic.simulate_lidar_scan(world, traj[k],
                                         np.random.default_rng(5))
    labels = _nearest_object_label(world, se3np.apply(traj[k], scan))
    xyz = se3np.apply(odom[k], scan)
    jcfg = jpipe.PipelineConfig(
        classes=[c for c in jpipe.outdoor_classes() if c.model != "cuboid"],
        max_range=22.0)
    want = jpipe.ProcessCloudPipeline(jcfg).process_scan(xyz, labels, odom[k])
    tcfg = tpipe.PipelineConfig(classes=tpipe.forest_classes(),
                                max_range=22.0)
    got = tpipe.ProcessCloudPipeline(
        tcfg, device="cpu", ransac_draws=jax_ransac_draws).process_scan(
            xyz, labels, odom[k])
    assert sorted(got) == sorted(want)
    assert len(got["cyl_label"]) >= 3
    np.testing.assert_array_equal(got["cyl_label"], want["cyl_label"])
    for key in ("cyl_root", "cyl_ray", "cyl_radius"):
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0,
                                   err_msg=key)


def test_cuboid_class_is_refused():
    with pytest.raises(NotImplementedError, match="car branch"):
        tpipe.ProcessCloudPipeline(tpipe.PipelineConfig(), device="cpu")

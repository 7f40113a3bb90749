"""The port's RGBD backprojection and open-vocabulary frontend (PyTorch, on
the CPU) against the JAX package, on the cases of tests/test_indoor_rgbd.py
and tests/test_open_vocab.py and on seeded random frames.

Tolerances: label, instance and valid identical; confidences identical
(the same f32 values picked); xyz within one f32 ulp of the depth (the same
f32 operations in the same order, (u - cx) / fx * z; the world transform
within 1e-6 m); instance measurements identical in count, order, class and
mask, points within 1e-6 m. Backend runs against the JAX SlamNode: landmark
counts identical, poses and landmarks within 1e-3 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.frontend import open_vocab as jov
from slide_slam_tpu.frontend import rgbd as jrgbd
from slide_slam_tpu.geometry import se3np as jse3np
from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.frontend import open_vocab as tov
from slide_slam_tpu_torch.frontend import rgbd as trgbd
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import one_torch_thread  # noqa: F401
from test_indoor_rgbd import indoor_cfg as jindoor_cfg, indoor_world
from test_open_vocab import CLS_YAML

POSE_TOL = 1e-3
XYZ_TOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_cfg():
    """tests/test_indoor_rgbd.py's indoor_cfg, in the port's config."""
    c = jindoor_cfg()
    cap = {k: getattr(c.capacity, k) for k in c.capacity.__dataclass_fields__}
    return tconfig.SlamConfig(number_of_robots=2, ellipsoid_match_thresh=0.75,
                              capacity=tconfig.CapacityConfig(**cap))


def _assert_same_cloud(got, want, xyz_tol=None):
    got = trgbd.host_cloud(got)
    want = trgbd.LabeledCloud(*(np.asarray(x) for x in want))
    for key in ("label", "instance", "valid"):
        assert getattr(got, key).dtype == getattr(want, key).dtype, key
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    np.testing.assert_array_equal(got.confidence, want.confidence)
    if xyz_tol is None:
        # one f32 ulp of each point's depth
        ulp = np.spacing(np.abs(want.xyz[:, 2:3]).astype(np.float32))
        assert np.all(np.abs(got.xyz - want.xyz) <= ulp)
    else:
        np.testing.assert_allclose(got.xyz, want.xyz, atol=xyz_tol, rtol=0)


def _assert_same_meas(got, want):
    assert [(c, conf) for _, _, c, conf in got] == \
        [(c, conf) for _, _, c, conf in want]
    for (p, m, _, _), (pj, mj, _, _) in zip(got, want):
        np.testing.assert_array_equal(m, mj)
        np.testing.assert_allclose(p, pj, atol=XYZ_TOL, rtol=0)


def _backproject_both(depth, masks, labels, conf, *intr, **kw):
    got = trgbd.backproject(torch.as_tensor(depth), torch.as_tensor(masks),
                            torch.as_tensor(labels), torch.as_tensor(conf),
                            *intr, **kw)
    want = jrgbd.backproject(jnp.asarray(depth), jnp.asarray(masks),
                             jnp.asarray(labels), jnp.asarray(conf),
                             *intr, **kw)
    _assert_same_cloud(got, want)
    return got, want


def _frontends(detector, **kw):
    classes = CLS_YAML
    return (jov.OpenVocabFrontend(detect_fn=detector,
                                  classes=jov.parse_class_info(classes),
                                  fx=200.0, fy=200.0, cx=80.0, cy=60.0,
                                  depth_scale=1.0, **kw),
            tov.OpenVocabFrontend(detect_fn=detector,
                                  classes=tov.parse_class_info(classes),
                                  fx=200.0, fy=200.0, cx=80.0, cy=60.0,
                                  depth_scale=1.0, device="cpu", **kw))


# ---------------------------------------------------------------------------
# tests/test_indoor_rgbd.py
# ---------------------------------------------------------------------------

def test_indoor_centroid_slam():
    rng = np.random.default_rng(9)
    world = indoor_world(rng)
    traj = synthetic.lawnmower_trajectory(50, extent=7.0, rows=3, step=0.8)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.008,
                             pos_noise=0.02, dropout=0.1, max_range=6.0,
                             seed=2)
    node = SlamNode(_port_cfg(), robot_id=0, device="cpu")
    jnode = JSlamNode(jindoor_cfg(), robot_id=0)
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        jnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    counts = node.landmark_counts()
    assert counts == jnode.landmark_counts()
    assert counts["points"] >= 10, counts
    assert counts["points"] <= 22 + 6
    est_pts = node.state.pt_pos[:counts["points"]].numpy()
    np.testing.assert_allclose(
        est_pts, np.asarray(jnode.state.pt_pos)[:counts["points"]],
        atol=POSE_TOL, rtol=0)
    errs = [np.linalg.norm(world.ell_pos - p, axis=1).min() for p in est_pts]
    assert np.median(errs) < 0.25, np.median(errs)
    est = node.optimized_trajectory()
    np.testing.assert_allclose(est, jnode.optimized_trajectory(),
                               atol=POSE_TOL, rtol=0)
    odom = np.stack([kf.odom_pose for kf in log.keyframes])
    assert (synthetic.ate_rmse(est, traj[:len(est)], align=False)
            < synthetic.ate_rmse(odom, traj, align=False))


def test_rgbd_frontend_to_backend():
    H, W = 48, 64
    fx = fy = 40.0
    depth = np.full((H, W), 2.0, np.float32)
    masks = np.zeros((1, H, W), bool)
    masks[0, 16:32, 24:40] = True
    cloud, jcloud = _backproject_both(
        depth, masks, np.array([synthetic.CHAIR], np.int32),
        np.array([0.9], np.float32), fx, fy, W / 2, H / 2)
    pts, mask = trgbd.instance_points(cloud, 0, 512)
    pj, mj = jrgbd.instance_points(jcloud, 0, 512)
    np.testing.assert_array_equal(mask, mj)
    np.testing.assert_array_equal(pts, pj)
    centroid = pts[mask].mean(axis=0)
    scale = pts[mask].max(axis=0) - pts[mask].min(axis=0)
    ell_pose = np.concatenate([[1, 0, 0, 0], centroid]).astype(np.float32)
    obs = {"ell_pose": ell_pose[None],
           "ell_scale": scale[None].astype(np.float32),
           "ell_label": np.array([synthetic.CHAIR], np.int32)}
    node = SlamNode(_port_cfg(), robot_id=0, device="cpu")
    jnode = JSlamNode(jindoor_cfg(), robot_id=0)
    for n, s3 in ((node, se3np), (jnode, jse3np)):
        n.process_keyframe(0.0, s3.identity(), obs)
        n.process_keyframe(0.5, s3.from_xyz_yaw(0.1, 0, 0, 0), obs)
    assert node.landmark_counts() == jnode.landmark_counts()
    assert node.landmark_counts()["points"] >= 1
    lm = node.state.pt_pos[0].numpy()
    np.testing.assert_allclose(lm, np.asarray(jnode.state.pt_pos[0]),
                               atol=POSE_TOL, rtol=0)
    assert abs(lm[2] - 2.0) < 0.3


# ---------------------------------------------------------------------------
# tests/test_open_vocab.py
# ---------------------------------------------------------------------------

def test_queries_from_class_yaml():
    fj, fe = _frontends(lambda rgb: [])
    assert fe.queries == ["chair", "table", "whiteboard"] == fj.queries
    assert fe._by_name["whiteboard"].class_id == 7
    assert tov.parse_class_info(CLS_YAML) == [
        tov.OpenVocabClassInfo(**vars(c)) for c in jov.parse_class_info(CLS_YAML)]


def test_bbox_fill_and_backprojection():
    H, W = 120, 160
    depth = np.full((H, W), 2.0, np.float32)

    def detector(rgb):
        return [jov.Detection("chair", 0.9, np.asarray([40, 30, 80, 70], float)),
                jov.Detection("table", 0.2, np.asarray([0, 0, 20, 20], float)),
                jov.Detection("unknown thing", 0.99,
                              np.asarray([100, 10, 120, 40], float))]

    fj, fe = _frontends(detector)
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = fe.process_frame(rgb, depth)
    _assert_same_cloud(cloud, fj.process_frame(rgb, depth))
    valid = cloud.valid.numpy()
    assert valid.sum() == 40 * 40
    assert np.all(cloud.label.numpy()[valid] == 1)
    xyz = cloud.xyz.numpy().reshape(H, W, 3)
    np.testing.assert_allclose(xyz[50, 60], [-0.2, -0.1, 2.0], atol=1e-5)


def test_world_transform_and_instance_gates():
    H, W = 100, 120
    depth = np.full((H, W), 3.0, np.float32)

    def detector(rgb):
        return [jov.Detection("chair", 0.8, np.asarray([30, 30, 70, 70], float)),
                jov.Detection("table", 0.8, np.asarray([90, 50, 115, 54], float))]

    fj, fe = _frontends(detector)
    R_wc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    pose = np.concatenate([se3np.quat_from_matrix(R_wc),
                           [10.0, 0.0, 0.0]]).astype(np.float32)
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = fe.process_frame(rgb, depth, cam_pose7=pose)
    jcloud = fj.process_frame(rgb, depth, cam_pose7=pose)
    _assert_same_cloud(cloud, jcloud, xyz_tol=XYZ_TOL)
    meas = fe.instance_measurements(cloud)
    _assert_same_meas(meas, fj.instance_measurements(jcloud))
    assert len(meas) == 1
    pts, mask, cls_id, conf = meas[0]
    assert cls_id == 1 and conf > 0.7
    assert abs(pts[mask][:, 0].mean() - 13.0) < 0.2


def test_mask_detections_pass_through():
    H, W = 60, 80
    depth = np.full((H, W), 1.0, np.float32)
    m = np.zeros((H, W), bool)
    m[10:30, 10:30] = True

    def detector(rgb):
        return [jov.Detection("table", 0.95, np.asarray([0, 0, 0, 0], float),
                              mask=m)]

    fj, fe = _frontends(detector)
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = fe.process_frame(rgb, depth)
    _assert_same_cloud(cloud, fj.process_frame(rgb, depth))
    assert cloud.valid.numpy().sum() == m.sum()
    assert np.all(cloud.label.numpy()[cloud.valid.numpy()] == 2)


# ---------------------------------------------------------------------------
# Seeded frames: overlapping masks, gates on the thresholds, odd boxes
# ---------------------------------------------------------------------------

def _random_frame(rng, H=37, W=53, K=6):
    depth = rng.uniform(0.0, 12.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    depth[0, :4] = [1e-3, 10.0, np.nextafter(np.float32(10.0), 0),
                    np.nextafter(np.float32(1e-3), 1)]
    masks = np.zeros((K, H, W), bool)
    for k in range(K):
        y0, x0 = rng.integers(0, H - 8), rng.integers(0, W - 8)
        masks[k, y0:y0 + rng.integers(4, 20), x0:x0 + rng.integers(4, 30)] = True
    masks[-1] |= masks[0]                 # a later mask covering an earlier
    labels = rng.integers(0, 9, K).astype(np.int32)
    conf = rng.uniform(0.0, 1.0, K).astype(np.float32)
    conf[[0, -1]] = 0.9
    conf[1] = np.float32(0.5)             # exactly at the threshold
    conf[2] = np.nextafter(np.float32(0.5), 0)
    return depth, masks, labels, conf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backproject_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth, masks, labels, conf = _random_frame(rng)
    intr = (rng.uniform(30, 60), rng.uniform(30, 60), 26.3, 18.7)
    cloud, _ = _backproject_both(depth, masks, labels, conf, *intr)
    inst = cloud.instance.numpy().reshape(depth.shape)
    assert np.all(inst[masks[0]] == 0)    # first mask wins where both set
    for kw in (dict(depth_scale=1e-3, max_depth=7.5, conf_thresh=0.35),
               dict(depth_scale=0.7, max_depth=3.0, conf_thresh=0.0)):
        _backproject_both(depth * 1000, masks, labels, conf, *intr, **kw)
    mm = (depth * 1000).astype(np.uint16)
    got = trgbd.backproject(torch.from_numpy(mm.astype(np.float32)),
                            torch.as_tensor(masks), torch.as_tensor(labels),
                            torch.as_tensor(conf), *intr, depth_scale=1e-3)
    assert got.xyz.device.type == "cpu" and got.label.dtype == torch.int32


def test_odd_boxes_clip_like_jax():
    """Negative, fractional and out-of-image boxes: Python int truncates
    toward zero, then the box clips to the image."""
    H, W = 30, 40
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 5.0, (H, W)).astype(np.float32)
    boxes = [[-3.7, -0.5, 10.9, 8.2], [35.2, 25.9, 60.0, 40.0],
             [-10.0, -10.0, -0.2, 5.0], [5.5, 5.5, 5.9, 20.0],
             [12.999, 3.001, 30.5, 29.999]]

    def detector(rgb):
        return [jov.Detection("chair" if i % 2 else "table", 0.5 + 0.1 * i,
                              np.asarray(b, float))
                for i, b in enumerate(boxes)]

    fj, fe = _frontends(detector)
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = fe.process_frame(rgb, depth)
    _assert_same_cloud(cloud, fj.process_frame(rgb, depth))
    inst = cloud.instance.numpy().reshape(H, W)
    assert np.all(inst[0:8, 0:10] == 0) and inst[8, 0] != 0
    assert np.all(inst[25:, 35:] == 1)


def test_instance_points_stride_subsample():
    rng = np.random.default_rng(5)
    depth, masks, labels, conf = _random_frame(rng, H=60, W=80, K=4)
    conf[:] = 0.9
    cloud, jcloud = _backproject_both(depth, masks, labels, conf,
                                      50.0, 50.0, 40.0, 30.0)
    for iid in range(4):
        for cap in (3, 16, 1024):
            got = trgbd.instance_points(cloud, iid, cap)
            want = jrgbd.instance_points(jcloud, iid, cap)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    fj, fe = _frontends(lambda rgb: [])
    _assert_same_meas(fe.instance_measurements(cloud, max_points=16),
                      fj.instance_measurements(jcloud, max_points=16))

"""The port's AprilTag detector, measurer and tag36h11 table (host numpy and
scipy copies) against the JAX package, on the cases of
tests/test_apriltag.py and tests/test_tag36h11.py.

Tolerances: tag ids, hamming distances, rotations, code lists and corner
quads identical (the same numpy/scipy calls in the same order); homographies,
centres and poses within 1e-9 (f64); RelativeMeas fields identical (f32).
The JAX tests' own assertions hold for the port. The port's measurer builds
the port's own scheduler.RelativeMeas.
"""
import numpy as np
import pytest

from slide_slam_tpu.frontend import apriltag as jat
from slide_slam_tpu.frontend import tag36h11 as jtag
from slide_slam_tpu_torch.frontend import apriltag as tat
from slide_slam_tpu_torch.frontend import tag36h11 as ttag
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.runtime.scheduler import RelativeMeas

from _torch_parity import one_torch_thread  # noqa: F401
from test_apriltag import _render_in_scene

F64_TOL = 1e-9

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SQUARE = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)


@pytest.fixture(scope="module")
def families():
    return (jat.generate_family(d=6, min_hamming=11, count=12, seed=42),
            tat.generate_family(d=6, min_hamming=11, count=12, seed=42))


def _assert_same_detections(got, want):
    assert [(d.tag_id, d.hamming) for d in got] == \
        [(d.tag_id, d.hamming) for d in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.corners, w.corners)
        np.testing.assert_allclose(g.center, w.center, atol=F64_TOL, rtol=0)
        np.testing.assert_allclose(g.H, w.H, atol=F64_TOL, rtol=0)
        assert (g.pose is None) == (w.pose is None)
        if w.pose is not None:
            np.testing.assert_allclose(g.pose, w.pose, atol=F64_TOL, rtol=0)


def _detect_both(families, img, **kw):
    jf, tf = families
    want = jat.detect(img, jf, **kw)
    got = tat.detect(img, tf, **kw)
    _assert_same_detections(got, want)
    return got


def _projected_homography(K, T, tagsize):
    pts = np.concatenate([SQUARE * tagsize / 2, np.zeros((4, 1)),
                          np.ones((4, 1))], 1)
    uv = (K @ (T @ pts.T)[:3]).T
    return tat._homography_4pt(SQUARE, uv[:, :2] / uv[:, 2:3])


def test_family_properties(families):
    jf, family = families
    assert family.codes == jf.codes and len(family.codes) == 12

    def rots(c):
        out = [c]
        for _ in range(3):
            out.append(tat._rotate_code(out[-1], family.d))
        return out

    for i, a in enumerate(family.codes):
        assert rots(a) == [a] + [jat._rotate_code(r, 6) for r in rots(a)[:3]]
        for ra in rots(a)[1:]:
            assert bin(a ^ ra).count("1") >= 11
        for b in family.codes[i + 1:]:
            for rb in rots(b):
                assert bin(a ^ rb).count("1") >= 11


@pytest.mark.parametrize("args", [
    {}, dict(d=5, min_hamming=7, count=10, seed=3)],
    ids=["default", "d5h7"])
def test_generate_family_matches_jax(args):
    jf, tf = jat.generate_family(**args), tat.generate_family(**args)
    assert (tf.name, tf.d, tf.codes, tf.min_hamming) == \
        (jf.name, jf.d, jf.codes, jf.min_hamming)
    assert tf._rot_table == jf._rot_table


def test_decode_with_rotation_and_bitflips(families):
    jf, family = families
    code = family.codes[3]
    for rot in range(4):
        c = code
        for _ in range(rot):
            c = tat._rotate_code(c, family.d)
        tid, r, h = family.decode(c)
        assert tid == 3 and h == 0
        assert (tid, r, h) == jf.decode(c)
    flipped = code ^ (1 << 5) ^ (1 << 20)
    tid, _, h = family.decode(flipped, max_hamming=2)
    assert tid == 3 and h == 2
    assert family.decode(code ^ 0b111, max_hamming=2) in (None, (3, 0, 3))
    rng = np.random.default_rng(0)
    for c in rng.integers(0, 1 << 36, 200):
        for mh in (0, 2, 5):
            assert family.decode(int(c), mh) == jf.decode(int(c), mh)
    for tag_id in range(12):
        np.testing.assert_array_equal(family.render(tag_id, 4),
                                      jf.render(tag_id, 4))


def test_detect_axis_aligned(families):
    H = np.array([[40.0, 0, 160], [0, 40.0, 120], [0, 0, 1]])
    img = _render_in_scene(families[1], 5, H)
    dets = _detect_both(families, img)
    assert len(dets) == 1
    assert dets[0].tag_id == 5 and dets[0].hamming == 0
    assert np.linalg.norm(dets[0].center - [160, 120]) < 2.0


def test_detect_rotated_and_perspective(families):
    th = 0.5
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    H = np.eye(3)
    H[:2, :2] = R * 35.0
    H[:2, 2] = [150, 130]
    H[2, :2] = [4e-4, -3e-4]
    img = _render_in_scene(families[1], 2, H)
    dets = _detect_both(families, img)
    assert len(dets) == 1 and dets[0].tag_id == 2
    expect = tat._apply_h(H, SQUARE)
    got = tat._apply_h(dets[0].H, SQUARE)
    np.testing.assert_array_equal(got, jat._apply_h(dets[0].H, SQUARE))
    assert np.linalg.norm(np.sort(expect, axis=0) - np.sort(got, axis=0)) < 6.0


def test_pose_recovery():
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    tagsize = 0.4
    T = np.eye(4)
    T[:3, :3] = se3np.quat_to_matrix(
        se3np.quat_normalize(np.asarray([0.98, 0.05, -0.1, 0.05])))
    T[:3, 3] = [0.2, -0.1, 2.0]
    H = _projected_homography(K, T, tagsize)
    pts = np.concatenate([SQUARE * tagsize / 2, np.zeros((4, 1)),
                          np.ones((4, 1))], 1)
    uv = (K @ (T @ pts.T)[:3]).T
    np.testing.assert_array_equal(
        H, jat._homography_4pt(SQUARE, uv[:, :2] / uv[:, 2:3]))
    T_est = tat._pose_from_homography(H, K, tagsize)
    np.testing.assert_allclose(T_est, jat._pose_from_homography(H, K, tagsize),
                               atol=F64_TOL, rtol=0)
    assert np.linalg.norm(T_est[:3, 3] - T[:3, 3]) < 0.02
    dR = T_est[:3, :3].T @ T[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 2.0


def test_detect_full_pipeline_pose(families):
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    tagsize = 0.5
    T = np.eye(4)
    T[:3, 3] = [0.1, 0.05, 2.5]
    img = _render_in_scene(families[1], 7,
                           _projected_homography(K, T, tagsize))
    dets = _detect_both(families, img, K=K, tagsize=tagsize)
    assert len(dets) == 1 and dets[0].tag_id == 7
    assert np.linalg.norm(dets[0].pose[:3, 3] - T[:3, 3]) < 0.12


def _coped(tag_id, bot_id, xyz=(0.0, 0.0, 0.0), q=(1.0, 0.0, 0.0, 0.0)):
    return {"dataset": "CoPeD",
            "peer": {"id": bot_id, "tags": [
                {"id": tag_id, "x": xyz[0], "y": xyz[1], "z": xyz[2],
                 "qw": q[0], "qx": q[1], "qy": q[2], "qz": q[3]}]}}


def test_measurer_composition(families):
    jf, family = families
    bot_to_cam = np.eye(4)
    bot_to_cam[:3, 3] = [0.1, 0.0, 0.3]
    config = _coped(7, 2, xyz=(0.0, 0.0, 0.5))
    m = tat.ApriltagMeasurer(family, np.eye(3), 0.17, bot_to_cam, config,
                             host_robot_id=0)
    mj = jat.ApriltagMeasurer(jf, np.eye(3), 0.17, bot_to_cam, config,
                              host_robot_id=0)
    assert 7 in m.tag_table and m.tag_table[7][0] == 2
    np.testing.assert_array_equal(m.tag_table[7][1], mj.tag_table[7][1])
    cam_to_tag = np.eye(4)
    cam_to_tag[:3, 3] = [0.0, 0.0, 3.0]
    T = m.relative_transform(cam_to_tag, m.tag_table[7][1])
    expect = bot_to_cam @ cam_to_tag @ np.linalg.inv(m.tag_table[7][1])
    np.testing.assert_allclose(T, expect, atol=1e-12)
    np.testing.assert_array_equal(
        T, mj.relative_transform(cam_to_tag, mj.tag_table[7][1]))


def test_measurer_end_to_end(families):
    jf, family = families
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    tagsize = 0.5
    T = np.eye(4)
    T[:3, 3] = [0.0, 0.0, 2.0]
    img = _render_in_scene(family, 0, _projected_homography(K, T, tagsize))
    config = _coped(0, 1, q=(0.9, 0.1, 0.0, 0.2))
    meas = tat.ApriltagMeasurer(family, K, tagsize, np.eye(4),
                                config).process_image(img, stamp=4.2)
    want = jat.ApriltagMeasurer(jf, K, tagsize, np.eye(4),
                                config).process_image(img, stamp=4.2)
    assert len(meas) == 1 and len(want) == 1
    assert type(meas[0]) is RelativeMeas
    assert meas[0].robot_index == 1 and meas[0].stamp == 4.2
    for key in ("stamp", "robot_index", "only_use_odom"):
        assert getattr(meas[0], key) == getattr(want[0], key)
    for key in ("relative_pose", "odom_pose"):
        np.testing.assert_array_equal(getattr(meas[0], key),
                                      getattr(want[0], key))
    assert np.linalg.norm(meas[0].relative_pose[4:7]) == \
        pytest.approx(2.0, abs=0.15)


# ---------------------------------------------------------------------------
# tag36h11 (tests/test_tag36h11.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tag36h11():
    return jtag.tag36h11_family(), ttag.tag36h11_family()


def test_table_is_the_full_family(tag36h11):
    jf, family = tag36h11
    assert ttag.TAG36H11_CODES == jtag.TAG36H11_CODES
    assert len(ttag.TAG36H11_CODES) == 587
    assert len(set(ttag.TAG36H11_CODES)) == 587
    assert family.d == 6 and family.nbits == 36
    assert (family.name, family.min_hamming, family.codes) == \
        (jf.name, jf.min_hamming, jf.codes)
    assert family._rot_table == jf._rot_table


def test_min_hamming_11_sampled():
    rng = np.random.default_rng(0)
    idx = rng.choice(587, 40, replace=False)
    for i in idx[:20]:
        ci = ttag.TAG36H11_CODES[int(i)]
        rots = [ci]
        for _ in range(3):
            rots.append(tat._rotate_code(rots[-1], 6))
        assert rots[1:] == [jat._rotate_code(r, 6) for r in rots[:3]]
        for j in idx[20:]:
            cj = ttag.TAG36H11_CODES[int(j)]
            assert min(bin(r ^ cj).count("1") for r in rots) >= 11


def test_decode_own_render_all_rotations(tag36h11):
    jf, family = tag36h11
    for tag_id in (0, 17, 99, 586):
        c = ttag.TAG36H11_CODES[tag_id]
        for rot in range(4):
            got = family.decode(c)
            assert got is not None and got[0] == tag_id and got[2] == 0
            assert got == jf.decode(c)
            c = tat._rotate_code(c, 6)


def _cv2_tag_image(tag_id: int, px: int = 80):
    cv2 = pytest.importorskip("cv2")
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
    marker = cv2.aruco.generateImageMarker(d, tag_id, px)
    cell = px // 8
    out = np.full((px + 2 * cell, px + 2 * cell), 255, np.uint8)
    out[cell:-cell, cell:-cell] = marker
    return out


def _paste(tag):
    scene = np.full((240, 320), 128.0, np.float32)
    scene[60:60 + tag.shape[0], 100:100 + tag.shape[1]] = tag
    return scene


@pytest.mark.parametrize("tag_id", [0, 42, 311, 586])
def test_detect_real_cv2_rendered_tag(tag36h11, tag_id):
    scene = _paste(_cv2_tag_image(tag_id).astype(np.float32))
    dets = _detect_both(tag36h11, scene)
    assert len(dets) == 1
    assert dets[0].tag_id == tag_id and dets[0].hamming == 0


def test_detect_real_tag_rotated(tag36h11):
    tag = np.rot90(_cv2_tag_image(42).astype(np.float32)).copy()
    dets = _detect_both(tag36h11, _paste(tag))
    assert len(dets) == 1 and dets[0].tag_id == 42


@pytest.mark.parametrize("tag_id", [0, 42, 311, 586])
def test_detect_rendered_tag36h11(tag36h11, tag_id):
    """Without cv2: the family's own render (the printed pattern), pasted
    and rotated by 90 degrees, decodes to the right id in both packages."""
    tag = tag36h11[1].render(tag_id, cell_px=10).astype(np.float32)
    for img in (tag, np.rot90(tag).copy()):
        dets = _detect_both(tag36h11, _paste(img))
        assert len(dets) == 1
        assert dets[0].tag_id == tag_id and dets[0].hamming == 0

"""The port's sensor adapters (host numpy copy of slide_slam_tpu/io/
adapters.py) against the JAX package, on the cases of tests/test_adapters.py.

Tolerances: f64 outputs within 1e-12, f32 outputs identical (the same numpy
calls on the same inputs and the same Generator draws). The JAX tests' own
assertions hold for the port, whose adapters build the port's own
scheduler.RelativeMeas.
"""
import numpy as np
import pytest

from slide_slam_tpu.io import adapters as jad
from slide_slam_tpu_torch.geometry import se3np as se3
from slide_slam_tpu_torch.io import adapters as tad
from slide_slam_tpu_torch.runtime.scheduler import RelativeMeas

from _torch_parity import one_torch_thread  # noqa: F401
from test_adapters import _WORLD, _pose

F64_TOL = 1e-12

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, atol=F64_TOL, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _same_meas(got, want):
    assert type(got) is RelativeMeas
    assert (got.stamp, got.robot_index, got.only_use_odom) == \
        (want.stamp, want.robot_index, want.only_use_odom)
    _same(got.relative_pose, want.relative_pose)
    _same(got.odom_pose, want.odom_pose)


def test_relative_pose_golden():
    pose1 = _pose([3.4, -5.2, 1.1], [0.4029115, 0.1611646, 0.805823, 0.4029115])
    pose2 = _pose([1, 2, 3], [0, 0, 0.7071068, 0.7071068])
    rel = tad.relative_pose(pose1, pose2)
    _same(rel, jad.relative_pose(pose1, pose2))
    np.testing.assert_almost_equal(rel[4], 7.43896085266152, 5)
    np.testing.assert_almost_equal(rel[5], -2.13116887703829, 5)
    np.testing.assert_almost_equal(rel[6], -1.15324631249453, 5)
    q = rel[0:4] * np.sign(rel[0])
    np.testing.assert_allclose(
        q, [0.8547043, -0.398862, 0.1709409, -0.2849014], atol=1e-6)


def test_euler_noise_roundtrip():
    rng = np.random.default_rng(3)
    for _ in range(10):
        p = se3.retract(se3.identity(), rng.normal(0, 0.8, 6).astype(np.float32))
        e = tad._euler_xyz_from_quat(p[0:4])
        _same(e, jad._euler_xyz_from_quat(p[0:4]))
        q = tad._quat_from_euler_xyz(e)
        _same(q, jad._quat_from_euler_xyz(e))
        np.testing.assert_allclose(q * np.sign(q[0]), p[0:4] * np.sign(p[0]),
                                   atol=1e-5)


def test_add_pose_noise_statistics():
    base = np.asarray(se3.from_xyz_yaw(1.0, 2.0, 0.5, 0.3))
    rng, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    samples = np.stack([tad.add_pose_noise(base, 0.1, 0.02, rng)
                        for _ in range(400)])
    _same(samples, np.stack([jad.add_pose_noise(base, 0.1, 0.02, rng_j)
                             for _ in range(400)]))
    err = samples[:, 4:7] - base[4:7]
    assert abs(err.mean()) < 0.02
    assert abs(err.std() - 0.1) < 0.02
    assert np.all(np.abs(samples[:, 0:4] @ base[0:4]) > 0.999)


def test_gps_to_enu_flat_earth():
    lat0, lon0, alt0 = 39.9526, -75.1652, 12.0
    dn, de, du = 30.0, -45.0, 3.0
    lat_m = 111132.92 - 559.82 * np.cos(2 * np.radians(lat0))
    lon_m = 111412.84 * np.cos(np.radians(lat0)) - 93.5 * np.cos(3 * np.radians(lat0))
    args = (lat0, lon0, alt0, lat0 + dn / lat_m, lon0 + de / lon_m, alt0 + du)
    enu = tad.gps_to_enu(*args)
    _same(enu, jad.gps_to_enu(*args))
    np.testing.assert_allclose(enu, [de, dn, du], atol=0.05)
    lats = np.linspace(-80, 80, 7)
    _same(tad.geodetic_to_ecef(lats, lats * 2, 100.0),
          jad.geodetic_to_ecef(lats, lats * 2, 100.0))


def test_gps_relative_measurement_sync_gate():
    odom = se3.identity()
    fix1 = (10.0, 39.95, -75.16, 10.0)
    fix2 = (10.02, 39.9501, -75.16, 10.0)
    rm = tad.gps_relative_measurement(10.0, fix1, fix2, 1, odom)
    _same_meas(rm, jad.gps_relative_measurement(10.0, fix1, fix2, 1, odom))
    assert rm.robot_index == 1
    assert np.linalg.norm(rm.relative_pose[4:7]) > 5.0
    np.testing.assert_allclose(rm.relative_pose[0:4], [1, 0, 0, 0])
    assert tad.gps_relative_measurement(
        10.0, (10.0, *fix1[1:]), (10.2, *fix2[1:]), 1, odom) is None


def test_parse_gazebo_world(tmp_path):
    boxes = tad.parse_gazebo_world(_WORLD)
    path = tmp_path / "w.world"
    path.write_text(_WORLD)
    for want in (jad.parse_gazebo_world(_WORLD),
                 jad.parse_gazebo_world(str(path))):
        assert [b.name for b in boxes] == [b.name for b in want]
        for b, w in zip(boxes, want):
            _same(b.pose, w.pose)
            _same(b.size, w.size)
    assert [b.name for b in tad.parse_gazebo_world(str(path))] == \
        ["unit_box_0", "unit_box_1"]
    np.testing.assert_allclose(boxes[0].pose[4:7], [4.0, -2.0, 0.5])
    np.testing.assert_allclose(boxes[0].size, [1.0, 2.0, 1.0])
    assert abs(se3.yaw_of(boxes[1].pose) - 1.5708) < 1e-4


def test_sim_cuboid_detections_in_body_frame():
    boxes = tad.parse_gazebo_world(_WORLD)
    robot = np.asarray(se3.from_xyz_yaw(1.0, 0.0, 0.0, np.pi / 2))
    kw = dict(std_t_per_m=0.0, std_r_per_m=0.0, std_s_per_m=0.0)
    obs = tad.sim_cuboid_detections(boxes, robot, np.random.default_rng(1),
                                    **kw)
    assert obs["cub_pose"].shape == (2, 7)
    np.testing.assert_allclose(obs["cub_pose"][0, 4:7], [-2.0, -3.0, 0.5],
                               atol=1e-5)
    np.testing.assert_allclose(obs["cub_scale"], [b.size for b in boxes],
                               atol=1e-6)
    assert list(obs["cub_label"]) == [5, 5]
    for args in (kw, dict(max_range=4.0), {}):
        got = tad.sim_cuboid_detections(boxes, robot,
                                        np.random.default_rng(1), **args)
        want = jad.sim_cuboid_detections(jad.parse_gazebo_world(_WORLD),
                                         robot, np.random.default_rng(1),
                                         **args)
        assert sorted(got) == sorted(want)
        for k in got:
            _same(got[k], want[k])
    obs2 = tad.sim_cuboid_detections(boxes, robot, np.random.default_rng(1),
                                     max_range=4.0)
    assert obs2["cub_pose"].shape == (1, 7)


def test_sim_relative_measurement_noise_scales_with_range():
    rng, rng_j = np.random.default_rng(2), np.random.default_rng(2)
    a = se3.identity()
    b = np.asarray(se3.from_xyz_yaw(10.0, 0.0, 0.0, 0.5))
    errs = []
    for _ in range(200):
        rm = tad.sim_relative_measurement(0.0, a, b, 1, a, rng)
        _same_meas(rm, jad.sim_relative_measurement(0.0, a, b, 1, a, rng_j))
        errs.append(rm.relative_pose[4:7] - b[4:7])
    std = np.stack(errs).std()
    assert 0.2 < std < 0.4

"""The port's ROS1 bag reader/writer (slide_slam_tpu_torch/io/rosbag.py)
against the JAX package's (tests/test_rosbag.py mirrored on the port).

Tolerances: bags written by the two packages from the same log or messages
are byte-identical; a bag written by either package reads in the other to
the same keyframes, exactly (every array bit for bit, true_pose the
odometry: a bag carries no ground truth); the round trip against the
source log holds to 1e-6 as in the JAX test. `load_msg_package` reads a
small sloam_msgs-style msg/ directory written into tmp_path to the same
specs, texts and embedded definitions in both packages.
"""
import bz2
import os
import struct

import numpy as np
import pytest

from slide_slam_tpu.io import rosbag as jrosbag
from slide_slam_tpu_torch.io import logs, rosbag, synthetic
from slide_slam_tpu_torch.runtime.scheduler import RelativeMeas


def _make_log(n_kf=20, seed=0):
    rng = np.random.default_rng(seed)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=5,
                                        n_cars=5, extent=25.0)
    traj = synthetic.lawnmower_trajectory(n_kf, extent=20.0, rows=2, step=1.5)
    return synthetic.make_log(world, traj, odom_drift_sigma=0.005,
                              pos_noise=0.02, dropout=0.0)


def _rel_message():
    header = {"seq": 0, "stamp": 12.5, "frame_id": ""}
    odom = {"header": header, "child_frame_id": "",
            "pose": {"pose": rosbag._pose_to_ros(
                np.asarray([1, 0, 0, 0, 1.0, 2.0, 0.0])),
                "covariance": [0.0] * 36},
            "twist": {"twist": {"linear": {"x": 0, "y": 0, "z": 0},
                                "angular": {"x": 0, "y": 0, "z": 0}},
                      "covariance": [0.0] * 36}}
    return {"header": header,
            "relativePose": rosbag._pose_to_ros(
                np.asarray([1, 0, 0, 0, 3.0, 0.0, 0.0])),
            "robotIdObserver": 0, "robotIdObserved": 1,
            "odometryObserver": odom, "odometryObserved": odom}


def _same_keyframes(a, b, truth_is_odometry=False):
    assert len(a.keyframes) == len(b.keyframes)
    for x, y in zip(a.keyframes, b.keyframes):
        for k, v in vars(x).items():
            want = x.odom_pose if (k == "true_pose" and truth_is_odometry) \
                else v
            got = getattr(y, k)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_bag_roundtrip(tmp_path):
    log = _make_log()
    bag = str(tmp_path / "robot0.bag")
    rosbag.robot_log_to_bag(bag, log)

    topics = rosbag.bag_topics(bag)
    assert topics == {f"/robot{log.robot_id}/semantic_meas_sync_odom":
                      "sloam_msgs/SemanticMeasSyncOdom"}

    log2 = rosbag.bag_to_robot_log(bag, robot_id=log.robot_id)
    assert isinstance(log2, synthetic.RobotLog)
    assert all(isinstance(k, synthetic.Keyframe) for k in log2.keyframes)
    assert len(log2.keyframes) == len(log.keyframes)
    for a, b in zip(log.keyframes, log2.keyframes):
        assert b.stamp == pytest.approx(a.stamp, abs=1e-6)
        np.testing.assert_allclose(b.odom_pose, a.odom_pose, atol=1e-6)
        np.testing.assert_allclose(b.cyl_root, a.cyl_root.reshape(-1, 3),
                                   atol=1e-6)
        np.testing.assert_array_equal(b.cyl_label, a.cyl_label)
        np.testing.assert_allclose(b.cub_scale, a.cub_scale.reshape(-1, 3),
                                   atol=1e-6)
        np.testing.assert_allclose(b.ell_pose, a.ell_pose.reshape(-1, 7),
                                   atol=1e-6)


def test_bag_bz2_chunk_and_lz4_refusal(tmp_path):
    """bz2 chunks decompress (rosbag's default compression); an lz4 chunk
    raises ValueError in both packages, as the JAX reader does."""
    log = _make_log(n_kf=5, seed=1)
    bag = str(tmp_path / "plain.bag")
    rosbag.robot_log_to_bag(bag, log)
    with open(bag, "rb") as f:
        assert f.read(13) == b"#ROSBAG V2.0\n"
        body = f.read()
    recs = list(rosbag._records(body))

    def rewrite(path, comp, pack):
        out = b"#ROSBAG V2.0\n"
        for header, data in recs:
            if header.get("op", b"\x00")[0] == 0x05:
                header = dict(header)
                header["compression"] = comp
                data = pack(data)
            h = rosbag._write_header(header)
            out += struct.pack("<I", len(h)) + h
            out += struct.pack("<I", len(data)) + data
        with open(path, "wb") as f:
            f.write(out)

    bag2 = str(tmp_path / "compressed.bag")
    rewrite(bag2, b"bz2", bz2.compress)
    log2 = rosbag.bag_to_robot_log(bag2)
    assert len(log2.keyframes) == 5
    np.testing.assert_allclose(log2.keyframes[0].odom_pose,
                               log.keyframes[0].odom_pose, atol=1e-6)
    _same_keyframes(jrosbag.bag_to_robot_log(bag2), log2)

    bag3 = str(tmp_path / "lz4.bag")
    rewrite(bag3, b"lz4", lambda d: d)
    for mod in (rosbag, jrosbag):
        with pytest.raises(ValueError, match="lz4"):
            list(mod.read_bag(bag3))


def test_relative_measurement_extraction(tmp_path):
    reg = rosbag.builtin_registry()
    bag = str(tmp_path / "rel.bag")
    rosbag.write_bag(bag, [("/relative_inter_robot_meas_sync",
                            "sloam_msgs/RelativeInterRobotMeasurementOdom",
                            12.5, _rel_message())], registry=reg)
    rel = rosbag.bag_relative_measurements(bag, host_robot_id=0)
    assert len(rel) == 1 and isinstance(rel[0], RelativeMeas)
    assert rel[0].robot_index == 1 and not rel[0].only_use_odom
    assert rel[0].stamp == pytest.approx(12.5)
    np.testing.assert_allclose(rel[0].relative_pose[4:], [3.0, 0, 0],
                               atol=1e-9)
    rel_obs = rosbag.bag_relative_measurements(bag, host_robot_id=1)
    assert len(rel_obs) == 1
    assert rel_obs[0].robot_index == 0 and rel_obs[0].only_use_odom
    assert rosbag.bag_relative_measurements(bag, host_robot_id=2) == []
    # the same views as the JAX package's, field by field
    for host in (None, 0, 1):
        a = rosbag.bag_relative_measurements(bag, host_robot_id=host)
        b = jrosbag.bag_relative_measurements(bag, host_robot_id=host)
        assert [vars(m).keys() for m in a] == [vars(m).keys() for m in b]
        for x, y in zip(a, b):
            for k, v in vars(y).items():
                np.testing.assert_array_equal(getattr(x, k), v, err_msg=k)


def test_definition_driven_parsing():
    reg = rosbag.TypeRegistry()
    definition = (
        "float32[2] xy\nuint8 flag\nMyInner inner\nstring name\n"
        + "=" * 80 + "\nMSG: foo_msgs/MyInner\nint32 a\nfloat64[] b\n")
    reg.parse_definition("foo_msgs/MyOuter", definition)
    payload = (struct.pack("<2f", 1.5, -2.5) + struct.pack("B", 7)
               + struct.pack("<i", -3) + struct.pack("<I", 2)
               + struct.pack("<2d", 0.25, 0.75)
               + struct.pack("<I", 2) + b"hi")
    msg = reg.read("foo_msgs/MyOuter", payload)
    np.testing.assert_allclose(msg["xy"], [1.5, -2.5])
    assert msg["flag"] == 7
    assert msg["inner"]["a"] == -3
    np.testing.assert_allclose(msg["inner"]["b"], [0.25, 0.75])
    assert msg["name"] == "hi"
    assert reg.write("foo_msgs/MyOuter", msg) == payload


@pytest.mark.slow
def test_bag_to_slam_end_to_end(tmp_path):
    """A converted bag drives the port's SLAM node (the reference's
    replay), with the JAX package's landmark counts."""
    from slide_slam_tpu.config import SlamConfig as JSlamConfig
    from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
    from slide_slam_tpu_torch.config import SlamConfig
    from slide_slam_tpu_torch.runtime.node import SlamNode

    log = _make_log(n_kf=15, seed=2)
    bag = str(tmp_path / "r0.bag")
    rosbag.robot_log_to_bag(bag, log)
    log2 = rosbag.bag_to_robot_log(bag)

    node = SlamNode(SlamConfig(number_of_robots=1), robot_id=0, device="cpu")
    jnode = JSlamNode(JSlamConfig(number_of_robots=1), robot_id=0)
    for kf in log2.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        jnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    assert len(node.key_poses) == len(log2.keyframes)
    counts = node.landmark_counts()
    assert counts["cylinders"] > 0
    assert counts == jnode.landmark_counts()


def test_cli_convert_bag(tmp_path, capsys):
    from slide_slam_tpu_torch import cli

    log = _make_log(n_kf=6, seed=3)
    bag = str(tmp_path / "r0.bag")
    out = str(tmp_path / "r0.npz")
    rosbag.robot_log_to_bag(bag, log)
    cli.main(["convert-bag", "--bag", bag, "--out", out])
    assert os.path.exists(out)
    log2 = logs.load_log(out)
    assert len(log2.keyframes) == 6
    cli.main(["convert-bag", "--bag", bag, "--list"])
    assert "semantic_meas_sync_odom" in capsys.readouterr().out


def test_write_bag_custom_type_self_describing(tmp_path):
    reg = rosbag.builtin_registry()
    reg.parse_definition(
        "foo_msgs/Custom",
        "float32[3] xyz\nuint8 flag\nstring tag\n")
    msg = {"xyz": [1.0, 2.0, 3.0], "flag": 7, "tag": "hello"}
    bag = str(tmp_path / "custom.bag")
    rosbag.write_bag(bag, [("/t", "foo_msgs/Custom", 1.5, msg)], registry=reg)
    out = list(rosbag.read_bag(bag))
    assert len(out) == 1
    got = out[0].msg
    assert isinstance(got, dict) and got, f"empty decode: {out[0]!r}"
    np.testing.assert_allclose(got["xyz"], [1.0, 2.0, 3.0])
    assert got["flag"] == 7 and got["tag"] == "hello"
    with pytest.raises(KeyError):
        rosbag.write_bag(str(tmp_path / "bad.bag"),
                         [("/t", "foo_msgs/Nope", 0.0, {})], registry=reg)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_bags_byte_identical_across_packages(tmp_path):
    """The same log, the same relative message and the same custom type
    give the same bytes from either writer."""
    log = _make_log(n_kf=8, seed=4)
    for name, mod in (("port", rosbag), ("jax", jrosbag)):
        mod.robot_log_to_bag(str(tmp_path / f"{name}.bag"), log)
        mod.write_bag(str(tmp_path / f"{name}_rel.bag"),
                      [("/relative_inter_robot_meas_sync",
                        "sloam_msgs/RelativeInterRobotMeasurementOdom",
                        12.5, _rel_message())])
        reg = mod.builtin_registry()
        reg.parse_definition("foo_msgs/Custom",
                             "float32[3] xyz\nuint8 flag\nstring tag\n")
        mod.write_bag(str(tmp_path / f"{name}_custom.bag"),
                      [("/t", "foo_msgs/Custom", 1.5,
                        {"xyz": [1.0, 2.0, 3.0], "flag": 7, "tag": "x"})],
                      registry=reg)
    for suffix in ("", "_rel", "_custom"):
        a = _read(tmp_path / f"port{suffix}.bag")
        assert a == _read(tmp_path / f"jax{suffix}.bag"), suffix
    assert rosbag.full_definition("sloam_msgs/SemanticMeasSyncOdom") == \
        jrosbag.full_definition("sloam_msgs/SemanticMeasSyncOdom")


def test_bags_cross_read(tmp_path):
    """A bag written by either package reads in the other to the same
    keyframes, bit for bit (true_pose: the odometry), and the same topics."""
    log = _make_log(n_kf=8, seed=5)
    port_bag, jax_bag = str(tmp_path / "p.bag"), str(tmp_path / "j.bag")
    rosbag.robot_log_to_bag(port_bag, log)
    jrosbag.robot_log_to_bag(jax_bag, log)
    for bag in (port_bag, jax_bag):
        ours = rosbag.bag_to_robot_log(bag)
        theirs = jrosbag.bag_to_robot_log(bag)
        _same_keyframes(log, ours, truth_is_odometry=True)
        _same_keyframes(theirs, ours)
        assert rosbag.bag_topics(bag) == jrosbag.bag_topics(bag)
        a = [(m.topic, m.msg_type, m.stamp) for m in rosbag.read_bag(bag)]
        b = [(m.topic, m.msg_type, m.stamp) for m in jrosbag.read_bag(bag)]
        assert a == b


MSGS = {
    "ROSCylinder.msg": "# a tree or pole\nfloat32[3] root\nfloat32[3] ray\n"
                       "float64[] radii\nfloat32 radius\nint64 id\n"
                       "int8 semantic_label\n",
    "ROSCube.msg": "float32[3] dim\nint8 semantic_label\n"
                   "geometry_msgs/Pose pose\n",
    "ROSEllipsoid.msg": "float32[3] scale\nint8 semantic_label\n"
                        "geometry_msgs/Pose pose\n",
    "SemanticMeasSyncOdom.msg":
        "Header header  # stamp of the synced odometry\n"
        "ROSEllipsoid[] ellipsoid_factors\nROSCylinder[] cylinder_factors\n"
        "ROSCube[] cuboid_factors\nnav_msgs/Odometry odometry\n",
    "README": "not a message\n",
}


def test_load_msg_package(tmp_path):
    """A sloam_msgs-style msg/ directory: the same registry, raw texts and
    gendeps definitions in both packages, and a bag written with those
    definitions byte-identical and read back to the source keyframes."""
    msg_dir = tmp_path / "msg"
    msg_dir.mkdir()
    for name, text in MSGS.items():
        (msg_dir / name).write_text(text)
    reg, raw = rosbag.load_msg_package(str(msg_dir))
    jreg, jraw = jrosbag.load_msg_package(str(msg_dir))
    assert raw == jraw and sorted(raw) == [
        "sloam_msgs/ROSCube", "sloam_msgs/ROSCylinder",
        "sloam_msgs/ROSEllipsoid", "sloam_msgs/SemanticMeasSyncOdom"]
    assert raw["sloam_msgs/ROSCylinder"] == MSGS["ROSCylinder.msg"]
    assert sorted(reg.specs) == sorted(jreg.specs)
    for name, spec in reg.specs.items():
        assert [(f.name, f.type, f.array_len) for f in spec.fields] == [
            (f.name, f.type, f.array_len) for f in jreg.specs[name].fields]
    assert reg.specs["sloam_msgs/SemanticMeasSyncOdom"].fields[0].type == \
        "std_msgs/Header"
    t = "sloam_msgs/SemanticMeasSyncOdom"
    d = rosbag.definition_from_msg_package(t, reg, raw)
    assert d == jrosbag.definition_from_msg_package(t, jreg, jraw)
    assert d.startswith(MSGS["SemanticMeasSyncOdom.msg"])
    assert rosbag.definition_from_specs(reg, t) == \
        jrosbag.definition_from_specs(jreg, t)

    log = _make_log(n_kf=4, seed=6)
    bags = []
    for name, mod, r in (("p", rosbag, reg), ("j", jrosbag, jreg)):
        bags.append(str(tmp_path / f"{name}.bag"))
        mod.robot_log_to_bag(bags[-1], log, registry=r, definitions={t: d})
    assert _read(bags[0]) == _read(bags[1])
    _same_keyframes(log, rosbag.bag_to_robot_log(bags[0]),
                    truth_is_odometry=True)

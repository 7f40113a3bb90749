"""The raw-LiDAR solo mission through both packages (PyTorch port on the CPU).

Scans -> range image -> ground-truth labels -> two-stage DBSCAN -> cylinder
fits -> SlamNode.process_keyframe, at the size of the JAX package's raw-LiDAR
test: 14 trees, a 32x512 image, 12 keyframes, small capacities, drifting
odometry. Per keyframe the measurements' counts and labels, the match
indices and the overflow counters must be identical; the measured values
agree to 1e-4 (the 3x3 eigen-solves and covariance sums round differently
in the two frameworks); the optimized key poses to 1e-3 m and 1e-3 rad
(different f32 summation order in the solver's reductions).
"""
import numpy as np
import pytest

from slide_slam_tpu.frontend import lidar_pipeline as jlp
from slide_slam_tpu.frontend import pipeline as jpipe
from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu.runtime.node import SlamNode as JNode
from slide_slam_tpu_torch.frontend import lidar_pipeline as tlp
from slide_slam_tpu_torch.frontend.pipeline import PipelineConfig, forest_classes
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode as TNode

from _torch_parity import forest_scene, jax_ransac_draws, small_configs

POS_TOL = 1e-3      # m
ROT_TOL = 1e-3      # rad (quaternion vector part, ~ half angle)
MEAS_TOL = 1e-4


def _run(make_frontend, node, scans, traj, odom, record):
    holder = {"pose": traj[0]}
    frontend = make_frontend(lambda: holder["pose"])
    obs_all = []
    for i, scan in enumerate(scans):
        holder["pose"] = traj[i]
        stamp = 1000.0 + 0.5 * i
        obs = frontend.process_scan(stamp, scan, np.zeros(len(scan),
                                                          np.float32),
                                    odom[i])
        obs_all.append(obs)
        node.process_keyframe(stamp, odom[i], obs)
        record(node)
    return obs_all


@pytest.fixture(scope="module")
def missions():
    world, traj, odom = forest_scene()
    srng = np.random.default_rng(5)
    scans = [synthetic.simulate_lidar_scan(world, p, srng) for p in traj]
    jcfg, tcfg = small_configs()
    lidar = dict(height=32, width=512, desired_period=0.0)

    # JAX: capture each keyframe's StepOutput from the fused engine step
    j_outs = []
    orig = jengine.keyframe_step_fused

    def recording_step(*a, **k):
        s, out = orig(*a, **k)
        j_outs.append({k: np.asarray(v) for k, v in out._asdict().items()})
        return s, out

    jnode = JNode(jcfg, robot_id=0)
    j_classes = [c for c in jpipe.outdoor_classes() if c.model != "cuboid"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "keyframe_step_fused", recording_step)
        j_obs = _run(lambda getter: jlp.LidarFrontend(
            jlp.ground_truth_segmenter(world, getter),
            jlp.LidarFrontendConfig(**lidar),
            jpipe.PipelineConfig(classes=j_classes, max_range=22.0)),
            jnode, scans, traj, odom, lambda n: None)
    j_traj = np.asarray(jnode.optimized_trajectory())

    t_outs = []
    tnode = TNode(tcfg, robot_id=0, device="cpu")
    t_obs = _run(lambda getter: tlp.LidarFrontend(
        tlp.ground_truth_segmenter(world, getter),
        tlp.LidarFrontendConfig(**lidar),
        PipelineConfig(classes=forest_classes(), max_range=22.0),
        device="cpu", ransac_draws=jax_ransac_draws),
        tnode, scans, traj, odom,
        lambda n: t_outs.append({k: v.numpy() for k, v in
                                 n.last_step._asdict().items()}))
    return dict(traj=traj, odom=odom, j_obs=j_obs, t_obs=t_obs,
                j_outs=j_outs, t_outs=t_outs, j_traj=j_traj,
                t_traj=tnode.optimized_trajectory(),
                t_counts=tnode.landmark_counts(),
                j_counts=jnode.landmark_counts())


@pytest.mark.parametrize("kf", range(12))
def test_keyframe_parity(missions, kf):
    jo, to = missions["j_obs"][kf], missions["t_obs"][kf]
    assert sorted(jo) == sorted(to)
    n = len(jo.get("cyl_label", []))
    assert n > 0, "no cylinder measurements in this keyframe"
    np.testing.assert_array_equal(to["cyl_label"], jo["cyl_label"])
    for key in ("cyl_root", "cyl_ray", "cyl_radius"):
        np.testing.assert_allclose(to[key], jo[key], atol=MEAS_TOL, rtol=0,
                                   err_msg=key)
    j_out, t_out = missions["j_outs"][kf], missions["t_outs"][kf]
    for key in ("cyl_matches", "cub_matches", "pt_matches", "overflow"):
        np.testing.assert_array_equal(t_out[key], j_out[key], err_msg=key)
    assert int(t_out["slot"]) == int(j_out["slot"])
    np.testing.assert_allclose(t_out["pose"][4:7], j_out["pose"][4:7],
                               atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t_out["pose"][1:4], j_out["pose"][1:4],
                               atol=ROT_TOL, rtol=0)


def test_trajectory_and_ate(missions):
    j_traj, t_traj, truth = (missions["j_traj"], missions["t_traj"],
                             missions["traj"])
    assert t_traj.shape == j_traj.shape == (12, 7)
    np.testing.assert_allclose(t_traj[:, 4:7], j_traj[:, 4:7], atol=POS_TOL,
                               rtol=0)
    np.testing.assert_allclose(t_traj[:, 1:4], j_traj[:, 1:4], atol=ROT_TOL,
                               rtol=0)
    j_ate = synthetic.ate_rmse(j_traj, truth, align=False)
    t_ate = synthetic.ate_rmse(t_traj, truth, align=False)
    assert abs(t_ate - j_ate) < POS_TOL, (t_ate, j_ate)
    assert missions["t_counts"] == missions["j_counts"]

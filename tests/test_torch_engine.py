"""The keyframe engine on a run that overflows every capacity: the port (on
the CPU) vs the JAX package, keyframe by keyframe.

Tiny capacities make both packages drop pose slots, landmarks of each family
and factors of each family; the JAX version drops out-of-range destinations
in its `mode="drop"` scatters, the port masks them. Match indices, new-
landmark counts, slots and the eight overflow counters must be IDENTICAL;
key poses agree to 1e-3 m and 1e-3 rad (f32 sums in another order).
"""
import numpy as np
import pytest

from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu.runtime.node import SlamNode as JNode
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode as TNode

from _torch_parity import small_configs

POS_TOL = 1e-3
ROT_TOL = 1e-3
TINY = dict(max_poses_per_robot=8, max_cylinders=12, max_cuboids=3,
            max_points=3, max_scan_objects=16, max_cylinder_factors=48,
            max_cuboid_factors=8, max_point_factors=8)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(1)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=4, n_cars=6,
                                        extent=15.0)
    traj = synthetic.lawnmower_trajectory(11, extent=12.0, rows=1, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01)
    jcfg, tcfg = small_configs(**TINY)

    j_outs = []
    orig = jengine.keyframe_step_fused

    def recording_step(*a, **k):
        s, out = orig(*a, **k)
        j_outs.append({k: np.asarray(v) for k, v in out._asdict().items()})
        return s, out

    jnode = JNode(jcfg, robot_id=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "keyframe_step_fused", recording_step)
        for kf in log.keyframes:
            jnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))

    t_outs = []
    tnode = TNode(tcfg, robot_id=0, device="cpu")
    for kf in log.keyframes:
        tnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        t_outs.append({k: v.numpy() for k, v in
                       tnode.last_step._asdict().items()})
    return j_outs, t_outs, jnode, tnode


def test_every_family_overflows(runs):
    _, _, jnode, tnode = runs
    report = tnode.overflow_report()
    assert report == jnode.overflow_report()
    for name in ("poses", "cylinders", "cuboids", "points",
                 "cylinder_factors", "cuboid_factors", "point_factors"):
        assert report[f"overflow_{name}"] > 0, (name, report)
    assert tnode.landmark_counts() == jnode.landmark_counts()


@pytest.mark.parametrize("kf", range(11))
def test_step_outputs_identical(runs, kf):
    j, t = runs[0][kf], runs[1][kf]
    for key in ("slot", "n_new_cyl", "n_new_cub", "n_new_pt", "cyl_matches",
                "cub_matches", "pt_matches", "overflow"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert t["cyl_matches"].dtype == np.int32 and t["slot"].dtype == np.int32
    np.testing.assert_allclose(t["pose"][4:7], j["pose"][4:7], atol=POS_TOL,
                               rtol=0)
    np.testing.assert_allclose(t["pose"][1:4], j["pose"][1:4], atol=ROT_TOL,
                               rtol=0)

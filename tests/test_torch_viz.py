"""The port's visualization (slide_slam_tpu_torch/viz.py) against the JAX
package's (tests/test_viz.py mirrored on the port): matched maps and a
mission render to PNG files, and runtime_summary gives the JAX function's
string, character for character, on a port node fed a small log (the JAX
function reads only the node's host attributes, so no JAX engine runs).
matplotlib is optional in the port (the machine with the card lacks it):
these cases skip without it."""
import os

import numpy as np
import pytest

pytest.importorskip("matplotlib", reason="matplotlib is not installed")

from slide_slam_tpu import viz as jviz  # noqa: E402
from slide_slam_tpu_torch import viz  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: F401,E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _map(n=20, seed=0):
    rng = np.random.default_rng(seed)
    m = np.zeros((n, 7), np.float32)
    m[:, 0] = rng.choice([5, 8, 9], n)
    m[:, 1:3] = rng.uniform(-20, 20, (n, 2))
    m[:, 4] = rng.uniform(0.2, 2.0, n)
    return m


def test_render_matched_maps(tmp_path):
    ref = _map()
    yaw = 0.4
    c, s = np.cos(yaw), np.sin(yaw)
    tf = np.eye(4)
    tf[:2, :2] = [[c, -s], [s, c]]
    tf[:2, 3] = [3.0, -1.0]
    qry = ref.copy()
    qry[:, 1:4] = (ref[:, 1:4] - tf[:3, 3]) @ tf[:3, :3]
    out = str(tmp_path / "match.png")
    p = viz.render_matched_maps(ref, qry, tf, ref_pairs=ref[:5],
                                det_pairs=qry[:5], path=out)
    assert p == out and os.path.getsize(out) > 1000
    assert viz.LABEL_COLORS == jviz.LABEL_COLORS


def test_render_mission_and_summary(tmp_path):
    from slide_slam_tpu_torch.config import SlamConfig
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.runtime.node import SlamNode

    rng = np.random.default_rng(1)
    world = synthetic.make_forest_world(rng, n_trees=20, n_poles=4,
                                        n_cars=4, extent=20.0)
    traj = synthetic.lawnmower_trajectory(10, extent=15.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.005,
                             pos_noise=0.02, dropout=0.0)
    node = SlamNode(SlamConfig(number_of_robots=1), robot_id=0, device="cpu")
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    out = str(tmp_path / "mission.png")
    assert viz.render_mission([node], {0: traj}, out_path=out) == out
    assert os.path.getsize(out) > 1000
    summary = viz.runtime_summary(node)
    assert summary.startswith("robot 0: kf=10 ")
    assert summary == jviz.runtime_summary(node)

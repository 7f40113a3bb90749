"""The JAX package on the raw-LiDAR solo mission that chip_smoke.py runs
through the PyTorch port (phase slice:raw_lidar_solo), on the CPU.

Same world, trajectory, odometry and scans (slide_slam_tpu_torch.io.
synthetic.make_lidar_mission, numpy only), the JAX LidarFrontend with the
ground-truth labeller and the forest classes, and the JAX SlamNode with the
forest config at mission capacity. Prints one JSON line: ATE of the
optimized trajectory and of the odometry, landmark counts, overflow
counters. chip_smoke.py's ATE bound is set from this output (PERF.md).

    JAX_PLATFORMS=cpu python scripts/jax_raw_lidar_reference.py [n_keyframes]
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slide_slam_tpu.config import forest_config, mission_capacity  # noqa: E402
from slide_slam_tpu.frontend import lidar_pipeline as jlp  # noqa: E402
from slide_slam_tpu.frontend import pipeline as jpipe  # noqa: E402
from slide_slam_tpu.runtime.node import SlamNode  # noqa: E402
from slide_slam_tpu_torch.io import synthetic  # noqa: E402


def main(n_keyframes: int = 150):
    m = synthetic.make_lidar_mission(n_keyframes=n_keyframes)
    holder = {"pose": m.traj[0]}
    classes = [c for c in jpipe.outdoor_classes() if c.model != "cuboid"]
    frontend = jlp.LidarFrontend(
        jlp.ground_truth_segmenter(m.world, lambda: holder["pose"]),
        jlp.LidarFrontendConfig(64, 1024, desired_period=0.0),
        jpipe.PipelineConfig(classes=classes))
    cfg = forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=mission_capacity(150, n_cylinders=140))
    node = SlamNode(cfg, robot_id=0)
    t0 = time.perf_counter()
    n_meas = 0
    for i, scan in enumerate(m.scans):
        holder["pose"] = m.traj[i]
        stamp = 1000.0 + 0.5 * i
        obs = frontend.process_scan(stamp, scan, np.zeros(len(scan),
                                                          np.float32),
                                    m.odom[i])
        n_meas += len(obs.get("cyl_root", []))
        node.process_keyframe(stamp, m.odom[i], obs)
    est = np.asarray(node.optimized_trajectory())
    print(json.dumps({
        "package": "slide_slam_tpu (JAX, CPU)",
        "n_keyframes": n_keyframes,
        "ate_optimized_m": synthetic.ate_rmse(est, m.traj, align=False),
        "ate_odometry_m": synthetic.ate_rmse(m.odom, m.traj, align=False),
        "cylinder_measurements": n_meas,
        "landmarks": node.landmark_counts(),
        "overflow": node.overflow_report(),
        "host_seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 150)

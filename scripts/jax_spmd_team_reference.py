"""The JAX package's team step (slide_slam_tpu.parallel.multirobot
build_spmd_step) on the inputs of chip_smoke.py's phase slice:spmd_team,
on the CPU; or, with --port, the port's (slide_slam_tpu_torch.parallel.
multirobot) on the CPU.

The 3 robots of the multi-robot mission (mission_capacity(150)), each
robot's logged keyframes as packets in its own odometry frame, robot 0
given robot 1's frame and robot 1 robot 2's at step chip_smoke.SPMD_TF_STEP
(chip_smoke.spmd_team_inputs). Prints one JSON line: after every 10th step,
each robot's own ATE and its odometry's over the same keyframes, the pose
counts and each replica's overflow counters (poses, cylinders, cuboids,
points, then cylinder, cuboid, point and between factors).

    JAX_PLATFORMS=cpu python scripts/jax_spmd_team_reference.py [n_steps]
        [--port]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from slide_slam_tpu_torch.io import synthetic  # noqa: E402


def _jax_run(_, steps, tfs, n_steps):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from slide_slam_tpu import config as jconfig
    from slide_slam_tpu.objects import Cuboids, Cylinders, Ellipsoids
    from slide_slam_tpu.parallel import multirobot as mr
    cfg, *_ = chip_smoke.mission_setup(jconfig, synthetic,
                                       synthetic.relative_measurements)
    mesh = Mesh(np.array(jax.devices()[:1]), ("robot",))
    state = mr.make_spmd_state(cfg, mesh)
    step = mr.build_spmd_step(cfg, mesh)

    def to_jax(p):
        a = lambda t: jnp.asarray(t.cpu().numpy())
        return mr.KeyframePacket(
            a(p.pose_est), a(p.rel_odom),
            Cylinders(*(a(f) for f in p.cyl)), Cuboids(*(a(f) for f in p.cub)),
            Ellipsoids(*(a(f) for f in p.ell)))
    out = []
    for k in range(n_steps):
        if k == chip_smoke.SPMD_TF_STEP:
            for (o, p), tf in tfs.items():
                state = mr.set_tf(state, o, p, tf)
        state = step(state, to_jax(steps[k]))
        out.append((np.asarray(state.graph.poses),
                    np.asarray(state.graph.pose_count),
                    np.asarray(state.graph.overflow)))
    return cfg.capacity.max_poses_per_robot, out


def _port_run(cfg, steps, tfs, n_steps):
    from slide_slam_tpu_torch.parallel import multirobot as mr
    state = mr.make_spmd_state(cfg, device="cpu")
    step = mr.build_spmd_step(cfg, device="cpu")
    out = []
    for k in range(n_steps):
        if k == chip_smoke.SPMD_TF_STEP:
            for (o, p), tf in tfs.items():
                state = mr.set_tf(state, o, p, tf)
        state = step(state, steps[k])
        out.append((state.graph.poses.numpy(),
                    state.graph.pose_count.numpy(),
                    state.graph.overflow.numpy()))
    return cfg.capacity.max_poses_per_robot, out


def main(n_steps: int, port: bool):
    import torch
    torch.set_num_threads(1)
    cfg, steps, tfs, truth, odom = chip_smoke.spmd_team_inputs("cpu")
    t0 = time.perf_counter()
    P, out = (_port_run if port else _jax_run)(cfg, steps, tfs, n_steps)
    rows = {}
    for k in range(9, n_steps, 10):
        poses, counts, overflow = out[k]
        own, od = [], []
        for r in range(3):
            est = poses[r, r * P:r * P + counts[r, r]]
            own.append(synthetic.ate_rmse(est, truth[r][:len(est)],
                                          align=False))
            od.append(synthetic.ate_rmse(odom[r][:len(est)],
                                         truth[r][:len(est)], align=False))
        rows[k + 1] = dict(own_ate_m=own, odometry_ate_m=od,
                           pose_count=counts.tolist(),
                           overflow=overflow.tolist())
    print(json.dumps({"package": "slide_slam_tpu_torch (CPU)" if port
                      else "slide_slam_tpu (JAX, CPU)", "steps": n_steps,
                      "after_step": rows,
                      "host_seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=50)
    ap.add_argument("--port", action="store_true")
    a = ap.parse_args()
    main(a.n_steps, a.port)

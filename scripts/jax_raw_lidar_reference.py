"""The JAX package on the raw-LiDAR solo mission that chip_smoke.py runs
through the PyTorch port (phase slice:raw_lidar_solo), on the CPU; or, with
--port, the port itself on the CPU on the same mission.

Same world, trajectory, odometry and scans (slide_slam_tpu_torch.io.
synthetic.make_lidar_mission, numpy only), the LidarFrontend with the
ground-truth labeller and the forest classes, and the SlamNode with the
forest config at mission capacity. Prints one JSON line: ATE of the
optimized trajectory and of the odometry, landmark counts, overflow
counters. chip_smoke.py's ATE bound is set from this output (PERF.md).

--urban runs chip_smoke.py's phase slice:urban_lidar_solo instead: the
same world with 15 cars (make_lidar_mission(n_cars=15)), the outdoor
classes with the car branch (PipelineConfig()), and the urban capacity
(chip_smoke.urban_capacity).

--unified runs either package with SolverConfig(use_schur=False), the
unified-variable solve (chip_smoke.py's phase slice:unified_solo), and
--snapshots K1,K2,... records, after each of those keyframe counts, the
optimized trajectory's ATE so far, the map's median root error (each
mapped cylinder root's XY distance to the nearest true one) and the
landmark counts.

--oracle then runs the package's own f64 reference solver
(factorgraph/reference_solver.solve_reference, Levenberg-Marquardt to
convergence) on the final graph state and adds its RMS and max position gap
to the engine's estimate, the costs at the estimate and at the optimum, the
optimum's ATE, its seconds and iterations (chip_smoke.oracle_gaps);
chip_smoke.py's check:reference_oracle holds the card's gap to 1.25 x the
JAX package's.

--port --jax-draws feeds the port's RANSAC ground fits the JAX package's
own draws (jax.random.PRNGKey(0)), so the two packages fit the same
hypotheses; --out writes the per-keyframe cylinder and cuboid measurement
counts and landmark counts, and --compare A.json B.json lists the keyframes
where two such files differ.

    JAX_PLATFORMS=cpu python scripts/jax_raw_lidar_reference.py [n_keyframes]
        [--urban] [--unified] [--snapshots 31,32] [--port [--jax-draws]]
        [--oracle] [--out counts.json]
    python scripts/jax_raw_lidar_reference.py --compare A.json B.json
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


def jax_ransac_draws(n_rows: int, n_hypotheses: int) -> np.ndarray:
    """The draws slide_slam_tpu's fit_plane_ransac makes with seed 0."""
    import jax
    import jax.numpy as jnp
    return np.array(jax.random.randint(
        jax.random.PRNGKey(0), (n_rows, n_hypotheses, 3), 0,
        jnp.iinfo(jnp.int32).max))


def _solver(config, cfg, unified):
    if not unified:
        return cfg
    import dataclasses
    return cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                  use_schur=False))


def _root_errors(node, world):
    n = node.landmark_counts()["cylinders"]
    roots = np.asarray(node.state.cyl_root[:n])
    return [float(np.linalg.norm(world.cyl_root[:, :2] - r[:2], axis=1).min())
            for r in roots]


def _capacity(config, urban):
    if urban:
        return chip_smoke.urban_capacity(config)
    return config.mission_capacity(150, n_cylinders=140)


def _jax_parts(m, holder, urban, unified=False):
    from slide_slam_tpu import config
    from slide_slam_tpu.frontend import lidar_pipeline as jlp
    from slide_slam_tpu.frontend import pipeline as jpipe
    from slide_slam_tpu.runtime.node import SlamNode
    classes = [c for c in jpipe.outdoor_classes()
               if urban or c.model != "cuboid"]
    frontend = jlp.LidarFrontend(
        jlp.ground_truth_segmenter(m.world, lambda: holder["pose"]),
        jlp.LidarFrontendConfig(64, 1024, desired_period=0.0),
        jpipe.PipelineConfig(classes=classes))
    cfg = config.forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=_capacity(config, urban))
    return frontend, SlamNode(_solver(config, cfg, unified), robot_id=0)


def _port_parts(m, holder, draws, urban, unified=False):
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.frontend import lidar_pipeline as tlp
    from slide_slam_tpu_torch.frontend import pipeline as tpipe
    from slide_slam_tpu_torch.runtime.node import SlamNode
    frontend = tlp.LidarFrontend(
        tlp.ground_truth_segmenter(m.world, lambda: holder["pose"]),
        tlp.LidarFrontendConfig(64, 1024, desired_period=0.0),
        tpipe.PipelineConfig(classes=tpipe.outdoor_classes() if urban
                             else tpipe.forest_classes()), device="cpu",
        ransac_draws=draws)
    cfg = config.forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=_capacity(config, urban))
    return frontend, SlamNode(_solver(config, cfg, unified), robot_id=0,
                              device="cpu")


def compare(a_path: str, b_path: str):
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    diff = [dict(keyframe=i, a=(ma, la), b=(mb, lb))
            for i, (ma, la, mb, lb) in enumerate(zip(
                a["measurements"], a["landmarks"], b["measurements"],
                b["landmarks"]))
            if (ma, la) != (mb, lb)]
    a["measurements"], b["measurements"] = (
        np.asarray(x["measurements"]).reshape(len(x["measurements"]), -1)
        for x in (a, b))
    print(json.dumps({"a": a["package"], "b": b["package"],
                      "keyframes": min(len(a["measurements"]),
                                       len(b["measurements"])),
                      "measurements": [a["measurements"].sum(0).tolist(),
                                       b["measurements"].sum(0).tolist()],
                      "landmarks": [a["landmarks"][-1], b["landmarks"][-1]],
                      "differing_keyframes": diff}))


def oracle(node, traj, port):
    """The package's f64 reference solver on the node's final state."""
    if port:
        from slide_slam_tpu_torch.factorgraph import reference_solver as rs
    else:
        from slide_slam_tpu.factorgraph import reference_solver as rs
    cfg = node.cfg
    state = node.state._replace(**{k: np.asarray(getattr(node.state, k))
                                   for k in node.state._fields})
    t0 = time.perf_counter()
    conv, info = rs.solve_reference(state, cyl_sigma=cfg.noise.cylinder,
                                    bearing_sigma=cfg.noise.bearing)
    seconds = time.perf_counter() - t0
    return chip_smoke.oracle_gaps(np.asarray(node.optimized_trajectory()),
                                  conv, info, seconds, traj)


def main(n_keyframes: int = 150, port: bool = False, jax_draws: bool = False,
         out: str = None, urban: bool = False, unified: bool = False,
         snapshots=(), with_oracle: bool = False):
    m = synthetic.make_lidar_mission(
        n_keyframes=n_keyframes, n_cars=chip_smoke.URBAN_CARS if urban else 0)
    holder = {"pose": m.traj[0]}
    if port:
        frontend, node = _port_parts(
            m, holder, jax_ransac_draws if jax_draws else None, urban,
            unified)
        package = ("slide_slam_tpu_torch (CPU, "
                   f"{'JAX' if jax_draws else 'torch.Generator'} RANSAC draws)")
    else:
        frontend, node = _jax_parts(m, holder, urban, unified)
        package = "slide_slam_tpu (JAX, CPU)"
    t0 = time.perf_counter()
    per_meas, per_lm, at = [], [], {}
    for i, scan in enumerate(m.scans):
        holder["pose"] = m.traj[i]
        stamp = 1000.0 + 0.5 * i
        obs = frontend.process_scan(stamp, scan, np.zeros(len(scan),
                                                          np.float32),
                                    m.odom[i])
        per_meas.append([len(obs.get("cyl_root", [])),
                         len(obs.get("cub_pose", []))])
        node.process_keyframe(stamp, m.odom[i], obs)
        lm = node.landmark_counts()
        per_lm.append([lm["cylinders"], lm["cuboids"]])
        if i + 1 in snapshots:
            est = np.asarray(node.optimized_trajectory())
            at[i + 1] = dict(
                ate_optimized_m=synthetic.ate_rmse(est, m.traj[:len(est)],
                                                   align=False),
                median_root_error_m=float(np.median(
                    _root_errors(node, m.world))),
                landmarks=lm)
    est = np.asarray(node.optimized_trajectory())
    if out:
        Path(out).write_text(json.dumps({"package": package,
                                         "measurements": per_meas,
                                         "landmarks": per_lm}))
    print(json.dumps({
        "package": package,
        "n_keyframes": n_keyframes,
        "ate_optimized_m": synthetic.ate_rmse(est, m.traj, align=False),
        "ate_odometry_m": synthetic.ate_rmse(m.odom, m.traj, align=False),
        "mission": "urban" if urban else "forest",
        "solver": "unified" if unified else "schur",
        "at_keyframe": at,
        "cylinder_measurements": sum(c for c, _ in per_meas),
        "cuboid_measurements": sum(k for _, k in per_meas),
        "landmarks": node.landmark_counts(),
        "overflow": node.overflow_report(),
        "host_seconds": time.perf_counter() - t0,
        "oracle": oracle(node, m.traj, port) if with_oracle else None,
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_keyframes", type=int, nargs="?", default=150)
    ap.add_argument("--port", action="store_true",
                    help="run slide_slam_tpu_torch on the CPU instead")
    ap.add_argument("--jax-draws", action="store_true",
                    help="with --port: the JAX package's RANSAC draws")
    ap.add_argument("--urban", action="store_true",
                    help="the urban mission (15 cars, the car branch)")
    ap.add_argument("--unified", action="store_true",
                    help="SolverConfig(use_schur=False): the unified solve")
    ap.add_argument("--snapshots", default="",
                    help="keyframe counts to record ATE and root error at")
    ap.add_argument("--oracle", action="store_true",
                    help="the f64 reference solver on the final state")
    ap.add_argument("--out", help="write per-keyframe counts to this file")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and exit")
    a = ap.parse_args()
    if a.compare:
        compare(*a.compare)
    else:
        main(a.n_keyframes, a.port, a.jax_draws, a.out, a.urban, a.unified,
             tuple(int(k) for k in a.snapshots.split(",") if k), a.oracle)

"""The JAX package on the decentralized 3-robot mission that chip_smoke.py
runs through the PyTorch port (phase slice:multi_robot_mission), on the
CPU; or, with --port, the port itself on the same mission.

Same world, trajectories, logs and relative measurements (chip_smoke.
mission_setup: the mission of the JAX package's bench.py:222-264, numpy
data made from seed 7), the same config (3 robots, mission_capacity(150),
realtime_solver, intra frequency 0.2, cylinder sigma 10), the input manager
and run(intra_lc=True). Runs the mission once in the synchronous runtime
and once with the async worker pool (the mode chip_smoke.py runs), unless
--mode picks one, and prints one JSON line per run: kf/s, per-robot and
mean stamp-matched ATE, odometry ATE, intra/inter closure counts, merged
robot pairs, relative factors, landmarks, overflow. chip_smoke.py's merged
pairs and ATE bound come from the async run (PERF.md).

--out F.json also writes each run's trajectories; --compare A.json B.json
lists where two such files differ (decisions and counts exactly, poses by
the largest gap).

    JAX_PLATFORMS=cpu python scripts/jax_mission_reference.py
        [--mode sync|async|both] [--keyframes N] [--out F.json]
    python scripts/jax_mission_reference.py --port [--device cpu] ...
    python scripts/jax_mission_reference.py --compare A.json B.json
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from slide_slam_tpu_torch.io import synthetic as port_synthetic  # noqa: E402


def _jax_mission(n_keyframes, async_runtime):
    from slide_slam_tpu import config
    from slide_slam_tpu.io import synthetic
    from slide_slam_tpu.runtime import profiling, scheduler
    from slide_slam_tpu.runtime.mission import MultiRobotMission

    def rel_fn(logs, rng):
        # the JAX package's own RelativeMeas type, same numbers
        return [(rid, scheduler.RelativeMeas(**vars(m)))
                for rid, m in port_synthetic.relative_measurements(logs, rng)]

    cfg, trajs, logs, rel = chip_smoke.mission_setup(config, synthetic,
                                                     rel_fn, n_keyframes)
    mission = MultiRobotMission(cfg, logs, relative_meas=rel,
                                use_input_manager=True,
                                async_runtime=async_runtime)
    return mission, trajs, logs, profiling


def _port_mission(n_keyframes, async_runtime, device):
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.runtime import profiling
    from slide_slam_tpu_torch.runtime.mission import MultiRobotMission

    cfg, trajs, logs, rel = chip_smoke.mission_setup(
        config, port_synthetic, port_synthetic.relative_measurements,
        n_keyframes)
    mission = MultiRobotMission(cfg, logs, relative_meas=rel,
                                use_input_manager=True,
                                async_runtime=async_runtime, device=device)
    return mission, trajs, logs, profiling


def run(args, mode):
    if args.port:
        mission, trajs, logs, profiling = _port_mission(
            args.keyframes, mode == "async", args.device)
    else:
        mission, trajs, logs, profiling = _jax_mission(args.keyframes,
                                                       mode == "async")
    profiling.phase_reset()
    t0 = time.perf_counter()
    report = mission.run(intra_lc=True)
    wall = time.perf_counter() - t0
    out = chip_smoke.mission_summary(report.nodes, logs, trajs, wall)
    out.update(package="port" if args.port else "jax", mode=mode,
               phase_ms=profiling.phase_report())
    print(json.dumps({k: v for k, v in out.items()}), flush=True)
    out["trajectories"] = [n.optimized_trajectory().tolist()
                           for n in report.nodes]
    return out


def compare(a_path, b_path):
    a_runs = json.load(open(a_path))
    b_runs = json.load(open(b_path))
    for a, b in zip(a_runs, b_runs):
        print(f"{a['package']}/{a['mode']} vs {b['package']}/{b['mode']}:")
        for key in ("merged_pairs", "intra_lc", "inter_lc",
                    "relative_factors", "landmarks", "overflow_total"):
            same = a[key] == b[key]
            print(f"  {key}: {'same' if same else 'DIFFERENT'}"
                  + ("" if same else f" {a[key]} vs {b[key]}"))
        for r, (ta, tb) in enumerate(zip(a["trajectories"],
                                         b["trajectories"])):
            ta, tb = np.asarray(ta), np.asarray(tb)
            n = min(len(ta), len(tb))
            gap = float(np.abs(ta[:n, 4:7] - tb[:n, 4:7]).max()) if n else 0
            print(f"  robot {r}: {len(ta)} vs {len(tb)} poses, largest "
                  f"position gap {gap:.6f} m, ATE {a['ate_m'][r]:.6f} vs "
                  f"{b['ate_m'][r]:.6f} m")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="both", choices=["sync", "async", "both"])
    p.add_argument("--keyframes", type=int, default=chip_smoke.MISSION_KEYFRAMES)
    p.add_argument("--port", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2)
    args = p.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    modes = ["sync", "async"] if args.mode == "both" else [args.mode]
    runs = [run(args, m) for m in modes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)


if __name__ == "__main__":
    main()

"""Command-line interface of the PyTorch port (twin of slide_slam_tpu/cli.py).

Replaces the reference's roslaunch/tmux layer (multi_robot_utils_launch):

    python -m slide_slam_tpu_torch gen-logs --out data/ --robots 3
    python -m slide_slam_tpu_torch run --logs data/robot0.npz --results results/
    python -m slide_slam_tpu_torch run --logs data/robot0.npz data/robot1.npz \
        --results results/ --prior-tf-known
    python -m slide_slam_tpu_torch eval --traj results/robot0_trajectory.txt \
        --log data/robot0.npz

`run` runs on the card by default (`--device cuda`); `--device cpu` runs the
same mission on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def cmd_gen_logs(args):
    from .io import logs, synthetic

    rng = np.random.default_rng(args.seed)
    world = synthetic.make_forest_world(
        rng, n_trees=args.trees, n_poles=args.poles, n_cars=args.cars,
        extent=args.extent)
    os.makedirs(args.out, exist_ok=True)
    for rid in range(args.robots):
        traj = synthetic.lawnmower_trajectory(
            args.keyframes, extent=args.extent * 0.85, rows=3, step=1.5)
        traj[:, 4] += rid * 7.0
        traj[:, 5] += rid * 5.0
        log = synthetic.make_log(world, traj, robot_id=rid, seed=args.seed + rid,
                                 odom_drift_sigma=args.drift,
                                 t0=1000.0 + 0.0004 * rid)
        path = os.path.join(args.out, f"robot{rid}.npz")
        logs.save_log(path, log)
        print(f"wrote {path} ({len(log.keyframes)} keyframes)")


def cmd_run(args):
    if args.viz:
        raise NotImplementedError(
            "--viz (viz.py) is not ported yet (ROADMAP: queue item "
            "'viz and convert-bag')")
    from .config import SlamConfig, forest_config, indoor_config
    from .io import logs
    from .runtime.mission import MultiRobotMission

    cfg = {"default": SlamConfig(), "forest": forest_config(),
           "indoor": indoor_config()}[args.preset]
    cfg = cfg.replace(number_of_robots=max(len(args.logs), 2),
                      use_slidematch=args.use_slidematch,
                      communication_wait_time=args.comm_wait)
    robot_logs = [logs.load_log(p) for p in args.logs]
    mission = MultiRobotMission(cfg, robot_logs,
                                prior_tf_known=args.prior_tf_known,
                                device=args.device)
    report = mission.run(intra_lc=args.intra_lc, verbose=True)
    os.makedirs(args.results, exist_ok=True)
    summary = {}
    for node in report.nodes:
        rid = node.robot_id
        tpath = os.path.join(args.results, f"robot{rid}_trajectory.txt")
        node.write_trajectory(tpath)
        rpath = os.path.join(args.results, f"robot{rid}_runtime_analysis.txt")
        node.write_runtime_analysis(rpath)
        mpath = os.path.join(args.results, f"robot{rid}_map.txt")
        logs.save_reference_style_map(mpath, node.compact_map())
        summary[rid] = {
            "keyframes": len(node.key_poses),
            "landmarks": node.landmark_counts(),
            "inter_lc": [node.num_attempts_inter, node.num_success_inter],
            "intra_lc": [node.num_attempts_intra, node.num_success_intra],
            "known_tfs": sorted(node.dbm.loop_closure_tf.keys()),
        }
        print(f"robot {rid}: {summary[rid]}")
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def cmd_eval(args):
    from .io import logs, synthetic

    traj = logs.load_trajectory_tum(args.traj)
    log = logs.load_log(args.log)
    truth = np.stack([k.true_pose for k in log.keyframes])
    est = np.concatenate(
        [traj[:, 1:4], traj[:, 4:8]], axis=1)  # xyz + quat(xyzw)
    n = min(len(est), len(truth))
    ate = synthetic.ate_rmse(est[:n, 0:3], truth[:n, 4:7], align=args.align)
    print(json.dumps({"ate_rmse_m": round(float(ate), 4), "n": n}))


def cmd_convert_bag(args):
    raise NotImplementedError(
        "convert-bag (io/rosbag.py) is not ported yet (ROADMAP: queue item "
        "'viz and convert-bag')")


def main(argv=None):
    p = argparse.ArgumentParser(prog="slide_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-logs", help="generate synthetic measurement logs")
    g.add_argument("--out", required=True)
    g.add_argument("--robots", type=int, default=3)
    g.add_argument("--keyframes", type=int, default=120)
    g.add_argument("--trees", type=int, default=120)
    g.add_argument("--poles", type=int, default=20)
    g.add_argument("--cars", type=int, default=15)
    g.add_argument("--extent", type=float, default=45.0)
    g.add_argument("--drift", type=float, default=0.01)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(func=cmd_gen_logs)

    r = sub.add_parser("run", help="run single/multi-robot SLAM on logs")
    r.add_argument("--logs", nargs="+", required=True)
    r.add_argument("--results", default="results")
    r.add_argument("--preset", default="default",
                   choices=["default", "forest", "indoor"])
    r.add_argument("--prior-tf-known", action="store_true")
    r.add_argument("--use-slidematch", action="store_true")
    r.add_argument("--intra-lc", action="store_true")
    r.add_argument("--comm-wait", type=float, default=5.0)
    r.add_argument("--viz", action="store_true",
                   help="not ported yet: raises")
    r.add_argument("--device", default="cuda",
                   help="torch device of the graphs (default cuda)")
    r.set_defaults(func=cmd_run)

    c = sub.add_parser("convert-bag",
                       help="convert a ROS1 bag of SemanticMeasSyncOdom "
                            "messages to an npz measurement log (not "
                            "ported yet: raises)")
    c.add_argument("--bag", required=True)
    c.add_argument("--out", default="robot0.npz")
    c.add_argument("--robot-id", type=int, default=0)
    c.add_argument("--topic", default=None)
    c.add_argument("--list", action="store_true",
                   help="list topics/types in the bag and exit")
    c.set_defaults(func=cmd_convert_bag)

    e = sub.add_parser("eval", help="ATE of a trajectory file vs log ground truth")
    e.add_argument("--traj", required=True)
    e.add_argument("--log", required=True)
    e.add_argument("--align", action="store_true")
    e.set_defaults(func=cmd_eval)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()

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


def _trace_node_class(node_cls, sink):
    """Wrap the node's decision points so each appends one event to `sink`:
    keyframes (pose count, landmark counts, host pose), replays, inter
    searches (map sizes, TFs found), TF acceptances, intra closures and
    relative factors, in the order the mission makes them."""
    def wrap(name, record):
        inner = getattr(node_cls, name)

        def method(self, *a, **kw):
            out = inner(self, *a, **kw)
            ev = record(self, out, *a, **kw)
            if ev is not None:
                ev.update(ev=name, r=int(self.robot_id),
                          n=len(self.key_poses))
                sink.append(ev)
            return out
        setattr(node_cls, name, method)

    def landmarks(self, out, *a, **kw):
        return dict(lm=self.landmark_counts(),
                    pose=[float(v) for v in self.key_poses[-1][4:7]])

    def search(self, out, peers, peer_maps, ref_map, *_):
        return dict(ref=len(ref_map),
                    peers={int(p): len(peer_maps[p]) for p in peers},
                    found={int(k): [float(v) for v in t]
                           for k, t in out.items()})

    wrap("process_keyframe", landmarks)
    wrap("process_keyframe_batch", landmarks)
    wrap("replay_peers", lambda self, out: dict(lm=self.landmark_counts()))
    wrap("_inter_search", search)
    wrap("_apply_inter_result",
         lambda self, out, found: dict(accepted=[int(i) for i in out]))
    wrap("_apply_intra_result", lambda self, out, res: dict(ok=bool(out)))
    wrap("_process_relative_factors",
         lambda self, out: dict(added=int(out)) if out else None)


class _Dumped(Exception):
    pass


def _port_state_numpy(state):
    from slide_slam_tpu_torch.convert import state_to_numpy
    return state_to_numpy(state)


def _dump_before_full_solve(node_cls, robot, keyframe, path, to_numpy):
    """Make robot `robot`'s first periodic full solve at or after keyframe
    `keyframe` write the graph state it is given (numpy arrays, compressed)
    to `path` and stop the mission."""
    inner = node_cls._maybe_full_solve

    def method(self, k=1):
        every = self.cfg.solver.full_solve_every
        if (self.robot_id == robot and len(self.key_poses) >= keyframe
                and every and self._kf_since_full_solve + k >= every):
            np.savez_compressed(path, **to_numpy(self.state))
            raise _Dumped
        return inner(self, k)
    node_cls._maybe_full_solve = method


def compare_traces(a_path, b_path, pose_tol=1e-2):
    """Print the first event where two traces differ in a decision or a
    count, and the largest host-pose gap up to there."""
    a = [json.loads(line) for line in open(a_path)]
    b = [json.loads(line) for line in open(b_path)]
    gap = 0.0
    for i, (ea, eb) in enumerate(zip(a, b)):
        pa, pb = ea.pop("pose", None), eb.pop("pose", None)
        fa = {k: v for k, v in ea.get("found", {}).items()}
        fb = {k: v for k, v in eb.get("found", {}).items()}
        ea["found"], eb["found"] = sorted(fa), sorted(fb)
        if ea != eb:
            print(f"first difference at event {i} (largest host-pose gap "
                  f"before it {gap:.6f} m):\n  A {ea}\n  B {eb}")
            for k in set(fa) & set(fb):
                print(f"  TF to {k}: {fa[k]} vs {fb[k]}")
            return i
        if pa is not None:
            gap = max(gap, float(np.abs(np.subtract(pa, pb)).max()))
        for k in set(fa) & set(fb):
            gap_tf = float(np.abs(np.subtract(fa[k][4:7], fb[k][4:7])).max())
            if gap_tf > pose_tol:
                print(f"event {i}: TF to {k} differs by {gap_tf:.4f} m")
    print(f"no difference in {min(len(a), len(b))} events "
          f"({len(a)} vs {len(b)}); largest host-pose gap {gap:.6f} m")
    return None


def run(args, mode):
    if args.port:
        mission, trajs, logs, profiling = _port_mission(
            args.keyframes, mode == "async", args.device)
    else:
        mission, trajs, logs, profiling = _jax_mission(args.keyframes,
                                                       mode == "async")
    trace = []
    if args.trace:
        _trace_node_class(type(mission.nodes[0]), trace)
    if args.dump_full_solve:
        robot, keyframe, path = args.dump_full_solve
        _dump_before_full_solve(
            type(mission.nodes[0]), int(robot), int(keyframe), path,
            lambda s: {k: np.asarray(getattr(s, k)) for k in s._fields}
            if not args.port else _port_state_numpy(s))
    profiling.phase_reset()
    t0 = time.perf_counter()
    try:
        report = mission.run(intra_lc=True)
    except _Dumped:
        print(f"wrote the state before robot {robot}'s full solve to {path}")
        return None
    wall = time.perf_counter() - t0
    out = chip_smoke.mission_summary(report.nodes, logs, trajs, wall)
    out.update(package="port" if args.port else "jax", mode=mode,
               phase_ms=profiling.phase_report())
    print(json.dumps({k: v for k, v in out.items()}), flush=True)
    out["trajectories"] = [n.optimized_trajectory().tolist()
                           for n in report.nodes]
    if args.trace:
        with open(f"{args.trace}.{mode}.jsonl", "w") as f:
            f.writelines(json.dumps(ev) + "\n" for ev in trace)
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
    p.add_argument("--trace", help="write each run's decision events to "
                   "TRACE.<mode>.jsonl")
    p.add_argument("--compare-trace", nargs=2)
    p.add_argument("--dump-full-solve", nargs=3,
                   metavar=("ROBOT", "KEYFRAME", "PATH"),
                   help="write the graph state before ROBOT's first periodic "
                   "full solve at or after KEYFRAME to PATH (.npz) and stop")
    args = p.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if args.compare_trace:
        compare_traces(*args.compare_trace)
        return
    modes = ["sync", "async"] if args.mode == "both" else [args.mode]
    runs = [run(args, m) for m in modes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f)


if __name__ == "__main__":
    main()

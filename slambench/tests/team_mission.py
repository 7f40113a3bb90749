"""The closure and merge decisions of a small mission of the port on the
CPU, kept as the inputs each decision was made from, so that the team
judge's tests replay them through the program without running the mission.

The mission is tests/test_torch_mission.py's world (40 trees, 6 poles, 4
cars) with two robots of 50 keyframes, run synchronously: robot 0 drives
1.5 laps of a loop, robot 1 a lawnmower. Robot 1 discovers robot 0 by
SlideMatch and robot 0 robot 1 by SlideGraph, each merge confirmed by a
second detection and polished; then one intra search on robot 0's second
pass of its loop follows, against the map of its first. Kept per search
its host inputs, per merge call the transforms found and the peers held,
per polish the two maps.

    python slambench/tests/team_mission.py   # writes data/team_mission.npz
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "data", "team_mission.npz")
KEYFRAMES = 50
INTRA_QUERIES = (44,)
# a candidate lies this many keyframes before its query at least
INTRA_GAP = 20


def _mission(synthetic, config):
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=40, n_poles=6,
                                        n_cars=4, extent=25.0)
    trajs = [synthetic.loop_trajectory(KEYFRAMES, radius=9.0, laps=1.5),
             synthetic.lawnmower_trajectory(KEYFRAMES, extent=20.0, rows=3,
                                            step=1.2)]
    logs = [synthetic.make_log(world, t, robot_id=r, seed=5 + r,
                               odom_drift_sigma=0.01, pos_noise=0.03)
            for r, t in enumerate(trajs)]
    rel = synthetic.relative_measurements(logs, rng, max_dist=15.0,
                                          period=4)
    cfg = config.SlamConfig(number_of_robots=2,
                            capacity=config.CapacityConfig(
                                max_poses_per_robot=64, max_cylinders=256,
                                max_cuboids=64, max_points=64,
                                max_scan_objects=48,
                                max_cylinder_factors=4096,
                                max_cuboid_factors=1024,
                                max_point_factors=1024,
                                max_between_factors=64))
    return cfg, logs, rel


def record() -> dict:
    """Run the mission under a capture: the capture's record."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from slambench.drivers import team_capture
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.place_recognition import slidegraph, slidematch
    from slide_slam_tpu_torch.runtime import node
    from slide_slam_tpu_torch.runtime.mission import MultiRobotMission
    torch.set_num_threads(1)
    cap = team_capture.Capture().install(slidematch, slidegraph, node)
    try:
        cfg, logs, rel = _mission(synthetic, config)
        mission = MultiRobotMission(cfg, logs, relative_meas=rel,
                                    async_runtime=False,
                                    use_input_manager=True, device="cpu")
        mission.by_id[1].cfg = cfg.replace(use_slidematch=True)
        n0 = mission.run(intra_lc=True).nodes[0]
        chain = n0.optimized_trajectory()
        rows = n0.compact_map()
        packets = n0.dbm.host_record().packets
        for q in INTRA_QUERIES:
            far = np.linalg.norm(chain[:, 4:7] - chain[q, 4:7], axis=1)
            far[q - INTRA_GAP:] = np.inf
            c = int(np.argmin(far))
            submap = node.SlamNode._submap_from_rows(rows, chain[c, 4:7],
                                                     cfg.lc_submap_radius)
            n0.place_recognition.find_intra_loop_closure(
                node.SlamNode.packet_measurement_rows(packets[q]), submap,
                chain[q], chain[c])
    finally:
        cap.close()
    return cap.rec


def save(rec: dict, path: str = PATH):
    """The inputs of `rec` to an .npz: arrays under their own keys, the
    rest as JSON under `manifest`."""
    arrays, searches, merges, refines = {}, [], [], []
    for i, s in enumerate(rec["searches"]):
        ins = {}
        for k, v in s["inputs"].items():
            if isinstance(v, np.ndarray):
                arrays[f"s{i}.{k}"] = v
            else:
                ins[k] = v
        searches.append(dict(kind=s["kind"], scalars=ins,
                             arrays=sorted(k for k, v in s["inputs"].items()
                                           if isinstance(v, np.ndarray))))
    for i, m in enumerate(rec["merges"]):
        for j, (rid, tf) in enumerate(m["found"]):
            arrays[f"m{i}.found{j}"] = tf
        merges.append(dict(node=m["node"], instance=m["instance"],
                           known=m["known"],
                           found=[rid for rid, _ in m["found"]]))
    for i, r in enumerate(rec["refines"]):
        for k in ("tf_in", "own", "peer_map"):
            arrays[f"r{i}.{k}"] = r[k]
        refines.append(dict(node=r["node"], instance=r["instance"],
                            peer=r["peer"]))
    manifest = json.dumps(dict(searches=searches, merges=merges,
                               refines=refines))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, manifest=np.array(manifest), **arrays)


def load(path: str = PATH) -> dict:
    """What `save` wrote, in the capture's form (inputs only)."""
    with np.load(path, allow_pickle=False) as z:
        man = json.loads(str(z["manifest"]))
        a = {k: z[k] for k in z.files if k != "manifest"}
    searches = []
    for i, s in enumerate(man["searches"]):
        inputs = dict(s["scalars"])
        inputs.update({k: a[f"s{i}.{k}"] for k in s["arrays"]})
        searches.append(dict(kind=s["kind"], inputs=inputs))
    merges = [dict(node=m["node"], instance=m["instance"], known=m["known"],
                   found=[(rid, a[f"m{i}.found{j}"])
                          for j, rid in enumerate(m["found"])])
              for i, m in enumerate(man["merges"])]
    refines = [dict(r, **{k: a[f"r{i}.{k}"]
                          for k in ("tf_in", "own", "peer_map")})
               for i, r in enumerate(man["refines"])]
    return dict(searches=searches, merges=merges, refines=refines)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    save(record())
    print(PATH, os.path.getsize(PATH), "bytes")

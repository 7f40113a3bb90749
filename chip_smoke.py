#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (it refuses to run without one; there is no CPU
fallback) and the CUDA toolkit's nvcc. Imports nothing of JAX or of the JAX
package. Phases, each of which fails the run:

1. build            compile every hand-written kernel from csrc/ (one nvcc
                    per source, all started together) and print the seconds;
2. kernel:dbscan    the DBSCAN kernel against its plain PyTorch version on
                    the card, labels exactly equal, at N = 1024: each of the
                    largest keyframe's four problems and a > 64-hop chain
                    alone (one stage), and the keyframe's [2, 1024] batch in
                    the one two-stage launch the frontend makes (also with
                    the chain as a third set); kernel
                    times from CUDA graphs (no host in the way), the
                    empty-kernel floor of the same launch shape, the plain
                    version's time and the card's bound for the same work;
3. slice:raw_lidar_solo  the raw-LiDAR single-robot mission at full width
                    (120 trees + 20 poles, 150 keyframes, 64x1024 range
                    image, forest config at mission capacity) through
                    LidarFrontend -> SlamNode.process_keyframe, with the
                    launch counts reset just before and read just after:
                    one DBSCAN launch per keyframe with a clustered class;
4. card_vs_cpu      the first 8 keyframes again with device="cpu": match
                    indices identical, poses within 1e-3;
5. slice:multi_robot_mission  the decentralized mission of the JAX package's
                    bench.py:222-264 at full width (3 robots x 150
                    keyframes, 110 trees, mission_capacity(150), input
                    manager, async worker pool, intra-LC, SlideGraph/CLIPPER
                    merges, relative factors) through MultiRobotMission.run
                    on the card, after one untimed SlideMatch/CLIPPER
                    warm-up: overflow 0, merged robot pairs equal to the JAX
                    run's, mean ATE <= 1.25 x the JAX run's; no DBSCAN
                    launch (the path reads measurement logs);
6. card_vs_cpu:mission  the 2-robot x 50-keyframe sync mission of
                    tests/test_torch_mission.py on the card and on the CPU:
                    decisions and counts identical, own chains within
                    3 cm, replayed peer chains within 4 cm, per-robot ATE
                    within 1 cm (the card's run-to-run spread: see
                    CARD_VS_CPU_OWN_TOL).

Prints a {"kernels": [...]} line, the card's name and power limit, and last
the line {"ok": true, "device": {...}}. In the kernels line, `launches` is
the raw-LiDAR mission's DBSCAN launch count (one per scan; the multi-robot
mission's count, 0, is under `launches_by_path`), `ms` the device time of
one per-scan launch (both classes, both stages) of the largest keyframe,
`floor_ms` an empty kernel's of the same launch shape, `plain_ms` the plain
version's time for the same batch on the card, `bound_ms` the card's least
time for the four problems' work.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_M = 7.55          # 1.25 x the JAX package's 6.042 m on this mission
POSE_TOL = 1e-3             # card vs CPU: f32 sums in another order
F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
CARD_VS_CPU_KEYFRAMES = 8
MISSION_KEYFRAMES = 150     # per robot, 3 robots
# scripts/jax_mission_reference.py, the JAX package in the async runtime on
# the CPU (PERF.md): every robot merges with both peers, mean ATE 0.154663 m
MISSION_MERGED_PAIRS = [[0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]]
MISSION_ATE_BOUND_M = 0.1933  # 1.25 x 0.154663 m
# card vs CPU on the small mission. The CPU parity test
# (tests/test_torch_mission.py) holds the port to the JAX package within
# 1 cm on own chains and 2.5 cm on replayed peer chains; the card cannot be
# held to that: its atomic scatter sums add in another order on every run,
# and two plain card runs alone land 10.2 mm apart on an own chain. Over
# eight card runs (scripts/mission_card_spread.py and chip_smoke.py, PERF.md)
# the largest gaps to the CPU run were 16.6 mm (own) and 18.8 mm (peer),
# per-robot ATE within 4.7 mm; the bounds keep ~1.8x of margin. Decisions
# and counts must be identical.
CARD_VS_CPU_OWN_TOL = 3e-2
CARD_VS_CPU_PEER_TOL = 4e-2
CARD_VS_CPU_ATE_TOL = 1e-2


class PhaseError(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
def phase_build():
    from slide_slam_tpu_torch import kernels
    t0 = time.perf_counter()
    libs = kernels.build_all(["dbscan"], verbose=True)
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s")


def dbscan_work(points, valid, eps, min_samples, max_iters=64):
    """Operations the DBSCAN function needs on these inputs (data-dependent
    part counted from the plain algorithm): per valid pair 8 flops of d2
    and one compare; per executed sweep one min per core-core edge; one min
    per border-core edge."""
    import torch
    from slide_slam_tpu_torch.frontend.clustering import _eps2
    d = points[:, None, :] - points[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    nbr = valid[:, None] & valid[None, :] & (d2 <= float(_eps2(eps)))
    core = valid & (nbr.sum(1) >= min_samples)
    core_edge = nbr & core[:, None] & core[None, :]
    n = points.shape[0]
    lab = torch.where(core, torch.arange(n, device=points.device), n + 1)
    sweeps = 0
    for _ in range(max_iters):
        new = torch.minimum(lab, torch.where(core_edge, lab[None, :],
                                             n + 1).min(1).values)
        sweeps += 1
        if bool((new == lab).all()):
            break
        lab = new
    nv = int(valid.sum())
    border_edges = int((nbr & core[None, :] & ~core[:, None]).sum())
    return 9 * nv * nv + sweeps * int(core_edge.sum()) + border_edges


def slice_inputs(mission, k):
    """The tree and lightpole class points of keyframe k as the pipeline
    sees them (world frame through the odometry pose, labels of the
    simulator labeller), padded to 1024."""
    from slide_slam_tpu_torch.frontend.lidar_pipeline import \
        _nearest_object_label
    from slide_slam_tpu_torch.geometry import se3np
    scan = mission.scans[k]
    labels = _nearest_object_label(
        mission.world, se3np.apply(mission.traj[k], scan))
    world = se3np.apply(mission.odom[k], scan)
    out = {}
    for name, lab in (("tree", 8), ("lightpole", 9)):
        pts = world[labels == lab][:1024]
        pad = np.zeros((1024, 3), np.float32)
        pad[:len(pts)] = pts
        valid = np.zeros(1024, bool)
        valid[:len(pts)] = True
        out[name] = (pad, valid)
    return out


def graph_ms(fn, per_graph=20, reps=10):
    """Device time per call of `fn`, with no host in the way: `per_graph`
    calls captured in one CUDA graph, replayed `reps` times between two
    events. `fn` must not copy from the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # first launch sets the kernel's attributes
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


def dbscan_bound(ops, nbytes):
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel(mission):
    """The kernel against the plain version on the card: each of the largest
    keyframe's four DBSCAN problems (and the chain) alone, one stage, and the
    keyframe's [2, 1024] batch in the one two-stage launch the frontend
    makes, labels exactly equal. Times from CUDA graphs (kernel) and
    events around eager calls (plain), the empty-kernel floor of the same
    launch shape, and the card's bound for the same work."""
    import torch
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.pipeline import forest_classes

    # keyframe with the largest tree class
    k = max(range(len(mission.scans)), key=lambda i: len(mission.scans[i]))
    inputs = slice_inputs(mission, k)
    specs = {c.name: c for c in forest_classes() if c.model == "cylinder"}
    cuda = lambda a: torch.as_tensor(a, device="cuda")
    problems, batch = [], []
    for name, (pad, valid) in inputs.items():
        s = specs[name]
        p, v = cuda(pad), cuda(valid)
        params = clustering.stage_params(s.eps_noise, s.min_samples_noise,
                                         s.eps_cluster, s.min_samples_cluster)
        batch.append((p, v, cuda(params)))
        problems.append((f"{name}/noise", p, v, s.eps_noise,
                         s.min_samples_noise))
        lab1 = clustering.dbscan_reference(p, v, s.eps_noise,
                                           s.min_samples_noise)
        problems.append((f"{name}/cluster", p, v & (lab1 >= 0),
                         s.eps_cluster, s.min_samples_cluster))
    chain = np.zeros((1024, 3), np.float32)
    chain[:, 0] = 40.0 + 0.5 * np.arange(1024)
    problems.append(("chain>64hops", cuda(chain),
                     torch.ones(1024, dtype=torch.bool, device="cuda"), 0.6,
                     2))

    rows, max_err = [], 0
    for name, p, v, eps, ms in problems:
        got = clustering.dbscan_cuda(p, v, eps, ms)
        ref = clustering.dbscan_reference(p, v, eps, ms)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
        check(torch.equal(got, ref),
              f"dbscan kernel != plain on {name}: {int((got != ref).sum())} "
              "labels differ")
        one = cuda(clustering.stage_params(eps, ms))[None]
        k_ms = graph_ms(lambda: clustering.launch_dbscan(
            p[None], v[None], one, stages=1))
        p_ms = cuda_ms(lambda: clustering.dbscan_reference(p, v, eps, ms), 5)
        ops = dbscan_work(p, v, eps, ms)
        bound, by = dbscan_bound(ops, 1024 * (12 + 1 + 4) + 16)
        rows.append(dict(problem=name, valid=int(v.sum()), kernel_ms=k_ms,
                         plain_ms=p_ms, bound_ms=bound, bound_by=by, ops=ops))
        print(f"[kernel:dbscan] {name:18s} valid={int(v.sum()):4d} "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
              f"bound {bound:.6f} ms ({by}, {ops} ops)  labels equal")

    # the scan's batch: both classes, both stages, one launch
    pts = torch.stack([b[0] for b in batch])
    valid = torch.stack([b[1] for b in batch])
    params = torch.stack([b[2] for b in batch])
    got = clustering.two_stage_cluster_batch(pts, valid, params)
    ref = clustering.two_stage_cluster_reference(pts, valid, params)
    torch.cuda.synchronize()
    max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
    check(torch.equal(got, ref), "batched dbscan kernel != plain on the "
          f"scan's batch: {int((got != ref).sum())} labels differ")
    # the > 64-hop chain as a third set of a batch, both stages
    _, cp, cv, _, _ = problems[-1]
    three = (torch.stack([pts[0], pts[1], cp]),
             torch.stack([valid[0], valid[1], cv]),
             torch.cat([params, cuda(clustering.stage_params(
                 0.6, 2, 0.6, 2))[None]]))
    got3 = clustering.two_stage_cluster_batch(*three)
    ref3 = clustering.two_stage_cluster_reference(*three)
    torch.cuda.synchronize()
    check(torch.equal(got3, ref3), "batched dbscan kernel != plain with the "
          f"chain: {int((got3 != ref3).sum())} labels differ")
    scan_ms = graph_ms(lambda: clustering.launch_dbscan(pts, valid, params))
    floor_ms = graph_ms(lambda: clustering.launch_empty(len(batch)))
    plain_ms = cuda_ms(lambda: clustering.two_stage_cluster_reference(
        pts, valid, params), 5)
    slice_rows = [r for r in rows if not r["problem"].startswith("chain")]
    ops = sum(r["ops"] for r in slice_rows)
    bound, by = dbscan_bound(ops, pts.numel() * 4 + valid.numel()
                             + params.numel() * 4 + got.numel() * 4)
    cluster = clustering.auto_cluster_size()
    print(f"[kernel:dbscan] scan batch [2, 1024] x 2 stages, one launch "
          f"(cluster {cluster}): kernel {scan_ms:.4f} ms  "
          f"empty-kernel floor {floor_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {bound:.6f} ms ({by}, {ops} ops)  labels equal")
    return dict(max_abs_err=max_err, ms=scan_ms, floor_ms=floor_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, problems=rows)


def run_mission(mission, device, n_keyframes, record):
    import torch
    from slide_slam_tpu_torch.config import forest_config, mission_capacity
    from slide_slam_tpu_torch.frontend.lidar_pipeline import (
        LidarFrontend, LidarFrontendConfig, ground_truth_segmenter)
    from slide_slam_tpu_torch.frontend.pipeline import (PipelineConfig,
                                                        forest_classes)
    from slide_slam_tpu_torch.runtime.node import SlamNode

    holder = {"pose": mission.traj[0]}
    frontend = LidarFrontend(
        ground_truth_segmenter(mission.world, lambda: holder["pose"]),
        LidarFrontendConfig(64, 1024, desired_period=0.0),
        PipelineConfig(classes=forest_classes()), device=device)
    cfg = forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=mission_capacity(150, n_cylinders=140))
    node = SlamNode(cfg, robot_id=0, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for i in range(n_keyframes):
        holder["pose"] = mission.traj[i]
        stamp = 1000.0 + 0.5 * i
        scan = mission.scans[i]
        t0 = time.perf_counter()
        obs = frontend.process_scan(stamp, scan,
                                    np.zeros(len(scan), np.float32),
                                    mission.odom[i])
        t1 = time.perf_counter()
        node.process_keyframe(stamp, mission.odom[i], obs)
        sync()
        t2 = time.perf_counter()
        record(i, node, frontend, obs, t1 - t0, t2 - t1)
    return node, cfg


def phase_slice(mission):
    import torch
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.pipeline import forest_classes
    from slide_slam_tpu_torch.io import synthetic

    min_cluster = {c.name: c.min_samples_cluster for c in forest_classes()
                   if c.model == "cylinder"}
    per_kf = []

    def record(i, node, frontend, obs, fe_s, be_s):
        counts = dict(frontend.pipeline.class_points)
        per_kf.append(dict(
            fe_s=fe_s, be_s=be_s, counts=counts,
            n_meas=len(obs.get("cyl_root", [])),
            expected=int(any(n >= min_cluster[c] for c, n in counts.items())),
            matches=node.last_step.cyl_matches.cpu().numpy(),
            pose=node.last_step.pose.cpu().numpy()))

    n = len(mission.scans)
    torch.cuda.synchronize()
    clustering.launch_dbscan.launches = 0
    t0 = time.perf_counter()
    node, cfg = run_mission(mission, "cuda", n, record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = clustering.launch_dbscan.launches

    every = cfg.solver.full_solve_every
    full_kf = [i for i in range(n) if every and (i + 1) % every == 0]
    be = np.array([r["be_s"] for r in per_kf]) * 1e3
    plain_be = np.delete(be, full_kf)
    est = node.optimized_trajectory()
    ate = synthetic.ate_rmse(est, mission.traj, align=False)
    ate_odom = synthetic.ate_rmse(mission.odom, mission.traj, align=False)
    expected = sum(r["expected"] for r in per_kf)
    max_class = max(max(r["counts"].values()) for r in per_kf)
    cut = sum(max(c - 1024, 0) for r in per_kf for c in r["counts"].values())
    overflow = node.overflow_report()
    stats = dict(
        keyframes=n, wall_s=wall, kf_per_s=n / wall,
        frontend_ms_per_scan=float(np.mean([r["fe_s"] for r in per_kf]) * 1e3),
        keyframe_step_ms_median=float(np.median(plain_be)),
        keyframe_step_ms_mean=float(np.mean(plain_be)),
        full_solve_keyframes=full_kf,
        full_solve_ms=float(np.mean(be[full_kf]) - np.median(plain_be))
        if full_kf else None,
        first_keyframe_ms=float(be[0]),
        max_class_points=int(max_class), points_cut_at_1024=int(cut),
        dbscan_launches=launches, dbscan_launches_expected=int(expected),
        cylinder_measurements=int(sum(r["n_meas"] for r in per_kf)),
        ate_optimized_m=ate, ate_odometry_m=ate_odom,
        landmarks=node.landmark_counts(), overflow=overflow)
    print("[slice:raw_lidar_solo] " + json.dumps(stats))
    check(launches > 0, "the main path launched no DBSCAN kernel")
    check(launches == expected,
          f"DBSCAN launches {launches} != expected {expected}")
    check(sum(overflow.values()) == 0, f"capacity overflow: {overflow}")
    check(math.isfinite(ate) and ate <= ATE_BOUND_M,
          f"ATE {ate} m not finite or above the bound {ATE_BOUND_M} m")
    return stats, per_kf


def phase_card_vs_cpu(mission, card_kf):
    cpu_kf = []

    def record(i, node, frontend, obs, fe_s, be_s):
        cpu_kf.append(dict(matches=node.last_step.cyl_matches.numpy(),
                           pose=node.last_step.pose.numpy()))

    run_mission(mission, "cpu", CARD_VS_CPU_KEYFRAMES, record)
    worst = 0.0
    for i, (a, b) in enumerate(zip(card_kf, cpu_kf)):
        check(np.array_equal(a["matches"], b["matches"]),
              f"keyframe {i}: match indices differ card vs CPU")
        worst = max(worst, float(np.abs(a["pose"] - b["pose"]).max()))
    check(worst <= POSE_TOL, f"card vs CPU pose gap {worst} > {POSE_TOL}")
    print(f"[card_vs_cpu] {CARD_VS_CPU_KEYFRAMES} keyframes: matches "
          f"identical, max pose gap {worst:.3e}")


# ---------------------------------------------------------------------------
# The decentralized multi-robot mission (the JAX package's bench.py:222-264)
# ---------------------------------------------------------------------------
def mission_setup(config, synthetic, relative_measurements,
                  n_keyframes=MISSION_KEYFRAMES):
    """(cfg, trajs, logs, relative measurements) of the 3-robot mission:
    robot 0 drives two laps of a loop, robots 1 and 2 mow overlapping halves
    of a 110-tree forest. `config`/`synthetic` are either package's modules
    (numpy data, the same for both); logs are cut to `n_keyframes` per
    robot while the capacity stays mission_capacity(150)."""
    import dataclasses
    cfg = config.SlamConfig(
        number_of_robots=3, capacity=config.mission_capacity(150),
        solver=config.realtime_solver(),
        intra_robot_place_recognition_frequency=0.2)
    cfg = cfg.replace(noise=dataclasses.replace(cfg.noise, cylinder=10.0))
    rng = np.random.default_rng(7)
    world = synthetic.make_forest_world(rng, n_trees=110, n_poles=18,
                                        n_cars=12, extent=40.0)
    trajs = [
        synthetic.loop_trajectory(150, radius=13.0, laps=2.0),
        synthetic.lawnmower_trajectory(150, extent=32.0, rows=3, step=1.4),
        synthetic.lawnmower_trajectory(150, extent=38.0, rows=4, step=1.4),
    ]
    logs = [synthetic.make_log(world, t, robot_id=r, seed=3 + r,
                               odom_drift_sigma=0.012, pos_noise=0.03,
                               dropout=0.1, yaw_drift_bias=0.0008)
            for r, t in enumerate(trajs)]
    rel = relative_measurements(logs, rng)
    if n_keyframes < 150:
        last = max(log.keyframes[n_keyframes - 1].stamp for log in logs)
        for log in logs:
            log.keyframes = log.keyframes[:n_keyframes]
        rel = [(rid, m) for rid, m in rel if m.stamp <= last]
    return cfg, trajs, logs, rel


def mission_summary(nodes, logs, trajs, wall_s):
    """The mission's end-to-end numbers, from either package's nodes."""
    from slide_slam_tpu_torch.io import synthetic
    ates, odom = [], []
    for node, log, traj in zip(nodes, logs, trajs):
        ates.append(synthetic.stamp_matched_ate(
            node.optimized_trajectory(), node.key_stamps, log, traj))
        n = len(log.keyframes)
        odom.append(synthetic.ate_rmse(
            np.stack([kf.odom_pose for kf in log.keyframes]), traj[:n],
            align=False))
    overflow = {}
    for node in nodes:
        for k, v in node.overflow_report().items():
            overflow[k] = overflow.get(k, 0) + v
    n_kf = sum(len(log.keyframes) for log in logs)
    return dict(
        keyframes=n_kf, wall_s=wall_s, kf_per_s=n_kf / wall_s,
        ate_m=ates, ate_mean_m=float(np.mean(ates)), ate_odometry_m=odom,
        merged_pairs=sorted([node.robot_id, int(peer)] for node in nodes
                            for peer in node.dbm.loop_closure_tf),
        intra_lc=[[node.num_attempts_intra, node.num_success_intra]
                  for node in nodes],
        inter_lc=[[node.num_attempts_inter, node.num_success_inter]
                  for node in nodes],
        relative_factors=[node.num_rel_factors for node in nodes],
        search_s={"intra": [float(sum(n.intra_lc_time)) for n in nodes],
                  "inter": [float(sum(n.inter_lc_time)) for n in nodes]},
        landmarks=[node.landmark_counts() for node in nodes],
        overflow_total=int(sum(overflow.values())),
        overflow={k: v for k, v in overflow.items() if v})


def small_mission(config, synthetic):
    """(cfg, trajs, logs, relative measurements) of the small mission that
    tests/test_torch_mission.py holds against the JAX package: the small
    world of tests/test_mission_runtime.py, 2 robots x 50 keyframes."""
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=40, n_poles=6,
                                        n_cars=4, extent=25.0)
    trajs = [synthetic.loop_trajectory(50, radius=9.0, laps=1.5),
             synthetic.lawnmower_trajectory(50, extent=20.0, rows=3,
                                            step=1.2)]
    logs = [synthetic.make_log(world, t, robot_id=r, seed=5 + r,
                               odom_drift_sigma=0.01, pos_noise=0.03)
            for r, t in enumerate(trajs)]
    rel = synthetic.relative_measurements(logs, rng, max_dist=15.0,
                                          period=4)
    cfg = config.SlamConfig(number_of_robots=2, capacity=config.CapacityConfig(
        max_poses_per_robot=64, max_cylinders=256, max_cuboids=64,
        max_points=64, max_scan_objects=48, max_cylinder_factors=4096,
        max_cuboid_factors=1024, max_point_factors=1024,
        max_between_factors=64))
    return cfg, trajs, logs, rel


def warm_mission_search(cfg, device):
    """One untimed pass of SlideMatch (inter and intra) and of SlideGraph /
    CLIPPER at the association counts a mission reaches, so cuFFT plans and
    the allocator's growth stay out of the timed mission."""
    from slide_slam_tpu_torch.place_recognition import clipper
    from slide_slam_tpu_torch.place_recognition.slidegraph import SlideGraph
    from slide_slam_tpu_torch.place_recognition.slidematch import \
        PlaceRecognition
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    objs = np.zeros((200, 7), np.float32)
    objs[:, 0] = rng.integers(0, 3, 200)
    objs[:, 1:3] = rng.uniform(-35, 35, (200, 2))
    objs[:, 4] = 0.3
    pr = PlaceRecognition(cfg.place_recognition, device=device)
    pr.find_transformation(objs, objs, intra=False)
    pr.find_transformation(objs[:32], objs[:32], intra=True)
    SlideGraph(cfg.slidegraph, device=device).find_inter_loop_closure(objs,
                                                                      objs)
    params = clipper.ClipperParams(sigma=cfg.slidegraph.sigma,
                                   epsilon=cfg.slidegraph.epsilon)
    for m in (50, 100, 200, 400, 900, 1800):
        pts = rng.normal(size=(m, 2)).astype(np.float32)
        clipper.dense_clique_inliers(pts, pts + 0.01, params, device=device)
    return time.perf_counter() - t0, fft_count_gap(cfg, objs, device)


def fft_count_gap(cfg, objs, device):
    """Largest distance of an unrounded FFT raster count to its integer,
    for `objs` matched against themselves over the full yaw range at the
    default raster size: the rounding to integer counts is exact while
    this stays well below 0.5."""
    import torch
    from slide_slam_tpu_torch.place_recognition import slidematch as sm
    dims = sm.SlideMatchDims()
    ref, mask = sm._pad_objects(objs, dims.max_objects, device)
    rb, _ = sm._compact_label_bins(objs[:, 0], objs[:, 0])
    bins = torch.zeros(dims.max_objects, dtype=torch.int32, device=device)
    bins[:len(rb)] = torch.as_tensor(rb, device=device)
    yaws = torch.as_tensor(sm._yaw_candidates(180.0, 15.0, False,
                                              dims.n_yaw), device=device)

    def f32(x):
        return torch.tensor(np.float32(x), device=device)

    raw, _ = sm.raster_counts(dims, ref, mask, ref, mask, bins, bins, yaws,
                              f32(40.0), f32(40.0),
                              f32(cfg.place_recognition.match_threshold_position))
    return float((raw - torch.round(raw)).abs().max())


def run_multi_robot_mission(device, n_keyframes=MISSION_KEYFRAMES):
    """The full-width mission through MultiRobotMission.run on `device`,
    with the DBSCAN launch count set to 0 just before and read just after
    (this path clusters no scan: it reads measurement logs)."""
    import torch
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.runtime import profiling
    from slide_slam_tpu_torch.runtime.mission import MultiRobotMission

    cfg, trajs, logs, rel = mission_setup(
        config, synthetic, synthetic.relative_measurements, n_keyframes)
    warm_s, fft_gap = warm_mission_search(cfg, device)
    mission = MultiRobotMission(cfg, logs, relative_meas=rel,
                                use_input_manager=True, device=device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    profiling.phase_reset()
    clustering.launch_dbscan.launches = 0
    t0 = time.perf_counter()
    report = mission.run(intra_lc=True)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = mission_summary(report.nodes, logs, trajs, wall)
    stats.update(
        dbscan_launches=clustering.launch_dbscan.launches,
        warmup_s=warm_s, fft_count_gap=fft_gap,
        phase_ms=profiling.phase_report(),
        phase_calls=profiling.phase_counts(),
        peak_device_mb=(torch.cuda.max_memory_allocated() / 2**20
                        if cuda else None))
    return stats, report, logs


def check_mission_output(report, logs, device):
    """Every node's graph lives on `device`; each chain is finite, one pose
    per integrated keyframe, and at least as long as the log."""
    import torch
    for node, log in zip(report.nodes, logs):
        check(node.state.poses.device.type == torch.device(device).type,
              f"robot {node.robot_id}'s graph is not on {device}")
        traj = node.optimized_trajectory()
        check(traj.shape == (len(node.key_stamps), 7),
              f"robot {node.robot_id}: trajectory shape {traj.shape}")
        check(len(traj) >= len(log.keyframes),
              f"robot {node.robot_id}: {len(traj)} poses for "
              f"{len(log.keyframes)} keyframes")
        check(bool(np.isfinite(traj).all()),
              f"robot {node.robot_id}: non-finite poses")


def probe_slidegraph(report):
    """Time one SlideGraph search (Delaunay + votes on the host, CLIPPER on
    the card) between the final maps of robots 0 and 1, three times, and
    count its associations."""
    import torch
    from slide_slam_tpu_torch.place_recognition import slidegraph
    nodes = report.nodes
    ref, qry = (m[~((m[:, 1] == 0) & (m[:, 2] == 0))]
                for m in (nodes[0].compact_map(), nodes[1].compact_map()))
    sg = nodes[0].slidegraph
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found, _ = sg.find_inter_loop_closure(ref, qry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tm, sm = slidegraph._triangulate(ref[:, 1:3].astype(np.float64))
    td, sd = slidegraph._triangulate(qry[:, 1:3].astype(np.float64))
    pairs, _, _ = slidegraph.vote_associations(
        tm, sm, td, sd, sg.cfg.descriptor_matching_threshold, 2048)
    return dict(map_rows=[len(ref), len(qry)], associations=len(pairs),
                found=bool(found), search_ms=[t * 1e3 for t in times])


def phase_multi_robot_mission():
    stats, report, logs = run_multi_robot_mission("cuda")
    stats["slidegraph_probe"] = probe_slidegraph(report)
    print("[slice:multi_robot_mission] " + json.dumps(stats))
    check_mission_output(report, logs, "cuda")
    check(stats["dbscan_launches"] == 0,
          "the mission path launched the DBSCAN kernel")
    check(stats["fft_count_gap"] < 0.05,
          f"FFT raster counts {stats['fft_count_gap']} from integers")
    check(stats["overflow_total"] == 0,
          f"capacity overflow: {stats['overflow']}")
    check(stats["merged_pairs"] == MISSION_MERGED_PAIRS,
          f"merged pairs {stats['merged_pairs']} != the JAX run's "
          f"{MISSION_MERGED_PAIRS}")
    ate = stats["ate_mean_m"]
    check(math.isfinite(ate) and ate <= MISSION_ATE_BOUND_M,
          f"mean ATE {ate} m not finite or above {MISSION_ATE_BOUND_M} m")
    return stats


def phase_card_vs_cpu_mission(devices=("cuda", "cpu")):
    """The small sync mission on the card and on the CPU: decisions and
    counts identical, chains and ATEs within the CARD_VS_CPU bounds."""
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.runtime.mission import MultiRobotMission

    runs = {}
    for device in devices:
        cfg, trajs, logs, rel = small_mission(config, synthetic)
        t0 = time.perf_counter()
        report = MultiRobotMission(
            cfg, logs, relative_meas=rel, async_runtime=False,
            use_input_manager=True, device=device).run(intra_lc=True)
        check_mission_output(report, logs, device)
        ates = [synthetic.stamp_matched_ate(n.optimized_trajectory(),
                                            n.key_stamps, log, traj)
                for n, log, traj in zip(report.nodes, logs, trajs)]
        runs[device] = (report.nodes, time.perf_counter() - t0, ates)
    worst = {"own": 0.0, "peer": 0.0}
    card, cpu = (runs[d] for d in devices)
    for a, b in zip(card[0], cpu[0]):
        for what, fa, fb in (
                ("merged TFs", sorted(a.dbm.loop_closure_tf),
                 sorted(b.dbm.loop_closure_tf)),
                ("inter LC", (a.num_attempts_inter, a.num_success_inter),
                 (b.num_attempts_inter, b.num_success_inter)),
                ("intra LC", (a.num_attempts_intra, a.num_success_intra),
                 (b.num_attempts_intra, b.num_success_intra)),
                ("relative factors", a.num_rel_factors, b.num_rel_factors),
                ("landmarks", a.landmark_counts(), b.landmark_counts()),
                ("overflow", a.overflow_report(), b.overflow_report()),
                ("stamps", a.key_stamps, b.key_stamps)):
            check(fa == fb, f"robot {a.robot_id}: {what} differ card vs "
                  f"CPU: {fa} vs {fb}")
        for rid in range(len(cpu[0])):
            ta, tb = a.trajectory_of(rid), b.trajectory_of(rid)
            check(ta.shape == tb.shape, f"robot {a.robot_id} chain {rid}: "
                  f"{ta.shape} vs {tb.shape}")
            kind = "own" if rid == a.robot_id else "peer"
            worst[kind] = max(worst[kind],
                              float(np.abs(ta[:, 4:7] - tb[:, 4:7]).max()))
    check(worst["own"] <= CARD_VS_CPU_OWN_TOL, f"card vs CPU own-chain "
          f"gap {worst['own']} > {CARD_VS_CPU_OWN_TOL}")
    check(worst["peer"] <= CARD_VS_CPU_PEER_TOL, f"card vs CPU peer-chain "
          f"gap {worst['peer']} > {CARD_VS_CPU_PEER_TOL}")
    ate_gap = max(abs(x - y) for x, y in zip(card[2], cpu[2]))
    check(ate_gap <= CARD_VS_CPU_ATE_TOL,
          f"card vs CPU ATE gap {ate_gap} > {CARD_VS_CPU_ATE_TOL}")
    print(f"[card_vs_cpu:mission] 2 robots x 50 keyframes, sync: decisions "
          f"and counts identical, largest position gap {worst['own']:.3e} m "
          f"on own chains, {worst['peer']:.3e} m on replayed peer chains, "
          f"ATE {card[2]} vs {cpu[2]} m (card {card[1]:.1f} s, CPU "
          f"{cpu[1]:.1f} s)")


def main():
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not installed: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card: chip_smoke.py runs the port on the card "
              "only", file=sys.stderr)
        return 1
    try:
        from slide_slam_tpu_torch.io import synthetic
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase = "build"
    try:
        phase_build()
        phase = "setup"
        mission = synthetic.make_lidar_mission()
        phase = "kernel:dbscan"
        kern = phase_kernel(mission)
        phase = "slice:raw_lidar_solo"
        stats, card_kf = phase_slice(mission)
        phase = "card_vs_cpu"
        phase_card_vs_cpu(mission, card_kf)
        phase = "slice:multi_robot_mission"
        mstats = phase_multi_robot_mission()
        phase = "card_vs_cpu:mission"
        phase_card_vs_cpu_mission()
    except Exception as e:  # every failed phase fails the run
        import traceback
        traceback.print_exc()
        print(f"FAIL in phase {phase}: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [{
        "name": "dbscan", "route": "cuda",
        "source": "slide_slam_tpu_torch/csrc/dbscan.cu",
        "replaces": "slide_slam_tpu/frontend/clustering_pallas.py:29",
        "launches": stats["dbscan_launches"],
        "launches_by_path": {"raw_lidar_solo": stats["dbscan_launches"],
                             "multi_robot_mission": mstats["dbscan_launches"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "floor_ms": kern["floor_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

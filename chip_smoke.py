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
                    indices identical, poses within 1e-3.

Prints a {"kernels": [...]} line, the card's name and power limit, and last
the line {"ok": true, "device": {...}}. In the kernels line, `launches` is
the mission's DBSCAN launch count (one per scan), `ms` the device time of
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

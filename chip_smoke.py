#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (it refuses to run without one; there is no CPU
fallback) and the CUDA toolkit's nvcc. Imports nothing of JAX or of the JAX
package. Phases, in this order, each of which fails the run:

1. build            compile every hand-written kernel from csrc/ (one nvcc
                    per source, all started together) and print the seconds;
2. kernel:dbscan    the DBSCAN kernel against its plain PyTorch version on
                    the card, labels exactly equal, at N = 1024: each of the
                    forest keyframe's four problems and a > 64-hop chain
                    alone (one stage), the keyframe's [2, 1024] batch in the
                    one two-stage launch the frontend makes (also with the
                    chain as a third set), and the urban path's [3, 1024]
                    car/tree/lightpole launch; kernel times from CUDA
                    graphs (no host in the way), the empty-kernel floor of
                    the same launch shape, the plain version's time and the
                    card's bound for the same work;
3. net:range_segmentator  the full-width RangeSegmentator (20 classes,
                    stage blocks (1, 2, 8, 8, 4), 64x1024, seeded init):
                    f32 logits card (TF32 off) vs CPU, the bf16 forward's
                    ms per scan with and without crf_refine(iters=3), FLOPs
                    per forward and the share of the bf16 dense peak;
4. slice:raw_lidar_solo  the forest raw-LiDAR mission at full width (120
                    trees + 20 poles, 150 keyframes, 64x1024 range image,
                    forest config at mission capacity) through
                    LidarFrontend -> SlamNode.process_keyframe, with the
                    launch counts reset just before and read just after:
                    one DBSCAN launch per keyframe with a clustered class;
5. card_vs_cpu      its first 8 keyframes again with device="cpu": match
                    indices identical, poses within 1e-3;
6. slice:urban_lidar_solo  the same world with 15 cars, the outdoor classes
                    with the car branch (bbox seeds, tracker, PCA cuboids,
                    yaw snapping), the urban capacity: one DBSCAN launch
                    (car, tree and lightpole) per scan, overflow 0, cuboid
                    landmarks, ATE <= 1.25 x the JAX package's;
7. card_vs_cpu:urban  its first 40 keyframes on the CPU, across the first
                    periodic full solve (keyframe 32): cylinder and cuboid
                    match indices and cuboid measurement counts identical,
                    poses within 1e-3 over the first 8 keyframes and within
                    4 cm after them (URBAN_LATE_POSE_TOL);
8. slice:net_in_the_loop  train the full-width net on the card on 16
                    simulator-labelled scans of the urban loop (IoU gate of
                    the JAX package's test), then drive the first 50
                    keyframes with it as the segmenter: >= 4 cylinder
                    landmarks, overflow 0, median root error < 0.9 m at
                    keyframe 25, before the first full solve (the JAX
                    test's gates; see NET_GATE_KEYFRAME), and the numbers
                    beside the simulator labels' run at keyframes 25, 50;
9. slice:indoor_lidar  the indoor LiDAR frontend on 5 segmented scans of
                    floor, chairs and a table (the scene of
                    tests/test_lidar_indoor.py) on the card and on the CPU:
                    one DBSCAN launch (chair and table) per scan, centroid
                    measurements equal, three objects;
10. slice:multi_robot_mission  the decentralized mission of the JAX package's
                    bench.py:222-264 at full width (3 robots x 150
                    keyframes, 110 trees, mission_capacity(150), input
                    manager, async worker pool, intra-LC, SlideGraph/CLIPPER
                    merges, relative factors) through MultiRobotMission.run
                    on the card, after one untimed SlideMatch/CLIPPER
                    warm-up: overflow 0, merged robot pairs equal to the JAX
                    run's, mean ATE <= 1.25 x the JAX run's; no DBSCAN
                    launch (the path reads measurement logs);
11. card_vs_cpu:mission  the 2-robot x 50-keyframe sync mission of
                    tests/test_torch_mission.py on the card and on the CPU:
                    decisions and counts identical, own chains within
                    3 cm, replayed peer chains within 4 cm, per-robot ATE
                    within 1 cm (the card's run-to-run spread: see
                    CARD_VS_CPU_OWN_TOL);
12. slice:indoor_rgbd_team  the indoor two-robot RGBD team of
                    indoor_rgbd_team.py (the world of
                    tests/test_indoor_rgbd.py, 50 keyframes per robot,
                    640 x 480 frames, robot 1 following robot 0 2 m behind
                    and reading its tag) on the card, three times: each
                    keyframe's frame through OpenVocabFrontend.process_frame
                    and instance_measurements to SlamNode.process_keyframe,
                    robot 1's tag images through ApriltagMeasurer to
                    relative factors, database exchanges every 5 keyframes.
                    Gates on the first run: overflow 0, per robot 10-28 point
                    landmarks, median landmark error < 0.25 m and ATE below
                    odometry's (tests/test_indoor_rgbd.py), every sighting's
                    tag pose within 0.12 m and 2 deg of the truth, >= 1
                    relative factor, no DBSCAN launch. The third run saves
                    robot 1 after keyframe 25, drops it and restores it on
                    the card: state bit for bit and host mirrors equal,
                    then decisions identical to the first run and poses
                    within RESTART_SPREAD_FACTOR x the gap between the first
                    two runs. Prints frames per second and ms per frame of
                    each stage;
13. card_vs_cpu:indoor_rgbd  robot 0's first 8 keyframes on the card and on
                    the CPU: every labelled cloud's label, instance and
                    valid identical, xyz within 1e-6 m, instance
                    measurements identical in count and order, poses within
                    1e-3 m.

Prints a {"kernels": [...]} line, the card's name and power limit, and last
the line {"ok": true, "device": {...}}. In the kernels line, `launches` is
the DBSCAN launch count summed over the paths (one per scan; per path under
`launches_by_path`), `ms` the device time of one per-scan launch of the
forest's largest keyframe (two classes, both stages), `floor_ms` an empty
kernel's of the same launch shape, `plain_ms` the plain version's time for
the same batch on the card, `bound_ms` the card's least time for the four
problems' work; `urban_c3` holds the same for the urban C = 3 launch.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_M = 7.55          # 1.25 x the JAX package's 6.042 m on this mission
POSE_TOL = 1e-3             # card vs CPU: f32 sums in another order
F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
CARD_VS_CPU_KEYFRAMES = 8
# card_vs_cpu:urban runs on across the first periodic full solve (keyframe
# 32), which amplifies the order of the f32 sums. Every decision was
# identical card vs CPU over the first 40-50 keyframes in six card runs
# (scripts/urban_card_spread.py and this script, PERF.md); their pose gaps
# stayed below 3.0 mm to keyframe 31 and reached 2.2 mm to 2.12 cm by
# keyframe 40. Keyframes 9-40 are held to 4 cm, the first 8 to POSE_TOL.
URBAN_CARD_VS_CPU_KEYFRAMES = 40
URBAN_LATE_POSE_TOL = 4e-2
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


URBAN_CARS = 15


def urban_capacity(config):
    """The urban raw-LiDAR mission's capacity in either package's `config`
    module."""
    return config.mission_capacity(150, n_cylinders=140,
                                   n_cuboids=2 * URBAN_CARS)


# slice:urban_lidar_solo: 1.25 x the JAX package's 3.968 m on this mission
# (scripts/jax_raw_lidar_reference.py --urban, on the CPU; PERF.md)
URBAN_ATE_BOUND_M = 4.96
# net:range_segmentator, f32 card vs CPU: the small net's test holds 2e-4;
# the full net's logits reach ~90, so a relative term joins it
NET_F32_ATOL = 2e-4
NET_F32_RTOL = 1e-5
BF16_PEAK_FLOPS = 989e12    # H100 SXM, dense
NET_CLASSES = 20
NET_TRAIN_STEPS = 200
NET_TRAIN_LR = 1e-3
NET_IOU_GATE = 0.55         # tests/test_lidar_pipeline.py:137
NET_LOOP_KEYFRAMES = 50
NET_ROOT_ERROR_GATE_M = 0.9  # tests/test_lidar_pipeline.py:161-170
# The JAX test holds that gate on 12 keyframes with exact odometry and no
# periodic full solve. Here it is held at keyframe 25, before this loop's
# first full solve (keyframe 32): that solve lifts the median root error
# of the simulator labels themselves from 0.32 m to 1.02 m, and to
# 1.25-1.27 m by keyframe 50 on the card and on the CPU alike, so after it
# the error measures the solve, not the segmenter (PERF.md).
NET_GATE_KEYFRAME = 25
NET_REPORT_AT = (NET_GATE_KEYFRAME, NET_LOOP_KEYFRAMES)
INDOOR_SCANS = 5
# every third scan of the loop's 50: trained on the first 16 scans alone,
# the net saw too few trees (on the mission's first draft: held-out IoU
# 0.569, loop median root error 2.05 m; PERF.md)
NET_TRAIN_SCANS = tuple(range(0, 48, 3))
# slice:indoor_rgbd_team: the gates of tests/test_indoor_rgbd.py:60-73 and
# tests/test_apriltag.py:131,150
RGBD_MIN_POINTS, RGBD_MAX_POINTS = 10, 22 + 6
RGBD_LANDMARK_ERROR_M = 0.25
TAG_TRANSLATION_M = 0.12
TAG_ROTATION_DEG = 2.0
# a restored robot runs on from a bit-equal state, so it may differ from an
# uninterrupted run only as two uninterrupted card runs differ (the order of
# the card's atomic sums); the gate allows 4x their gap, at least 10 um
RESTART_SPREAD_FACTOR = 4.0
RESTART_SPREAD_FLOOR_M = 1e-5
RGBD_CARD_VS_CPU_KEYFRAMES = 8
RGBD_XYZ_TOL = 1e-6


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


def class_labels(mission, k):
    """Keyframe k's points as the pipeline sees them (world frame through
    the odometry pose) and their simulator labels."""
    from slide_slam_tpu_torch.io.synthetic import nearest_object_label
    from slide_slam_tpu_torch.geometry import se3np
    scan = mission.scans[k]
    labels = nearest_object_label(
        mission.world, se3np.apply(mission.traj[k], scan))
    return se3np.apply(mission.odom[k], scan), labels


def slice_inputs(mission, k, classes=(("tree", 8), ("lightpole", 9))):
    """The clustered classes' points of keyframe k, padded to 1024."""
    world, labels = class_labels(mission, k)
    out = {}
    for name, lab in classes:
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


def phase_kernel_urban(urban):
    """The urban path's launch: car, tree and lightpole (C = 3) of the
    keyframe with the most points in those classes, both stages in one
    launch, against the plain version (labels exactly equal); kernel time
    from CUDA graphs, the plain version's time and the card's bound."""
    import torch
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.pipeline import outdoor_classes

    specs = [c for c in outdoor_classes() if c.model != "ground"]
    names = tuple((c.name, c.label) for c in specs)

    def clustered(k):
        _, labels = class_labels(urban, k)
        return sum(min(int((labels == lab).sum()), 1024) for _, lab in names)
    k = max(range(len(urban.scans)), key=clustered)
    inputs = slice_inputs(urban, k, names)
    cuda = lambda a: torch.as_tensor(a, device="cuda")
    pts = torch.stack([cuda(inputs[c.name][0]) for c in specs])
    valid = torch.stack([cuda(inputs[c.name][1]) for c in specs])
    params = torch.stack([cuda(clustering.stage_params(
        c.eps_noise, c.min_samples_noise, c.eps_cluster,
        c.min_samples_cluster)) for c in specs])
    got = clustering.two_stage_cluster_batch(pts, valid, params)
    ref = clustering.two_stage_cluster_reference(pts, valid, params)
    torch.cuda.synchronize()
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "batched dbscan kernel != plain on the urban "
          f"keyframe's C = 3 batch: {int((got != ref).sum())} labels differ")
    ops = 0
    for c, p, v in zip(specs, pts, valid):
        lab1 = clustering.dbscan_reference(p, v, c.eps_noise,
                                           c.min_samples_noise)
        ops += dbscan_work(p, v, c.eps_noise, c.min_samples_noise)
        ops += dbscan_work(p, v & (lab1 >= 0), c.eps_cluster,
                           c.min_samples_cluster)
    ms = graph_ms(lambda: clustering.launch_dbscan(pts, valid, params))
    plain_ms = cuda_ms(lambda: clustering.two_stage_cluster_reference(
        pts, valid, params), 5)
    bound, by = dbscan_bound(ops, pts.numel() * 4 + valid.numel()
                             + params.numel() * 4 + got.numel() * 4)
    counts = {c.name: int(v.sum()) for c, v in zip(specs, valid)}
    clusters = {c.name: int(torch.unique(r[r >= 0]).numel())
                for c, r in zip(specs, ref)}
    print(f"[kernel:dbscan] urban keyframe {k}, [3, 1024] car/tree/lightpole "
          f"x 2 stages, one launch: points {counts}, clusters {clusters}: "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.6f} ms "
          f"({by}, {ops} ops)  labels equal")
    check(clusters["car"] > 0, "no car cluster in the urban batch")
    return dict(keyframe=k, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, points=counts)


def conv_flops(model, x):
    """FLOPs of one forward of the net's convolutions on x (2 per
    multiply-add, from the module shapes), counted with forward hooks."""
    import torch
    from slide_slam_tpu_torch.frontend import segmentation as seg
    total = [0]

    def hook(mod, inp, out):
        _, cin, kh, kw = mod.weight.shape
        total[0] += 2 * out.numel() * cin * kh * kw
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, seg.Conv)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def model_input(mission, k, device="cuda"):
    """The [1, 64, 1024, 5] range-image input of scan k."""
    import torch
    from slide_slam_tpu_torch.frontend import range_projection as rp
    pts = torch.as_tensor(mission.scans[k], device=device)
    n = pts.shape[0]
    ri = rp.project(pts, torch.zeros(n, device=device),
                    torch.ones(n, dtype=torch.bool, device=device))
    return torch.movedim(rp.make_model_input(ri)[None], 1, -1)


def phase_net(urban):
    """The full-width RangeSegmentator (20 classes, stage blocks
    (1, 2, 8, 8, 4), 64 x 1024, seeded init): f32 logits on the card (TF32
    off) against the CPU's; the bf16 net's forward time per scan from CUDA
    events, with and without crf_refine(iters=3); FLOPs per forward and the
    share of the card's bf16 dense peak."""
    import torch
    from slide_slam_tpu_torch.frontend import segmentation as seg
    x = model_input(urban, 0)
    f32 = seg.init_params(seg.RangeSegmentator(dtype=torch.float32),
                          torch.Generator().manual_seed(0)).eval()
    t0 = time.perf_counter()
    want = seg._eval_logits(f32, x.cpu())
    cpu_s = time.perf_counter() - t0
    got = seg._eval_logits(f32.cuda(), x).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()), "non-finite logits on the card")
    check(err <= NET_F32_ATOL + NET_F32_RTOL * scale,
          f"f32 logits card vs CPU differ by {err} (largest logit {scale})")
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    del f32
    model = seg.init_params(seg.RangeSegmentator(),
                            torch.Generator().manual_seed(0)).cuda().eval()
    flops = conv_flops(model, x)
    with torch.no_grad():
        ms = cuda_ms(lambda: model(x), 20)
        ms_crf = cuda_ms(lambda: seg.segment_with_crf(model, x, iters=3), 10)
    labels = seg.segment(model, x)
    check(tuple(labels.shape) == (1, 64, 1024) and labels.is_cuda,
          f"segment gave {tuple(labels.shape)} on {labels.device}")
    stats = dict(
        flops_per_forward=flops, forward_ms=ms, forward_crf3_ms=ms_crf,
        crf3_ms=ms_crf - ms, tflops_per_s=flops / ms / 1e9,
        bf16_peak_share=flops / (ms * 1e-3) / BF16_PEAK_FLOPS,
        f32_card_vs_cpu_max_abs_err=err, f32_largest_logit=scale,
        f32_labels_equal_share=same, cpu_f32_forward_s=cpu_s)
    print("[net:range_segmentator] " + json.dumps(stats))
    return stats


def training_set(urban, keyframes):
    """(inputs, labels, valid) of the urban mission's scans at `keyframes`
    with the simulator's labels, projected on the card."""
    from slide_slam_tpu_torch.frontend.lidar_pipeline import \
        ground_truth_segmenter
    from slide_slam_tpu_torch.frontend.train_segmentation import \
        make_synthetic_dataset
    holder = {"pose": None}
    labeler = ground_truth_segmenter(urban.world, lambda: holder["pose"])
    poses = [urban.traj[k] for k in keyframes]

    def label(x, it=iter(poses)):
        holder["pose"] = next(it)
        return labeler(x)
    return make_synthetic_dataset([urban.scans[k] for k in keyframes], poses,
                                  label, 64, 1024, device="cuda")


def predict(model, inputs, chunk=4):
    import torch
    from slide_slam_tpu_torch.frontend import segmentation as seg
    x = torch.as_tensor(inputs, device="cuda")
    return torch.cat([seg.segment(model, x[i:i + chunk])
                      for i in range(0, len(x), chunk)]).cpu().numpy()


def phase_net_in_the_loop(urban, gt_at):
    """Train the full-width net on the card on the simulator labels of 16
    scans of the loop (NET_TRAIN_SCANS; IoU gate of the JAX package's
    test, IoU also on the loop's other scans), then run the first
    NET_LOOP_KEYFRAMES keyframes with it as the segmenter: >= 4 cylinder
    landmarks, overflow 0 and the map's median root error below
    NET_ROOT_ERROR_GATE_M at NET_GATE_KEYFRAME, the gates of the JAX
    package's test. At the keyframe counts in NET_REPORT_AT the numbers
    stand beside those of the simulator labels' run (`gt_at`).

    Training and the loop use cuDNN's deterministic algorithms: with the
    autotuned ones every run trained another net, and the gate read
    0.23-0.67 m over eight trainings, where the deterministic ones train
    the same net on every run (scripts/net_loop_spread.py, PERF.md)."""
    import torch
    from slide_slam_tpu_torch.frontend import segmentation as seg
    from slide_slam_tpu_torch.frontend import train_segmentation as ts
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    train = training_set(urban, NET_TRAIN_SCANS)
    held = training_set(urban, [k for k in range(NET_LOOP_KEYFRAMES)
                                if k not in NET_TRAIN_SCANS])
    data_s = time.perf_counter() - t0
    model = seg.RangeSegmentator(num_classes=NET_CLASSES)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    model, metrics = ts.train_segmentator(
        model, *train, steps=NET_TRAIN_STEPS, lr=NET_TRAIN_LR, batch=2,
        seed=0, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    iou_train = ts.mean_iou(predict(model, train[0]), train[1], train[2],
                            NET_CLASSES)
    iou_held = ts.mean_iou(predict(model, held[0]), held[1], held[2],
                           NET_CLASSES)
    net = dict(steps=metrics["steps"], train_s=train_s, dataset_s=data_s,
               final_loss=metrics["final_loss"], iou_train=iou_train,
               iou_held_out=iou_held)
    print("[slice:net_in_the_loop] training " + json.dumps(net))
    check(iou_train >= NET_IOU_GATE,
          f"training-scan IoU {iou_train} < {NET_IOU_GATE}")
    stats, _ = phase_slice(urban, "net_in_the_loop", urban=True,
                           n=NET_LOOP_KEYFRAMES, ate_bound=math.inf,
                           segment_fn=lambda x: seg.segment(model, x),
                           snapshot_at=NET_REPORT_AT)
    for k in NET_REPORT_AT:
        a, g = stats["at_keyframe"][k], gt_at[k]
        print(f"[slice:net_in_the_loop] keyframe {k}, net vs simulator "
              f"labels: cylinder landmarks {a['landmarks']['cylinders']} vs "
              f"{g['landmarks']['cylinders']}, cuboid landmarks "
              f"{a['landmarks']['cuboids']} vs {g['landmarks']['cuboids']}, "
              f"ATE {a['ate_optimized_m']} vs {g['ate_optimized_m']} m, "
              f"median root error {a['median_root_error_m']} vs "
              f"{g['median_root_error_m']} m")
    lm = stats["landmarks"]
    err = stats["at_keyframe"][NET_GATE_KEYFRAME]["median_root_error_m"]
    check(lm["cylinders"] >= 4, f"{lm['cylinders']} cylinder landmarks < 4")
    check(err < NET_ROOT_ERROR_GATE_M, f"median root error {err} m >= "
          f"{NET_ROOT_ERROR_GATE_M} m at keyframe {NET_GATE_KEYFRAME}")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    return dict(net, at_keyframe=stats["at_keyframe"], **{k: stats[k] for k in (
        "dbscan_launches", "landmarks", "ate_optimized_m",
        "median_root_error_m", "kf_per_s", "frontend_ms_per_scan")})


def indoor_scan(rng, sensor_xyz, n_floor=600):
    """A segmented indoor scan: floor + 2 chairs + 1 table with the
    segmentation's raw ids (the scene of tests/test_lidar_indoor.py)."""
    def box(center, dims, n):
        return (np.asarray(center)[None]
                + rng.uniform(-0.5, 0.5, (n, 3)) * np.asarray(dims)[None])
    floor = np.column_stack([
        rng.uniform(-8, 8, n_floor) + sensor_xyz[0],
        rng.uniform(-8, 8, n_floor) + sensor_xyz[1],
        rng.normal(0.0, 0.01, n_floor)])
    xyz = np.vstack([floor, box([2.0, 1.0, 0.45], [0.5, 0.5, 0.9], 220),
                     box([4.0, -2.0, 0.45], [0.5, 0.5, 0.9], 220),
                     box([-1.5, 3.0, 0.55], [1.6, 0.9, 0.7], 300)])
    labels = np.concatenate([np.full(n_floor, 2), np.full(440, 3),
                             np.full(300, 4)])
    return xyz.astype(np.float32), labels


def phase_indoor(n_scans=INDOOR_SCANS, devices=("cuda", "cpu")):
    """The indoor LiDAR frontend on the card and on the CPU over the same
    scans (the same RANSAC draws on both): chair and table (C = 2) in one
    DBSCAN launch per scan, launch count set to 0 just before and read just
    after; centroid measurements equal card vs CPU (labels identical,
    poses and scales within 1e-4), three objects emitted."""
    import torch
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.lidar_indoor import IndoorLidarPipeline
    from slide_slam_tpu_torch.geometry import se3np
    pose = np.asarray(se3np.from_xyz_yaw(0.0, 0.0, 0.6, 0.0), np.float32)
    rng = np.random.default_rng(3)
    scans = [indoor_scan(rng, pose[4:7]) for _ in range(n_scans)]
    outs = {}
    card = devices[0]
    for device in devices:
        pipe = IndoorLidarPipeline(device=device)
        if device == card:
            torch.cuda.synchronize()
            clustering.launch_dbscan.launches = 0
        t0 = time.perf_counter()
        outs[device] = [pipe.process_scan(xyz, lab, pose)
                        for xyz, lab in scans]
        if device == card:
            torch.cuda.synchronize()
            launches = clustering.launch_dbscan.launches
            ms = (time.perf_counter() - t0) * 1e3 / n_scans
    for i, (a, b) in enumerate(zip(outs[card], outs[devices[1]])):
        check(sorted(a) == sorted(b), f"indoor scan {i}: keys differ")
        if a:
            check(np.array_equal(a["ell_label"], b["ell_label"]),
                  f"indoor scan {i}: labels differ card vs CPU")
            for key in ("ell_pose", "ell_scale"):
                check(np.abs(a[key] - b[key]).max() <= 1e-4,
                      f"indoor scan {i}: {key} differ card vs CPU")
    last = outs[card][-1]
    stats = dict(scans=n_scans, dbscan_launches=launches, ms_per_scan=ms,
                 objects=len(last.get("ell_label", [])))
    print("[slice:indoor_lidar] " + json.dumps(stats))
    check(launches == n_scans, f"DBSCAN launches {launches} != {n_scans}")
    check(stats["objects"] == 3, f"{stats['objects']} objects, want 3")
    return stats


def run_mission(mission, device, n_keyframes, record, urban=False,
                segment_fn=None):
    """The raw-LiDAR solo path: LidarFrontend (the simulator labeller, or
    `segment_fn`) -> SlamNode.process_keyframe for the first n_keyframes.
    Forest: the forest classes at mission capacity; urban: the outdoor
    classes with the car branch at the urban capacity."""
    import torch
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.frontend.lidar_pipeline import (
        LidarFrontend, LidarFrontendConfig, ground_truth_segmenter)
    from slide_slam_tpu_torch.frontend.pipeline import (PipelineConfig,
                                                        forest_classes,
                                                        outdoor_classes)
    from slide_slam_tpu_torch.runtime.node import SlamNode

    holder = {"pose": mission.traj[0]}
    frontend = LidarFrontend(
        segment_fn or ground_truth_segmenter(mission.world,
                                             lambda: holder["pose"]),
        LidarFrontendConfig(64, 1024, desired_period=0.0),
        PipelineConfig(classes=outdoor_classes() if urban
                       else forest_classes()), device=device)
    cfg = config.forest_config().replace(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=urban_capacity(config) if urban
        else config.mission_capacity(150, n_cylinders=140))
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


def root_errors(node, world):
    """Each mapped cylinder root's XY distance to the nearest true one."""
    n = node.landmark_counts()["cylinders"]
    roots = node.state.cyl_root[:n].cpu().numpy()
    return [float(np.linalg.norm(world.cyl_root[:, :2] - r[:2], axis=1).min())
            for r in roots]


def phase_slice(mission, name="raw_lidar_solo", urban=False, n=None,
                ate_bound=ATE_BOUND_M, segment_fn=None, snapshot_at=()):
    """One raw-LiDAR solo run on the card with the DBSCAN launch count set
    to 0 just before and read just after: one launch per keyframe with a
    clustered class, overflow 0, ATE within its bound. At each keyframe
    count in `snapshot_at` it also records the landmarks, the optimized
    trajectory's ATE and the map's median root error."""
    import torch
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.pipeline import (forest_classes,
                                                        outdoor_classes)
    from slide_slam_tpu_torch.io import synthetic

    classes = outdoor_classes() if urban else forest_classes()
    min_cluster = {c.name: c.min_samples_cluster for c in classes
                   if c.model != "ground"}
    per_kf, snapshot = [], {}

    def record(i, node, frontend, obs, fe_s, be_s):
        counts = dict(frontend.pipeline.class_points)
        per_kf.append(dict(
            fe_s=fe_s, be_s=be_s, counts=counts,
            n_meas=len(obs.get("cyl_root", [])),
            n_cub=len(obs.get("cub_pose", [])),
            expected=int(any(n >= min_cluster[c] for c, n in counts.items())),
            matches=node.last_step.cyl_matches.cpu().numpy(),
            cub_matches=node.last_step.cub_matches.cpu().numpy(),
            pose=node.last_step.pose.cpu().numpy()))
        if i + 1 in snapshot_at:
            est = node.optimized_trajectory()
            snapshot[i + 1] = dict(
                landmarks=node.landmark_counts(),
                ate_optimized_m=synthetic.ate_rmse(
                    est, mission.traj[:len(est)], align=False),
                median_root_error_m=float(np.median(
                    root_errors(node, mission.world))))

    n = n or len(mission.scans)
    torch.cuda.synchronize()
    clustering.launch_dbscan.launches = 0
    t0 = time.perf_counter()
    node, cfg = run_mission(mission, "cuda", n, record, urban, segment_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = clustering.launch_dbscan.launches

    every = cfg.solver.full_solve_every
    full_kf = [i for i in range(n) if every and (i + 1) % every == 0]
    be = np.array([r["be_s"] for r in per_kf]) * 1e3
    plain_be = np.delete(be, full_kf)
    est = node.optimized_trajectory()
    ate = synthetic.ate_rmse(est, mission.traj[:n], align=False)
    ate_odom = synthetic.ate_rmse(mission.odom[:n], mission.traj[:n],
                                  align=False)
    expected = sum(r["expected"] for r in per_kf)
    max_class = max(max(r["counts"].values()) for r in per_kf)
    cut = sum(max(c - 1024, 0) for r in per_kf for c in r["counts"].values())
    overflow = node.overflow_report()
    errs = root_errors(node, mission.world)
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
        cuboid_measurements=int(sum(r["n_cub"] for r in per_kf)),
        ate_optimized_m=ate, ate_odometry_m=ate_odom,
        median_root_error_m=float(np.median(errs)) if errs else None,
        landmarks=node.landmark_counts(), overflow=overflow)
    if snapshot:
        stats["at_keyframe"] = snapshot
    print(f"[slice:{name}] " + json.dumps(stats))
    check(launches > 0, "the main path launched no DBSCAN kernel")
    check(launches == expected,
          f"DBSCAN launches {launches} != expected {expected}")
    check(sum(overflow.values()) == 0, f"capacity overflow: {overflow}")
    check(math.isfinite(ate) and ate <= ate_bound,
          f"ATE {ate} m not finite or above the bound {ate_bound} m")
    return stats, per_kf


def phase_card_vs_cpu(mission, card_kf, urban=False):
    """The card run's first keyframes again on the CPU: match indices and
    cuboid measurement counts identical; poses within POSE_TOL over the
    first CARD_VS_CPU_KEYFRAMES and, urban, within URBAN_LATE_POSE_TOL up
    to URBAN_CARD_VS_CPU_KEYFRAMES, past the first periodic full solve."""
    n = URBAN_CARD_VS_CPU_KEYFRAMES if urban else CARD_VS_CPU_KEYFRAMES
    cpu_kf = []

    def record(i, node, frontend, obs, fe_s, be_s):
        cpu_kf.append(dict(matches=node.last_step.cyl_matches.numpy(),
                           cub_matches=node.last_step.cub_matches.numpy(),
                           n_cub=len(obs.get("cub_pose", [])),
                           pose=node.last_step.pose.numpy()))

    run_mission(mission, "cpu", n, record, urban)
    gaps = []
    for i, (a, b) in enumerate(zip(card_kf, cpu_kf)):
        for key in ("matches", "cub_matches"):
            check(np.array_equal(a[key], b[key]),
                  f"keyframe {i}: {key} differ card vs CPU")
        check(a["n_cub"] == b["n_cub"],
              f"keyframe {i}: cuboid measurements {a['n_cub']} vs "
              f"{b['n_cub']} card vs CPU")
        gaps.append(float(np.abs(a["pose"] - b["pose"]).max()))
    early = max(gaps[:CARD_VS_CPU_KEYFRAMES])
    late = max(gaps[CARD_VS_CPU_KEYFRAMES:], default=0.0)
    check(early <= POSE_TOL, f"card vs CPU pose gap {early} > {POSE_TOL} "
          f"over the first {CARD_VS_CPU_KEYFRAMES} keyframes")
    check(late <= URBAN_LATE_POSE_TOL, f"card vs CPU pose gap {late} > "
          f"{URBAN_LATE_POSE_TOL} after keyframe {CARD_VS_CPU_KEYFRAMES}")
    n_cub = sum(r["n_cub"] for r in cpu_kf)
    check(n_cub > 0 if urban else True, "no cuboid measurement in the "
          "compared keyframes")
    print(f"[card_vs_cpu{':urban' if urban else ''}] {n} keyframes: "
          "matches identical"
          + (f", {n_cub} cuboid measurements on both" if urban else "")
          + f", max pose gap {early:.3e} over the first "
          f"{CARD_VS_CPU_KEYFRAMES} keyframes"
          + (f", {late:.3e} after them (gap per keyframe "
             f"{[float(f'{g:.3g}') for g in gaps]})" if urban else ""))
    return gaps


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


def rgbd_team_parts(device, scene):
    """(make_frontend, make_node, measurer, cfg) of the indoor RGBD team on
    `device` (the port's objects)."""
    import indoor_rgbd_team as team
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.frontend import apriltag, open_vocab
    from slide_slam_tpu_torch.frontend.tag36h11 import tag36h11_family
    from slide_slam_tpu_torch.geometry import se3np
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.runtime.node import SlamNode
    cfg = team.indoor_cfg(config)
    cam = scene.cam
    detect = team.scripted_detector(open_vocab, scene.world, synthetic)
    classes = open_vocab.parse_class_info(team.class_yaml(synthetic))

    def make_frontend():
        return open_vocab.OpenVocabFrontend(detect, classes, cam.fx, cam.fy,
                                            cam.cx, cam.cy, device=device)

    def make_node(r):
        return SlamNode(cfg, r, prior_tf_known=True, device=device)

    measurer = apriltag.ApriltagMeasurer(
        tag36h11_family(), cam.matrix(), team.TAG_SIZE_M,
        se3np.matrix(scene.bot_to_cam), team.tag_config(scene),
        host_robot_id=1)
    return make_frontend, make_node, measurer, cfg


def node_mirrors(node):
    """A node's host state that a restore must bring back."""
    db = {rid: (rec.bookmark_fg, [p.stamp for p in rec.packets],
                [p.key_pose.tolist() for p in rec.packets])
          for rid, rec in node.dbm.records.items()}
    return dict(
        key_stamps=list(node.key_stamps),
        key_poses=[p.tolist() for p in node.key_poses],
        xyz=[np.asarray(x).tolist() for x in node._xyz_hist],
        latest_odom=node.latest_odom.tolist(),
        refresh=node._kf_since_refresh, full=node._kf_since_full_solve,
        peers=dict(node._peer_pose_count),
        rel=[(m.stamp, m.robot_index, m.relative_pose.tolist())
             for m in node.feasible_relative_meas],
        tfs={k: v.tolist() for k, v in node.dbm.loop_closure_tf.items()},
        db=db, rel_factors=node.num_rel_factors)


def team_gap(a, b):
    """Largest position gap between two team runs over every chain of every
    node; None when a chain's length differs."""
    import indoor_rgbd_team as team
    gap = 0.0
    for na, nb in zip(a.nodes, b.nodes):
        for rid in range(2):
            ta, tb = na.trajectory_of(rid), nb.trajectory_of(rid)
            if ta.shape != tb.shape:
                return None
            gap = max(gap, team.position_gap(ta, tb))
    return gap


def team_decisions(run):
    return [(n.landmark_counts(), n.num_rel_factors, n.overflow_report(),
             n.key_stamps) for n in run.nodes]


def phase_indoor_rgbd_team(device="cuda"):
    """The indoor RGBD team on the card (see the module notes, phase 12;
    `device` lets the phase be rehearsed on the CPU)."""
    import tempfile
    import torch
    import indoor_rgbd_team as team
    from slide_slam_tpu_torch.frontend import clustering
    from slide_slam_tpu_torch.frontend.tag36h11 import tag36h11_family
    from slide_slam_tpu_torch.geometry import se3np
    from slide_slam_tpu_torch.io import checkpoint, synthetic

    t0 = time.perf_counter()
    scene = team.render_scene(se3np, team.make_scene(synthetic, se3np),
                              tag36h11_family())
    render_s = time.perf_counter() - t0
    make_frontend, make_node, measurer, cfg = rgbd_team_parts(device, scene)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    clustering.launch_dbscan.launches = 0
    first = team.run_team(scene, make_frontend, make_node, measurer,
                          sync=sync)
    launches = clustering.launch_dbscan.launches
    second = team.run_team(scene, make_frontend, make_node, measurer,
                           sync=sync)

    restored = {}

    def restart(node):
        saved = {f: getattr(node.state, f).clone()
                 for f in node.state._fields}
        mirrors = node_mirrors(node)
        with tempfile.TemporaryDirectory() as tmp:
            checkpoint.save_node(tmp, node)
            new = checkpoint.load_node(tmp, cfg, device=device)
        for f, want in saved.items():
            got = getattr(new.state, f)
            check(got.device.type == device and got.dtype == want.dtype
                  and torch.equal(got, want),
                  f"restored GraphState field {f} differs from the saved one")
        check(node_mirrors(new) == mirrors,
              "restored host mirrors differ from the saved node's")
        restored["keyframes"] = len(new.key_stamps)
        return {"node": new}

    third = team.run_team(scene, make_frontend, make_node, measurer,
                          restart_at=team.N_KEYFRAMES // 2, restart=restart,
                          sync=sync)
    n = len(scene.stamps)
    frames = 2 * n
    tag_frames = sum(img is not None for img in scene.tag_images)
    secs = first.seconds
    robots = [team.map_report(node, scene.world, synthetic, scene.trajs[r],
                              scene.odom[r])
              for r, node in enumerate(first.nodes)]
    errs = team.sighting_errors(se3np, scene, first.sightings)
    spread = team_gap(first, second)
    gap = team_gap(first, third)
    stats = dict(
        keyframes_per_robot=n, frames=frames, tag_frames=tag_frames,
        render_s=render_s, wall_s=first.wall_s,
        frames_per_s=frames / first.wall_s,
        ms_per_frame={
            "process_frame": secs["process_frame"] * 1e3 / frames,
            "instance_measurements":
                secs["instance_measurements"] * 1e3 / frames,
            "keyframe_step": secs["keyframe_step"] * 1e3 / frames,
            "apriltag": secs["apriltag"] * 1e3 / tag_frames},
        walls_s=[first.wall_s, second.wall_s, third.wall_s],
        robots=robots, sightings=len(errs),
        tag_translation_err_m=max((e[1] for e in errs), default=None),
        tag_rotation_err_deg=max((e[2] for e in errs), default=None),
        relative_factors=[nd.num_rel_factors for nd in first.nodes],
        measurements=sum(len(m) for _, _, m in first.measurements),
        overflow=[nd.overflow_report() for nd in first.nodes],
        dbscan_launches=launches,
        restart_at_keyframe=restored.get("keyframes"),
        two_run_gap_m=spread, restart_gap_m=gap)
    print("[slice:indoor_rgbd_team] " + json.dumps(stats))
    print(f"[slice:indoor_rgbd_team] frames per second "
          f"{stats['frames_per_s']:.4f}")
    for stage, ms in stats["ms_per_frame"].items():
        print(f"[slice:indoor_rgbd_team] {stage} ms per frame {ms:.4f}")
    check(launches == 0, f"the RGBD path launched DBSCAN {launches} times")
    for node in first.nodes:
        check(sum(node.overflow_report().values()) == 0,
              f"robot {node.robot_id}: overflow {node.overflow_report()}")
    for r, rep in enumerate(robots):
        check(RGBD_MIN_POINTS <= rep["points"] <= RGBD_MAX_POINTS,
              f"robot {r}: {rep['points']} point landmarks")
        check(rep["median_landmark_error_m"] < RGBD_LANDMARK_ERROR_M,
              f"robot {r}: median landmark error "
              f"{rep['median_landmark_error_m']} m")
        check(rep["ate_m"] < rep["ate_odometry_m"],
              f"robot {r}: ATE {rep['ate_m']} m not below odometry's "
              f"{rep['ate_odometry_m']} m")
    check(errs, "robot 1 decoded no tag")
    for i, dt, dr in errs:
        check(dt <= TAG_TRANSLATION_M and dr <= TAG_ROTATION_DEG,
              f"keyframe {i}: tag pose {dt} m / {dr} deg off the truth")
    check(first.nodes[1].num_rel_factors >= 1, "no relative factor added")
    check(restored.get("keyframes") == team.N_KEYFRAMES // 2,
          "robot 1 was not restarted")
    check(team_decisions(second) == team_decisions(first),
          "two uninterrupted card runs decided differently")
    check(team_decisions(third) == team_decisions(first),
          "the restored run decided differently from the uninterrupted one")
    check(gap is not None and spread is not None
          and gap <= max(RESTART_SPREAD_FACTOR * spread,
                         RESTART_SPREAD_FLOOR_M),
          f"restored run {gap} m from the uninterrupted one, two "
          f"uninterrupted runs {spread} m apart")
    for node in third.nodes:
        traj = node.optimized_trajectory()
        check(node.state.poses.device.type == device
              and bool(np.isfinite(traj).all()) and traj.shape == (n, 7),
              f"robot {node.robot_id}: trajectory {traj.shape} on {device}")
    return stats


def phase_card_vs_cpu_rgbd(devices=("cuda", "cpu")):
    """Robot 0's first keyframes of the RGBD team on the card and on the
    CPU: clouds, instance measurements and poses (phase 13)."""
    import torch
    import indoor_rgbd_team as team
    from slide_slam_tpu_torch.frontend import rgbd
    from slide_slam_tpu_torch.frontend.tag36h11 import tag36h11_family
    from slide_slam_tpu_torch.geometry import se3np
    from slide_slam_tpu_torch.io import synthetic

    n = RGBD_CARD_VS_CPU_KEYFRAMES
    scene = team.render_scene(se3np, team.make_scene(synthetic, se3np,
                                                     n_keyframes=n),
                              tag36h11_family())
    runs = {}
    for device in devices:
        make_frontend, make_node, measurer, _ = rgbd_team_parts(device,
                                                                scene)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        runs[device] = team.run_team(scene, make_frontend, make_node,
                                     measurer, robots=(0,),
                                     host_cloud=rgbd.host_cloud, sync=sync)
    card, cpu = (runs[d] for d in devices)
    xyz_gap = 0.0
    for (_, i, a), (_, _, b) in zip(card.clouds, cpu.clouds):
        for key in ("label", "instance", "valid"):
            check(np.array_equal(getattr(a, key), getattr(b, key)),
                  f"keyframe {i}: cloud {key} differs card vs CPU")
        xyz_gap = max(xyz_gap, float(np.abs(a.xyz - b.xyz).max()))
    check(xyz_gap <= RGBD_XYZ_TOL, f"cloud xyz {xyz_gap} m apart")
    n_meas = 0
    for (_, i, a), (_, _, b) in zip(card.measurements, cpu.measurements):
        check([(c, f) for _, _, c, f in a] == [(c, f) for _, _, c, f in b],
              f"keyframe {i}: instance measurements differ card vs CPU")
        for (pa, ma, _, _), (pb, mb, _, _) in zip(a, b):
            check(np.array_equal(ma, mb) and np.abs(pa - pb).max()
                  <= RGBD_XYZ_TOL, f"keyframe {i}: instance points differ")
        n_meas += len(a)
    ta = card.nodes[0].optimized_trajectory()
    tb = cpu.nodes[0].optimized_trajectory()
    pose_gap = team.position_gap(ta, tb)
    check(ta.shape == tb.shape == (n, 7) and pose_gap <= POSE_TOL,
          f"poses {pose_gap} m apart card vs CPU")
    check(card.nodes[0].landmark_counts() == cpu.nodes[0].landmark_counts(),
          "landmark counts differ card vs CPU")
    print(f"[card_vs_cpu:indoor_rgbd] robot 0, {n} keyframes: clouds' "
          f"integers identical, xyz {xyz_gap:.3e} m apart, {n_meas} instance "
          f"measurements identical in count and order, poses {pose_gap:.3e} "
          f"m apart (card {card.wall_s:.1f} s, CPU {cpu.wall_s:.1f} s)")


def phase_urban(urban):
    stats, per_kf = phase_slice(urban, "urban_lidar_solo", urban=True,
                                ate_bound=URBAN_ATE_BOUND_M,
                                snapshot_at=NET_REPORT_AT)
    check(stats["landmarks"]["cuboids"] > 0,
          "no cuboid landmark on the urban mission")
    return stats, per_kf


def main():
    # cuBLAS is deterministic only with a fixed workspace, set before CUDA
    # starts (slice:net_in_the_loop trains with deterministic algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    torch.backends.cudnn.benchmark = True     # the net's shapes are fixed
    card = card_line()
    phase = "build"
    t_start = time.perf_counter()

    def run(name, fn, *args):
        nonlocal phase
        phase = name
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"[time] {name} {time.perf_counter() - t0:.1f} s", flush=True)
        return result

    try:
        run("build", phase_build)
        phase = "setup"
        forest = synthetic.make_lidar_mission()
        urban = synthetic.make_lidar_mission(n_cars=URBAN_CARS)
        kern = run("kernel:dbscan", phase_kernel, forest)
        urb = run("kernel:dbscan:urban", phase_kernel_urban, urban)
        run("net:range_segmentator", phase_net, urban)
        forest_run = run("slice:raw_lidar_solo", phase_slice, forest)
        run("card_vs_cpu", phase_card_vs_cpu, forest, forest_run[1])
        urban_run = run("slice:urban_lidar_solo", phase_urban, urban)
        run("card_vs_cpu:urban", phase_card_vs_cpu, urban, urban_run[1],
            True)
        loop = run("slice:net_in_the_loop", phase_net_in_the_loop, urban,
                   urban_run[0]["at_keyframe"])
        indoor = run("slice:indoor_lidar", phase_indoor)
        mission = run("slice:multi_robot_mission", phase_multi_robot_mission)
        run("card_vs_cpu:mission", phase_card_vs_cpu_mission)
        rgbd_team = run("slice:indoor_rgbd_team", phase_indoor_rgbd_team)
        run("card_vs_cpu:indoor_rgbd", phase_card_vs_cpu_rgbd)
    except Exception as e:  # every failed phase fails the run
        import traceback
        traceback.print_exc()
        print(f"FAIL in phase {phase}: {e}", file=sys.stderr)
        return 1
    print(f"[time] all phases {time.perf_counter() - t_start:.1f} s")

    by_path = {
        "raw_lidar_solo": forest_run[0]["dbscan_launches"],
        "urban_lidar_solo": urban_run[0]["dbscan_launches"],
        "net_in_the_loop": loop["dbscan_launches"],
        "indoor_lidar": indoor["dbscan_launches"],
        "multi_robot_mission": mission["dbscan_launches"],
        "indoor_rgbd_team": rgbd_team["dbscan_launches"]}
    print(json.dumps({"kernels": [{
        "name": "dbscan", "route": "cuda",
        "source": "slide_slam_tpu_torch/csrc/dbscan.cu",
        "replaces": "slide_slam_tpu/frontend/clustering_pallas.py:29",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(kern["max_abs_err"], urb["max_abs_err"]),
        "ms": kern["ms"], "floor_ms": kern["floor_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
        "urban_c3": {k: urb[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

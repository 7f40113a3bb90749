"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips with a reason where there is no card (a CUDA
kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

DBSCAN labels must be EXACTLY equal (the kernel rounds every product and sum
as the plain version does and sweeps synchronously), for the one-set
one-stage call and for the batched two-stage call, which runs every set and
both stages in exactly one launch.
"""
import numpy as np
import pytest
import torch

from slide_slam_tpu_torch.frontend import clustering

from _dbscan_cases import (BIG_SIZES, CARD_BIG_SIZES, CASES, WHOLE_IMAGE,
                           WHOLE_IMAGE_CASES, big_batch, big_cases,
                           kitti_dense_batch, slice_batch, stack, trees,
                           two_stage_batch)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DBSCAN kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dbscan_kernel_equals_plain(case):
    _card()
    _, (pts, valid), eps, ms = case
    p = torch.as_tensor(pts, device="cuda")
    v = torch.as_tensor(valid, device="cuda")
    before = clustering.launch_dbscan.launches
    got = clustering.dbscan(p, v, eps, ms)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.dbscan_reference(p, v, eps, ms)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_two_stage_cluster_card_equals_cpu():
    _card()
    pts, valid = trees(seed=3)
    args = (0.5, 5, 0.8, 8)
    got = clustering.two_stage_cluster(torch.as_tensor(pts, device="cuda"),
                                       torch.as_tensor(valid, device="cuda"),
                                       *args)
    ref = clustering.two_stage_cluster(torch.as_tensor(pts),
                                       torch.as_tensor(valid), *args)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
def test_dbscan_kernel_refuses_what_it_cannot_take():
    _card()
    n = clustering.MAX_POINTS + 1
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(n, 3, device="cuda"),
                          torch.ones(n, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 2, device="cuda"),
                          torch.ones(8, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 3, device="cuda"),
                          torch.ones(7, dtype=torch.bool, device="cuda"),
                          0.5, 5)


BIG = ([(n, i) for n in BIG_SIZES + CARD_BIG_SIZES
        for i in range(len(big_cases(n)))]
       + [(WHOLE_IMAGE, i) for i, c in enumerate(big_cases(WHOLE_IMAGE))
          if c[0] in WHOLE_IMAGE_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize("n,i", BIG, ids=[f"{n}-{big_cases(n)[i][0]}"
                                         for n, i in BIG])
def test_dbscan_kernel_above_1024_equals_plain(n, i):
    """The global-memory path (N > 1024): one launch, labels exactly equal,
    with no valid point and with every point in one cluster too."""
    _card()
    _, (pts, valid), eps, ms = big_cases(n)[i]
    p = torch.as_tensor(pts, device="cuda")
    v = torch.as_tensor(valid, device="cuda")
    before = clustering.launch_dbscan.launches
    got = clustering.dbscan(p, v, eps, ms)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.dbscan_reference(p, v, eps, ms)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", BIG_SIZES + CARD_BIG_SIZES)
def test_batched_kernel_above_1024_equals_plain(n):
    _card()
    pts, valid, params = stack(big_batch(n))
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 4, 8])
def test_kitti_dense_scan_equals_plain(cluster):
    """The KITTI preset's dense scan at max_points_per_class = 4096, C = 3,
    both stages in one launch, at several cluster sizes."""
    _card()
    pts, valid, params = stack(kitti_dense_batch())
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    got = clustering.launch_dbscan(*args, cluster=cluster)
    assert clustering.auto_cluster_size(4096) in (8, 16)
    ref = clustering.two_stage_cluster_reference(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 16384])
def test_kitti_dense_scan_one_launch_equals_plain(n):
    """The KITTI dense scan's car, tree and lightpole sets at 4096 and (above
    the old cap) 16384 points a set, at the cluster size the library picks:
    one launch, labels exactly equal, clusters found."""
    _card()
    pts, valid, params = stack(kitti_dense_batch(n))
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert (ref >= 0).any(dim=1).sum() >= 2


@pytest.mark.cuda
def test_range_image_surfaces_equal_plain():
    """A street range image's car, ground and building classes (surfaces,
    22088 / 30032 / 12377 points, stage-1 chains past the 64-sweep cap)
    at chip_smoke's RANGE_IMAGE_SET_POINTS a set: one launch, labels
    exactly equal to the plain version's."""
    import chip_smoke
    _card()
    args = [torch.as_tensor(a, device="cuda")
            for a in chip_smoke.range_image_sets()]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert (ref >= 0).any(dim=1).all()


@pytest.mark.cuda
def test_launch_refuses_above_the_limit():
    """Above MAX_POINTS (65536, a whole range image) a set raises with its
    size in the message, as does a set with more points than the requested
    CTAs hold labels; nothing falls back to the plain version or the
    CPU."""
    _card()
    n = clustering.MAX_POINTS + 1
    p = torch.zeros(1, n, 3, device="cuda")
    v = torch.ones(1, n, dtype=torch.bool, device="cuda")
    q = torch.zeros(1, 4, device="cuda")
    before = clustering.launch_dbscan.launches
    with pytest.raises(ValueError, match=str(n)):
        clustering.launch_dbscan(p, v, q)
    with pytest.raises(ValueError, match=str(n)):
        clustering.two_stage_cluster_batch(p, v, q)
    m = 2 * clustering.ROWS_PER_CTA
    with pytest.raises(ValueError, match=str(m)):
        clustering.launch_dbscan(p[:, :m].contiguous(),
                                 v[:, :m].contiguous(), q, cluster=1)
    assert clustering.launch_dbscan.launches == before
    assert clustering.MAX_POINTS == clustering._lib().dbscan_max_points()
    # the limit covers a 64 x 1024 range image in one class, and the
    # cluster size `cluster=0` falls back to (8) holds that many labels
    assert clustering.MAX_POINTS >= 64 * 1024
    assert clustering.MAX_POINTS <= 8 * clustering.ROWS_PER_CTA


BATCHES = {"cases": two_stage_batch(), "slice_2x1024": slice_batch()}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", list(BATCHES))
def test_batched_kernel_equals_plain(batch):
    _card()
    pts, valid, params = stack(BATCHES[batch])
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(
        *(torch.as_tensor(a) for a in (pts, valid, params)))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and tuple(got.shape) == valid.shape
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_batched_kernel_any_cluster_size(cluster):
    """The labels do not depend on how many CTAs share a set (0: the size
    the library picks for this card, 16 or 8)."""
    _card()
    pts, valid, params = stack(BATCHES["slice_2x1024"])
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    got = clustering.launch_dbscan(*args, cluster=cluster)
    assert clustering.auto_cluster_size() in (8, 16)
    ref = clustering.two_stage_cluster_reference(
        *(torch.as_tensor(a) for a in (pts, valid, params)))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
def test_batched_kernel_refuses_what_it_cannot_take():
    _card()
    p = torch.zeros(2, 64, 3, device="cuda")
    v = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    q = torch.zeros(2, 4, device="cuda")
    bad = [(p.double(), v, q), (p, v.int(), q), (p, v, q[:1]),
           (p.transpose(0, 1).contiguous().transpose(0, 1), v, q),
           (p, v[:, :32], q), (p.cpu(), v, q)]
    for args in bad:
        with pytest.raises(ValueError):
            clustering.launch_dbscan(*args)
    with pytest.raises(RuntimeError):
        clustering.launch_dbscan(p, v, q, cluster=3)


def urban_batch():
    """The car, tree and lightpole sets of the urban mission's keyframe with
    the most car points (simulator labels), padded to 1024, with the outdoor
    classes' stage parameters: the C = 3 launch of the urban path."""
    from slide_slam_tpu_torch.io.synthetic import nearest_object_label
    from slide_slam_tpu_torch.frontend.pipeline import outdoor_classes
    from slide_slam_tpu_torch.geometry import se3np
    from slide_slam_tpu_torch.io import synthetic
    m = synthetic.make_lidar_mission(n_cars=15, n_keyframes=40)
    labels = [nearest_object_label(m.world, se3np.apply(m.traj[k], s))
              for k, s in enumerate(m.scans)]
    k = int(np.argmax([(lab == synthetic.CAR).sum() for lab in labels]))
    world = se3np.apply(m.odom[k], m.scans[k])
    sets = []
    for spec in outdoor_classes():
        if spec.model == "ground":
            continue
        pts = world[labels[k] == spec.label][:1024]
        pad = np.zeros((1024, 3), np.float32)
        pad[:len(pts)] = pts
        valid = np.arange(1024) < len(pts)
        sets.append((pad, valid, clustering.stage_params(
            spec.eps_noise, spec.min_samples_noise, spec.eps_cluster,
            spec.min_samples_cluster)))
    return sets


@pytest.mark.cuda
def test_batched_kernel_three_classes_equals_plain():
    """Car + tree + lightpole in the one launch the urban path makes."""
    _card()
    sets = urban_batch()
    pts, valid, params = (np.stack([s[i] for s in sets]) for i in range(3))
    assert valid[0].sum() > 0
    args = [torch.as_tensor(a, device="cuda") for a in (pts, valid, params)]
    before = clustering.launch_dbscan.launches
    got = clustering.two_stage_cluster_batch(*args)
    assert clustering.launch_dbscan.launches == before + 1
    ref = clustering.two_stage_cluster_reference(
        *(torch.as_tensor(a) for a in (pts, valid, params)))
    assert (ref[0] >= 0).any()
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmentator_card_equals_cpu(dtype):
    """The small net with seeded weights and random BatchNorm statistics on
    the card (TF32 off) and on the CPU: f32 logits within 2e-4 and the same
    labels; bf16 logits within 0.1 (1 bf16 ulp per conv, compounded)."""
    _card()
    from slide_slam_tpu_torch.frontend import segmentation as seg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    model = seg.init_params(seg.small_segmentator(16, dtype=tdt), gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, seg.BatchNorm):
                mod.mean.normal_(0, 0.1, generator=gen)
                mod.var.uniform_(0.5, 1.5, generator=gen)
    x = torch.randn(2, 16, 256, 5, generator=gen)
    want = seg._eval_logits(model.eval(), x)
    got = seg._eval_logits(model.cuda(), x.cuda()).cpu()
    tol = 2e-4 if dtype == "f32" else 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    if dtype == "f32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1).numpy())


def _rgbd_frame(seed, H=480, W=640, K=12):
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 12000, (H, W)).astype(np.uint16)
    masks = np.zeros((K, H, W), bool)
    for k in range(K):
        y0, x0 = rng.integers(0, H - 40), rng.integers(0, W - 40)
        h, w = rng.integers(20, 200), rng.integers(20, 300)
        masks[k, y0:y0 + h, x0:x0 + w] = True
    masks[-1] |= masks[0]
    return (depth, masks, rng.integers(0, 9, K).astype(np.int32),
            rng.uniform(0.0, 1.0, K).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_backproject_card_equals_cpu(seed):
    """rgbd.backproject (plain PyTorch ops) on the card against the CPU at
    640 x 480: label, instance, valid and confidence identical, xyz within
    1e-6 m; the world transform too."""
    _card()
    from slide_slam_tpu_torch.frontend import rgbd
    depth, masks, labels, conf = _rgbd_frame(seed)
    args = (525.0, 525.0, 319.5, 239.5)
    kw = dict(depth_scale=1e-3, max_depth=10.0, conf_thresh=0.4)
    pose = np.array([0.9, 0.1, -0.3, 0.2, 1.5, -2.0, 0.4], np.float32)
    pose[:4] /= np.linalg.norm(pose[:4])
    out = {}
    for dev in ("cuda", "cpu"):
        t = [torch.from_numpy(a).to(dev) for a in
             (depth.astype(np.float32), masks, labels, conf)]
        cloud = rgbd.backproject(*t, *args, **kw)
        out[dev] = (rgbd.host_cloud(cloud),
                    rgbd.host_cloud(rgbd.to_world(cloud, pose)))
        assert cloud.xyz.device.type == dev
    for got, want in zip(out["cuda"], out["cpu"]):
        for key in ("label", "instance", "valid", "confidence"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(want, key))
        np.testing.assert_allclose(got.xyz, want.xyz, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_checkpoint_card_to_cpu_and_back(tmp_path):
    """A node saved on the card loads on the CPU and back on the card with
    every GraphState field bit for bit (dtypes too), and both continue to
    the same landmark counts."""
    _card()
    from slide_slam_tpu_torch import config
    from slide_slam_tpu_torch.io import checkpoint, synthetic
    from slide_slam_tpu_torch.runtime.node import SlamNode
    cfg = config.SlamConfig(number_of_robots=2, capacity=config.CapacityConfig(
        max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
        max_points=64, max_scan_objects=32, max_cylinder_factors=512,
        max_cuboid_factors=256, max_point_factors=256,
        max_between_factors=16))
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=25, n_poles=5, n_cars=5,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(16, extent=16.0, rows=1, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01)
    node = SlamNode(cfg, robot_id=0, device="cuda")
    for kf in log.keyframes[:10]:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    checkpoint.save_node(str(tmp_path / "card"), node)
    cpu = checkpoint.load_node(str(tmp_path / "card"), cfg, device="cpu")
    checkpoint.save_node(str(tmp_path / "cpu"), cpu)
    back = checkpoint.load_node(str(tmp_path / "cpu"), cfg, device="cuda")
    for restored, dev in ((cpu, "cpu"), (back, "cuda")):
        for f in node.state._fields:
            a, b = getattr(restored.state, f), getattr(node.state, f)
            assert a.device.type == dev and a.dtype == b.dtype, f
            assert torch.equal(a.cpu(), b.cpu()), f
    for n in (node, cpu, back):
        for kf in log.keyframes[10:]:
            n.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    assert node.landmark_counts() == cpu.landmark_counts() == \
        back.landmark_counts()
    np.testing.assert_allclose(back.optimized_trajectory(),
                               node.optimized_trajectory(), atol=1e-3)


def _solver_state(device):
    """The sharded solves' test state (tests/test_torch_sharded.py): 25
    keyframes of a small forest through the port's node on the CPU, moved
    to `device` (numpy and the port only)."""
    from slide_slam_tpu_torch import config, convert
    from slide_slam_tpu_torch.io import synthetic
    from slide_slam_tpu_torch.runtime.node import SlamNode
    cfg = config.SlamConfig(number_of_robots=2, capacity=config.CapacityConfig(
        max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
        max_points=64, max_scan_objects=32, max_cylinder_factors=1024,
        max_cuboid_factors=512, max_point_factors=512,
        max_between_factors=32))
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=6, n_cars=6,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(25, extent=16.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.02, seed=1)
    node = SlamNode(cfg, robot_id=0, device="cpu")
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    return cfg, convert.state_from_numpy(convert.state_to_numpy(node.state),
                                         device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("block_precond", [False, True])
def test_unified_solve_card_equals_cpu(block_precond):
    """The unified-variable solve (engine.solve_full, use_schur=False) on
    the card against the CPU from the same state: poses within 1e-3 m
    (quaternions up to sign; the card's atomic index_add_ sums in another
    order), cost within 1e-3 relative."""
    _card()
    import dataclasses
    from slide_slam_tpu_torch.factorgraph import solver
    from slide_slam_tpu_torch.runtime import engine
    cfg, state = _solver_state("cpu")
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, use_schur=False, use_block_jacobi=block_precond))
    want = engine.solve_full(cfg, state)
    got = engine.solve_full(cfg, _to(state, "cuda"))
    assert got.poses.is_cuda
    assert _pose_gap(got.poses.cpu(), want.poses) <= 1e-3
    sig = (cfg.noise.cylinder, cfg.noise.bearing)
    c_cpu = float(solver.cost(want, *sig))
    assert abs(float(solver.cost(got, *sig)) - c_cpu) <= 1e-3 * c_cpu


def _to(state, device):
    return type(state)(*(f.to(device) for f in state))


def _pose_gap(a, b):
    """Largest gap of two [N, 7] pose arrays: translations, and quaternions
    after aligning their signs (q and -q are one rotation)."""
    a, b = np.asarray(a), np.asarray(b)
    sign = np.where((a[:, :4] * b[:, :4]).sum(1, keepdims=True) < 0, -1, 1)
    return max(np.abs(a[:, 4:] - b[:, 4:]).max(),
               np.abs(sign * a[:, :4] - b[:, :4]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["factor", "landmark"])
def test_sharded_solve_on_card_equals_local(kind):
    """distributed_solve (factor-sharded unified) and landmark_sharded_solve
    (landmark-sharded Schur) with 4 shards in lockstep on the card against
    the local solve on the card, from chip_smoke's check:sharded_solves
    state (the sharded tests' graph, its poses kicked 5 cm off, so the
    solve moves them > 10 cm): poses within 1e-2 m (tests/
    test_distributed_ba.py's bound), cost within 1e-3 relative, every
    integer field identical."""
    _card()
    import dataclasses
    import chip_smoke
    from slide_slam_tpu_torch.factorgraph import solver
    from slide_slam_tpu_torch.parallel import distributed_ba, landmark_sharded
    from slide_slam_tpu_torch.runtime import engine
    cfg, state = chip_smoke.sharded_check_state("cuda")
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, use_schur=kind == "landmark"))
    fn = (distributed_ba.distributed_solve if kind == "factor"
          else landmark_sharded.landmark_sharded_solve)
    local = engine.solve_full(cfg, state)
    sharded = fn(state, cfg, n_shards=4)
    assert sharded.poses.is_cuda
    assert _pose_gap(state.poses.cpu(), local.poses.cpu()) > 0.1
    assert _pose_gap(sharded.poses.cpu(), local.poses.cpu()) <= 1e-2
    sig = (cfg.noise.cylinder, cfg.noise.bearing)
    c_local = float(solver.cost(local, *sig))
    assert abs(float(solver.cost(sharded, *sig)) - c_local) <= 1e-3 * c_local
    for f, a in zip(sharded._fields, sharded):
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, getattr(local, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("schur", [True, False])
def test_full_solve_on_card_against_oracle(schur):
    """The card's solve_full (Schur, or the unified solve) from
    check:sharded_solves' state (its poses kicked 5 cm off) against the
    port's f64 Levenberg-Marquardt oracle on a host copy of the solved
    graph: RMS position gap < 5 cm (tests/test_solver_vs_reference.py's
    bound after a closure) and at most a tenth of the start's (on the CPU:
    0.39 mm against 7.3 cm), and the card's cost within 1e-2 relative of
    the optimum's (on the CPU 1.9e-3 above it: LM ends lower along weakly
    observed directions)."""
    _card()
    import dataclasses
    import chip_smoke
    from slide_slam_tpu_torch.factorgraph import reference_solver as rs
    from slide_slam_tpu_torch.runtime import engine
    cfg, state = chip_smoke.sharded_check_state("cuda")
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                 use_schur=schur))
    solved = engine.solve_full(cfg, state)
    assert solved.poses.is_cuda
    conv, info = rs.solve_reference(solved, cyl_sigma=cfg.noise.cylinder,
                                    bearing_sigma=cfg.noise.bearing)
    n = int(state.pose_count[0])
    rms = [float(np.sqrt(np.mean(np.sum(
        (conv[:n, 4:7] - s.poses[:n, 4:7].cpu().numpy()) ** 2, axis=1))))
        for s in (solved, state)]
    assert rms[0] < 0.05 and rms[0] <= 0.1 * rms[1], rms
    assert info["initial_cost"] <= (1 + 1e-2) * info["final_cost"]


@pytest.mark.cuda
def test_bag_converted_on_card_machine_equals_log(tmp_path):
    """A log written as a SemanticMeasSyncOdom bag and converted back by
    `convert-bag` on the machine with the card: every array bit for bit
    (true_pose the odometry: a bag carries no ground truth), and the first
    keyframes of both logs through SlamNode on the card give the same
    landmark counts."""
    _card()
    from slide_slam_tpu_torch import cli, config
    from slide_slam_tpu_torch.io import logs, rosbag, synthetic
    from slide_slam_tpu_torch.runtime.node import SlamNode
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=5,
                                        n_cars=5, extent=25.0)
    traj = synthetic.lawnmower_trajectory(12, extent=20.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.005)
    src, bag, dst = (str(tmp_path / n) for n in ("s.npz", "r.bag", "c.npz"))
    logs.save_log(src, log)
    rosbag.robot_log_to_bag(bag, logs.load_log(src))
    cli.main(["convert-bag", "--bag", bag, "--out", dst])
    a, b = np.load(src), np.load(dst)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        want = a["odom_pose"] if k == "true_pose" else a[k]
        assert b[k].dtype == want.dtype, k
        np.testing.assert_array_equal(b[k], want, err_msg=k)
    counts = []
    for path in (src, dst):
        node = SlamNode(config.SlamConfig(number_of_robots=1), robot_id=0,
                        device="cuda")
        for kf in logs.load_log(path).keyframes[:6]:
            node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        counts.append(node.landmark_counts())
    assert counts[0] == counts[1] and counts[0]["cylinders"] > 0


@pytest.mark.cuda
def test_dbscan_on_every_card_from_one_process():
    """The kernel on chip_smoke's kitti_sets at 1024 and 4096 points (the
    shared-memory and the sparse path) on every card in turn, from one
    process whose current card stays 0: labels on the points' card, exactly
    equal to the plain version's there; each card picks its own cluster
    size (the kernel's attributes are set per card)."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more cards: the launch on a card that is not "
                    "the current one")
    import chip_smoke
    torch.cuda.set_device(0)
    for k in range(torch.cuda.device_count()):
        for n in (1024, 4096):
            args = [torch.as_tensor(a, device=f"cuda:{k}")
                    for a in chip_smoke.kitti_sets(n)]
            before = clustering.launch_dbscan.launches
            got = clustering.two_stage_cluster_batch(*args)
            assert clustering.launch_dbscan.launches == before + 1
            assert got.device == args[0].device
            with torch.cuda.device(k):
                assert clustering.auto_cluster_size(n) in (8, 16)
            ref = clustering.two_stage_cluster_reference(*args)
            torch.cuda.synchronize(k)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          ref.cpu().numpy())
            assert torch.cuda.current_device() == 0


def _nccl_team_step_rank(cfg, n_steps):
    import torch.distributed as dist
    from slide_slam_tpu_torch.parallel import multiprocess
    poses, counts, _ = multiprocess.run_spmd_mission_step(cfg, n_steps)
    return dict(backend=dist.get_backend(), card=torch.cuda.current_device(),
                poses=poses, counts=counts,
                gathers=multiprocess.local_batch_to_global.calls)


@pytest.mark.cuda
def test_one_rank_nccl_team_step_equals_one_process():
    """multiprocess.run_spmd_mission_step in a one-rank NCCL group started
    by multiprocess.launch (the packets and TF tables all-gathered through
    NCCL) against the same step in this process without a group, on card
    0: counts identical, poses within chip_smoke.MULTICARD_POSE_TOL (the
    card's run-to-run spread, PERF.md §6)."""
    _card()
    import chip_smoke
    from slide_slam_tpu_torch.parallel import multiprocess
    cfg = chip_smoke.team_step_config()
    out, = multiprocess.launch(_nccl_team_step_rank, 1, args=(cfg, 3),
                               device="cuda", timeout_s=300)
    assert out["backend"] == "nccl" and out["card"] == 0
    assert out["gathers"] == 17 * 4     # a step gathers 17 fields
    poses, counts, _ = multiprocess.run_spmd_mission_step(cfg, 3)
    np.testing.assert_array_equal(out["counts"], counts)
    assert (counts == 4).all()
    np.testing.assert_allclose(out["poses"], poses, rtol=0,
                               atol=chip_smoke.MULTICARD_POSE_TOL)

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

from _dbscan_cases import CASES, slice_batch, stack, trees, two_stage_batch


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
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(1025, 3, device="cuda"),
                          torch.ones(1025, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 2, device="cuda"),
                          torch.ones(8, dtype=torch.bool, device="cuda"),
                          0.5, 5)
    with pytest.raises(ValueError):
        clustering.dbscan(torch.zeros(8, 3, device="cuda"),
                          torch.ones(7, dtype=torch.bool, device="cuda"),
                          0.5, 5)


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

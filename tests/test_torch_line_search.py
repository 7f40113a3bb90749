"""The Schur solve's line search as one capturable function, on the CPU.

`schur.line_search` is the segment a CUDA graph captures on the card
(runtime/cuda_graphs.py): it must make no host read and copy no host data,
or the capture fails. Off the card, and in a sharded solve (a `reduce`
that is not the identity), the solve runs it eagerly and its
`solve.line_search` span reads `ls_graph` 0. The card's side is in
tests/test_torch_cuda_graphs.py.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.factorgraph import schur, solver
from slide_slam_tpu_torch.geometry import se3
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import profiling
from slide_slam_tpu_torch.runtime.node import SlamNode

CAPACITY = dict(
    max_poses_per_robot=16, max_cylinders=64, max_cuboids=16, max_points=16,
    max_scan_objects=32, max_cylinder_factors=256, max_cuboid_factors=64,
    max_point_factors=64, max_between_factors=8)
SIGMAS = dict(cyl_sigma=0.2, bearing_sigma=1.0)
# ops that read a device value on the host, make a tensor from host data,
# or size their output by the data: none may run inside a captured graph
UNCAPTURABLE = ("_local_scalar_dense", "lift_fresh", "nonzero",
                "masked_select", "_unique", "unique_", "repeat_interleave")


@pytest.fixture(scope="module")
def state():
    """12 keyframes of a small forest with every landmark family, poses
    kicked 5 cm off so that the solve has work to do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(0)
        world = synthetic.make_forest_world(rng, n_trees=20, n_poles=4,
                                            n_cars=4, extent=14.0)
        traj = synthetic.lawnmower_trajectory(12, extent=10.0, rows=2,
                                              step=1.5)
        log = synthetic.make_log(world, traj, odom_drift_sigma=0.01,
                                 pos_noise=0.03)
        cfg = tconfig.SlamConfig(
            number_of_robots=1, turn_off_intra_loop_closure=True,
            capacity=tconfig.CapacityConfig(**CAPACITY))
        node = SlamNode(cfg, robot_id=0, device="cpu")
        for kf in log.keyframes:
            node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        s = node.state
        g = torch.Generator().manual_seed(3)
        poses = s.poses + 0.05 * torch.randn(s.poses.shape, generator=g)
        poses[:, :4] /= torch.linalg.norm(poses[:, :4], dim=1, keepdim=True)
        return s._replace(poses=poses)
    finally:
        torch.set_num_threads(n)


def _step(s):
    """The tangent one outer iteration hands to the line search."""
    op = schur.build_operands(s, SIGMAS["cyl_sigma"],
                              SIGMAS["bearing_sigma"], 1e-6)
    dp, dl = schur.solve_reduced(op, 1e-6, 48, 1e-6)
    NC, NK = s.cyl_ray.shape[0], s.cub_pose.shape[0]
    return solver.Tangent(pose=dp, cyl=dl[:NC, :7], cub=dl[NC:NC + NK],
                          pt=dl[NC + NK:, :3])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_the_segment_is_capturable(state):
    dx = _step(state)
    scales = torch.tensor([1.0, 0.5, 0.25])
    with _Ops() as ops:
        new, more = schur.line_search(state, dx, scales, rel_tol=1e-6,
                                      **SIGMAS)
    assert more.shape == () and more.dtype == torch.bool
    assert len(ops.names) > 500
    bad = sorted({n for n in ops.names
                  if any(n.startswith(u) for u in UNCAPTURABLE)})
    assert bad == []
    # the state it returns shares every field it does not retract
    kept = [f for f in state._fields
            if getattr(new, f) is getattr(state, f)]
    assert set(state._fields) - set(kept) == {
        "poses", "cyl_ray", "cyl_root", "cyl_radius", "cub_pose",
        "cub_scale", "pt_pos", "keypose_xyz"}


@pytest.mark.parametrize("device,sharded,graph", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False),
    ("cpu", True, False)])
def test_the_graph_runs_on_a_card_in_an_unsharded_solve(device, sharded,
                                                        graph):
    reduce = (lambda x: x) if sharded else solver._identity
    assert schur._graph_ok(torch.device(device), reduce) is graph


@pytest.mark.parametrize("sharded", [False, True])
def test_off_the_card_the_solve_runs_it_eagerly(state, sharded):
    reduce = (lambda x: x) if sharded else solver._identity
    profiling.reset()
    profiling.enable()
    before = profiling.phase_counts().get("ls_graph_capture", 0)
    try:
        out = schur.solve(state, outer_iters=3, pcg_iters=48, reduce=reduce,
                          **SIGMAS)
    finally:
        profiling.disable()
    spans = profiling.spans()["spans"]
    profiling.reset()
    ls = [s for s in spans if s["name"] == "solve.line_search"]
    assert len(ls) >= 1
    assert [s["attrs"]["ls_graph"] for s in ls] == [0] * len(ls)
    assert profiling.phase_counts().get("ls_graph_capture", 0) == before
    c = lambda s: float(solver.cost(s, **SIGMAS))
    assert c(out) < c(state)


def test_quat_conj_is_the_sign_product():
    """quat_conj negates the vector part: bit for bit the product with
    [1, -1, -1, -1] it replaced, signed zeros included."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4096, 4), generator=g)
    q[::7] = 0.0
    q[1::7] = -0.0
    q[2::7, 0] = -0.0
    want = q * torch.tensor([1.0, -1.0, -1.0, -1.0])
    got = se3.quat_conj(q)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))

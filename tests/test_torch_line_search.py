"""The Schur solve's CUDA-graph segments as capturable functions, on the CPU.

`schur.line_search` and `schur.pcg_block` (a block of PCG iterations on the
reduced system) are the segments CUDA graphs capture on the card
(runtime/cuda_graphs.py): they must make no host read and copy no host
data, or the capture fails. Off the card, and in a sharded solve (a
`reduce` that is not the identity), the solve runs both eagerly: its
`solve.line_search` spans read `ls_graph` 0 and its `solve.pcg` spans
`pcg_graph` 0. The graphed PCG loop is checked here on the CPU with the
graph's replays emulated by calls of the captured function. The card's
side is in tests/test_torch_cuda_graphs.py.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.factorgraph import schur, solver
from slide_slam_tpu_torch.geometry import se3
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import cuda_graphs, profiling
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


def _pcg_inputs(s, block_precond=False):
    """The inputs of a graphed PCG block at the start of a solve of s."""
    op = schur.build_operands(s, SIGMAS["cyl_sigma"],
                              SIGMAS["bearing_sigma"], 1e-6, block_precond)
    prec = op.prec_inv if block_precond else \
        1.0 / (op.diag_p * (1.0 + 1e-6) + 1e-8)
    b = -op.g_p
    c = solver.pcg_start(b, schur._preconditioner(prec))
    return ([getattr(op, f) for f in schur._MATVEC_FIELDS] + [prec]
            + list(c) + [solver.pcg_threshold(c.rz, 1e-6)])


@pytest.mark.parametrize("block_precond", [False, True])
def test_the_pcg_block_is_capturable(state, block_precond):
    """A block of 8 PCG iterations makes no host read and copies no host
    data; it writes the carry after 8 eager iterations over its input carry
    and returns the stop test."""
    x = _pcg_inputs(state, block_precond)
    m = len(schur._MATVEC_FIELDS)
    c = solver.PcgCarry(*x[m + 1:-1])
    hv = lambda v: schur.s_matvec(schur._matvec_operands(x[:m]), v, 1e-6)
    zero = torch.zeros(())
    for _ in range(8):
        c = solver.pcg_step(c, x[-1], zero, hv, schur._preconditioner(x[m]),
                            48, 1e-3)
    inputs = [t.clone() for t in x]
    with _Ops() as ops:
        more, = schur.pcg_block(8, 1e-6, 48, 1e-3)(inputs)
    assert len(ops.names) > 400
    bad = sorted({n for n in ops.names
                  if any(n.startswith(u) for u in UNCAPTURABLE)})
    assert bad == []
    for got, want in zip(inputs[m + 1:-1], c):
        assert torch.equal(got, want)
    assert torch.equal(more, solver.pcg_more(c, x[-1], 48))
    for got, want in zip(inputs[:m + 1] + inputs[-1:], x[:m + 1] + x[-1:]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("sharded", [False, True])
def test_off_the_card_pcg_runs_eagerly(state, sharded):
    """Every solve.pcg span of a CPU or sharded Schur solve reads pcg_graph
    0, and no PCG graph is captured."""
    reduce = (lambda x: x) if sharded else solver._identity
    profiling.reset()
    profiling.enable()
    before = profiling.phase_counts().get("pcg_graph_capture", 0)
    try:
        schur.solve(state, outer_iters=2, pcg_iters=48, reduce=reduce,
                    **SIGMAS)
    finally:
        profiling.disable()
    spans = profiling.spans()["spans"]
    profiling.reset()
    pcg = [s for s in spans if s["name"] == "solve.pcg"]
    assert len(pcg) >= 1
    assert [s["attrs"]["pcg_graph"] for s in pcg] == [0] * len(pcg)
    assert all(s["attrs"]["pcg_iters"] >= 1 for s in pcg)
    assert profiling.phase_counts().get("pcg_graph_capture", 0) == before


@contextlib.contextmanager
def _emulated_bound(name, key, fn, inputs):
    """cuda_graphs.bound on the CPU: each replay calls the captured function
    on the bound buffers."""
    buffers = [t.clone() for t in inputs]
    profiling.phase_add(name + "_capture", 0.0)
    g = type("G", (), {})()
    g.inputs = buffers
    g.replay = lambda: fn(buffers)
    g.take = lambda ts: [t.clone() for t in ts]
    yield g


@pytest.mark.parametrize("pcg_iters,tol,step_tol,block_precond", [
    (48, 1e-3, 1e-3, False), (13, 1e-8, 0.0, False), (256, 1e-8, 0.0, True)])
def test_the_graphed_loop_equals_the_eager_one(monkeypatch, state,
                                                 pcg_iters, tol, step_tol,
                                                 block_precond):
    """schur._pcg_graphed, its replays emulated, returns what solver.pcg
    returns bit for bit, with as many iterations and one stop read a block
    (13 = a block of 8 and a graph of its own for the last 5)."""
    monkeypatch.setattr(cuda_graphs, "bound", _emulated_bound)
    x = _pcg_inputs(state, block_precond)
    m = len(schur._MATVEC_FIELDS)
    op = schur._matvec_operands(x[:m])
    b = x[m + 2]                                    # the carry's r
    profiling.reset()
    profiling.enable()
    try:
        got = schur._pcg_graphed(op, x[m], b, 1e-6, pcg_iters, tol, step_tol)
        want = solver.pcg(lambda v: schur.s_matvec(op, v, 1e-6), b,
                          schur._preconditioner(x[m]), pcg_iters, tol,
                          step_tol)
    finally:
        profiling.disable()
    spans = profiling.spans()["spans"]
    profiling.reset()
    assert torch.equal(got, want)
    pcg = [s for s in spans if s["name"] == "solve.pcg"]
    assert [s["attrs"]["pcg_graph"] for s in pcg] == [1, 0]
    assert pcg[0]["attrs"]["pcg_iters"] == pcg[1]["attrs"]["pcg_iters"] > 0
    reads = [[s for s in spans if s["name"] == "sync.pcg_stop"
              and p["start_ns"] <= s["start_ns"] <= p["end_ns"]]
             for p in pcg]
    assert len(reads[0]) == len(reads[1]) >= 1


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

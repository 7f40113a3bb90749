"""The Schur solve's CUDA graphs, on the card: the line search, and each
block of PCG iterations on the reduced system.

Marked `cuda`: each test skips with a reason where there is no card. This
file imports no JAX, so it runs on a machine with PyTorch and a card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_graphs.py

A graph replays the kernels the eager function launches, in the same
order. The line search sums in a fixed order, so its state and stop flag
must equal the eager function's BIT FOR BIT on the same inputs: over every
line search of a forest mission's incremental solves and of a full solve,
across threads sharing the card, and for states returned earlier, which no
later replay may rewrite. PCG's `index_add_` sums in an order that changes
from run to run unless deterministic algorithms are on; the PCG tests turn
them on, and the graphed PCG must then equal the eager one bit for bit too.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.factorgraph import graph, schur, solver
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import cuda_graphs, engine, profiling
from slide_slam_tpu_torch.runtime.node import SlamNode

N_KF = 24
SIGMAS = (0.2, 1.0, 1e-6)       # cyl_sigma, bearing_sigma, rel_tol
CAPACITY = dict(max_poses_per_robot=32, max_cylinders=128, max_cuboids=64,
                max_points=32, max_scan_objects=32, max_cylinder_factors=768,
                max_cuboid_factors=256, max_point_factors=256,
                max_between_factors=8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Schur solve's graphs run there")


def _config(**capacity):
    return tconfig.SlamConfig(
        number_of_robots=1, turn_off_intra_loop_closure=True,
        capacity=tconfig.CapacityConfig(**dict(CAPACITY, **capacity)))


@pytest.fixture(scope="module")
def log():
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=40, n_poles=6, n_cars=6,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(N_KF, extent=16.0, rows=2,
                                          step=1.5)
    return synthetic.make_log(world, traj, odom_drift_sigma=0.01,
                              pos_noise=0.03)


def _mission(log, cfg):
    node = SlamNode(cfg, robot_id=0, device="cuda")
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    return node


@pytest.fixture(scope="module")
def mission(log):
    """The forest mission's state on the card, poses kicked 5 cm off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Schur solve's graphs run there")
    cfg = _config()
    s = _mission(log, cfg).state
    g = torch.Generator(device="cuda").manual_seed(3)
    poses = s.poses + 0.05 * torch.randn(s.poses.shape, device="cuda",
                                         generator=g)
    poses[:, :4] /= torch.linalg.norm(poses[:, :4], dim=1, keepdim=True)
    return cfg, s._replace(poses=poses)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _dx(s, seed, size=0.02):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return solver.Tangent(*(size * torch.randn(t.shape, device="cuda",
                                               generator=g)
                            for t in solver.tangent_zeros(s)))


def _scales():
    return torch.tensor([1.0, 0.5, 0.25], device="cuda")


def _graphed(s, dx):
    return schur._line_search(s, dx, _scales(), *SIGMAS, solver._identity)


def _eager(s, dx):
    return schur.line_search(s, dx, _scales(), *SIGMAS)


def _captures():
    return profiling.phase_counts().get("ls_graph_capture", 0)


@pytest.mark.cuda
def test_graph_equals_eager_over_a_mission(monkeypatch, log, mission):
    """Every line search of 24 keyframes' incremental solves and of a full
    solve, replayed and run eagerly on the same inputs: equal bit for bit."""
    _card()
    cfg, _ = mission
    graphed, calls = schur._line_search, []

    def both(s, dx, scales, cyl_sigma, bearing_sigma, rel_tol, reduce):
        got, more = graphed(s, dx, scales, cyl_sigma, bearing_sigma,
                            rel_tol, reduce)
        want, want_more = schur.line_search(s, dx, scales, cyl_sigma,
                                            bearing_sigma, rel_tol)
        calls.append(bool(more))
        assert _same(more, want_more)
        for f in s._fields:
            assert _same(getattr(got, f), getattr(want, f)), f
        return got, more
    monkeypatch.setattr(schur, "_line_search", both)
    node = _mission(log, cfg)
    incremental = len(calls)
    assert incremental >= 20
    state = node.state._replace(poses=mission[1].poses)
    engine.solve_full(cfg, state)
    assert len(calls) > incremental
    assert any(calls) and not all(calls)    # steps taken, and a stop


@pytest.mark.cuda
def test_a_second_shape_captures_once():
    _card()
    a = graph.empty_state(_config(max_poses_per_robot=9), device="cuda")
    b = graph.empty_state(_config(max_poses_per_robot=10), device="cuda")
    n0 = _captures()
    for s, want in ((a, 1), (a, 1), (b, 2), (b, 2), (a, 2)):
        _graphed(s, _dx(s, 0))
        assert _captures() == n0 + want


@pytest.mark.cuda
def test_returned_states_are_fresh_memory(mission):
    """A state returned earlier keeps its values through later replays; its
    retracted fields lie outside every graph's buffers and the fields it
    does not retract are the caller's own tensors."""
    _card()
    _, s = mission
    first, _ = _graphed(s, _dx(s, 1))
    kept = [t.clone() for t in first]
    later = [_graphed(s, _dx(s, seed))[0] for seed in (2, 3)]
    assert not _same(later[0].poses, first.poses)
    for f, t in zip(first._fields, kept):
        assert _same(getattr(first, f), t), f
    owned = {b.untyped_storage().data_ptr()
             for e in cuda_graphs._GRAPHS.values()
             for b in e.static_in + e.static_out}
    for f in ("poses", "cyl_ray", "cyl_root", "cyl_radius", "cub_pose",
              "cub_scale", "pt_pos", "keypose_xyz"):
        assert getattr(first, f).untyped_storage().data_ptr() not in owned
        assert getattr(first, f) is not getattr(s, f)
    for f in ("pose_count", "cf_meas", "odom_rel", "overflow"):
        assert getattr(first, f) is getattr(s, f)


@pytest.mark.cuda
def test_threads_share_the_card(mission):
    """12 threads (more than the host's cores) replay one graph 5 times each
    on inputs of their own: each result equals the eager one."""
    _card()
    _, s = mission
    n_threads, rounds = 12, 5
    dxs = [_dx(s, 100 + i) for i in range(n_threads)]
    want = [_eager(s, dx) for dx in dxs]
    _graphed(s, dxs[0])                     # captured before the threads
    got = [[] for _ in range(n_threads)]
    errors = []

    def work(i):
        try:
            for _ in range(rounds):
                got[i].append(_graphed(s, dxs[i]))
        except Exception as e:              # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    torch.cuda.synchronize()
    for i in range(n_threads):
        assert len(got[i]) == rounds
        for state, more in got[i]:
            assert _same(more, want[i][1])
            for f in s._fields:
                assert _same(getattr(state, f), getattr(want[i][0], f)), f


@pytest.mark.cuda
def test_every_line_search_on_the_card_replays(mission):
    """ls_graph reads 1 on every solve.line_search span of a full solve."""
    _card()
    cfg, s = mission
    _graphed(s, _dx(s, 0))
    n0 = _captures()
    profiling.reset()
    profiling.enable()
    try:
        engine.solve_full(cfg, s)
    finally:
        profiling.disable()
    spans = [x for x in profiling.spans()["spans"]
             if x["name"] == "solve.line_search"]
    profiling.reset()
    assert len(spans) >= 1
    assert [x["attrs"]["ls_graph"] for x in spans] == [1] * len(spans)
    assert _captures() == n0


# ---------------------------------------------------------------------------
# PCG blocks
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    """Deterministic algorithms on (warn only where an op has none): CUDA's
    index_add_ then sums in a fixed order, eagerly and in a graph."""
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old


def _pcg_captures():
    return profiling.phase_counts().get("pcg_graph_capture", 0)


def _kicked(s, seed, size=0.05):
    g = torch.Generator(device="cuda").manual_seed(seed)
    poses = s.poses + size * torch.randn(s.poses.shape, device="cuda",
                                         generator=g)
    poses[:, :4] /= torch.linalg.norm(poses[:, :4], dim=1, keepdim=True)
    return s._replace(poses=poses)


def _reduced(s):
    """(operands, preconditioner, right-hand side) of s's reduced system,
    as solve_reduced makes them (the scalar preconditioner)."""
    lam = SIGMAS[2]
    op = schur.build_operands(s, SIGMAS[0], SIGMAS[1], lam, False)
    prec = 1.0 / (op.diag_p * (1.0 + lam) + 1e-8)
    w0 = schur._bmv(op.Hll_inv, op.g_l)
    b = -op.g_p + schur._scatter_rows(
        op.pidx, schur._bmv(op.A, w0[op.lidx]), s.poses.shape[0])
    return op, prec, schur._project(op.frozen, b)


def _graphed_pcg(op, prec, b, max_iters=256, tol=1e-8, step_tol=0.0):
    return schur._pcg(op, prec, b, SIGMAS[2], max_iters, tol, step_tol,
                      solver._identity)


def _eager_pcg(op, prec, b, max_iters=256, tol=1e-8, step_tol=0.0):
    return solver.pcg(lambda x: schur.s_matvec(op, x, SIGMAS[2]), b,
                      schur._preconditioner(prec), max_iters, tol, step_tol)


@pytest.mark.cuda
def test_graphed_pcg_equals_eager_over_a_mission(monkeypatch, log, mission,
                                                 deterministic):
    """Every PCG of 24 keyframes' incremental solves and of a full solve,
    replayed block by block and run eagerly on the same operands: the same
    iterations, and dp equal bit for bit."""
    _card()
    cfg, _ = mission
    graphed, calls = schur._pcg, []

    def both(op, prec, b, lam, max_iters, tol, step_tol, reduce):
        got = graphed(op, prec, b, lam, max_iters, tol, step_tol, reduce)
        want = solver.pcg(lambda x: schur.s_matvec(op, x, lam), b,
                          schur._preconditioner(prec), max_iters, tol,
                          step_tol)
        calls.append(_same(got, want))
        return got
    monkeypatch.setattr(schur, "_pcg", both)
    profiling.reset()
    profiling.enable()
    try:
        node = _mission(log, cfg)
        incremental = len(calls)
        engine.solve_full(cfg, node.state._replace(poses=mission[1].poses))
    finally:
        profiling.disable()
    spans = [x["attrs"] for x in profiling.spans()["spans"]
             if x["name"] == "solve.pcg"]
    profiling.reset()
    assert incremental >= 20 and len(calls) > incremental
    assert all(calls), [i for i, ok in enumerate(calls) if not ok]
    assert len(spans) == 2 * len(calls)
    graph_iters = [a["pcg_iters"] for a in spans[0::2]]
    assert [a["pcg_graph"] for a in spans] == [1, 0] * len(calls)
    assert graph_iters == [a["pcg_iters"] for a in spans[1::2]]
    assert max(graph_iters) > 2 * solver.PCG_BLOCK    # several blocks ran


@pytest.mark.cuda
def test_a_second_pcg_shape_captures_once(deterministic):
    _card()
    a = graph.empty_state(_config(max_poses_per_robot=9), device="cuda")
    b = graph.empty_state(_config(max_poses_per_robot=10), device="cuda")
    ra, rb = _reduced(a), _reduced(b)
    n0 = _pcg_captures()
    for r, want in ((ra, 1), (ra, 1), (rb, 2), (rb, 2), (ra, 2)):
        _graphed_pcg(*r, max_iters=48, tol=1e-3, step_tol=1e-3)
        assert _pcg_captures() == n0 + want


@pytest.mark.cuda
def test_returned_dp_is_fresh_memory(mission, deterministic):
    """A dp returned earlier keeps its values through later replays, and
    lies outside every graph's buffers."""
    _card()
    _, s = mission
    first = _graphed_pcg(*_reduced(_kicked(s, 11)))
    kept = first.clone()
    later = [_graphed_pcg(*_reduced(_kicked(s, seed))) for seed in (12, 13)]
    assert not _same(later[0], first)
    assert _same(first, kept)
    owned = {t.untyped_storage().data_ptr()
             for e in cuda_graphs._GRAPHS.values()
             for t in e.static_in + e.static_out}
    assert first.untyped_storage().data_ptr() not in owned


@pytest.mark.cuda
def test_pcg_threads_share_the_card(mission, deterministic):
    """Two threads run graphed PCGs of their own operands 4 times each, on
    one graph: each dp equals the eager one bit for bit."""
    _card()
    _, s = mission
    problems = [_reduced(_kicked(s, 20 + i)) for i in range(2)]
    want = [_eager_pcg(*p) for p in problems]
    _graphed_pcg(*problems[0])              # captured before the threads
    got, errors = [[], []], []

    def work(i):
        try:
            for _ in range(4):
                got[i].append(_graphed_pcg(*problems[i]))
        except Exception as e:              # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(got[i]) == 4
        assert all(_same(dp, want[i]) for dp in got[i])


@pytest.mark.cuda
def test_every_pcg_on_the_card_replays(mission):
    """pcg_graph reads 1 on every solve.pcg span of a full solve, and the
    solve captures nothing new once its shapes have been seen."""
    _card()
    cfg, s = mission
    engine.solve_full(cfg, s)
    n0 = _pcg_captures()
    profiling.reset()
    profiling.enable()
    try:
        engine.solve_full(cfg, s)
    finally:
        profiling.disable()
    spans = [x for x in profiling.spans()["spans"]
             if x["name"] == "solve.pcg"]
    profiling.reset()
    assert len(spans) >= 1
    assert [x["attrs"]["pcg_graph"] for x in spans] == [1] * len(spans)
    assert _pcg_captures() == n0

"""The Schur solve's line search as a CUDA graph, on the card.

Marked `cuda`: each test skips with a reason where there is no card. This
file imports no JAX, so it runs on a machine with PyTorch and a card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_graphs.py

The graph replays the kernels the eager function launches, in the same
order, so its state and stop flag must equal the eager function's BIT FOR
BIT on the same inputs: over every line search of a forest mission's
incremental solves and of a full solve, across threads sharing the card,
and for states returned earlier, which no later replay may rewrite.
"""
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
        pytest.skip("needs a CUDA card: the line search's graph runs there")


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
        pytest.skip("needs a CUDA card: the line search's graph runs there")
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

"""Linearization and the Schur solve: the port (on the CPU) vs the JAX package
and vs the float64 oracle reference_solver.solve_reference.

One graph with every landmark family (trees and poles, cars as cuboids,
ellipsoid points) is built by the port's SlamNode on a synthetic log, carried
to numpy with convert.state_to_numpy, and handed to both packages
(convert.state_from_numpy for the port). Tolerances:

* linearization and Schur operands, 1e-4 relative to each array's largest
  entry: the same float32 formulas, fused and ordered differently; the JAX
  in-loop sums are bf16x3 one-hot matmuls (f32-grade, not bit-exact) where
  the port sums exactly with index_add_;
* poses after a solve, 1e-3 m and 1e-3 rad, and cylinder roots after the
  incremental step, 1e-3 m: PCG amplifies those last-bit differences over
  its iterations; the cost after a solve, 1e-3 relative (the JAX
  incremental PCG runs on the bf16x3 sums);
* the thorough solve lands within 5 cm ATE of the f64 optimum, the bound the
  JAX package's own test_schur.py holds its solver to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.config import SlamConfig as JSlamConfig
from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
from slide_slam_tpu.factorgraph import reference_solver as rs
from slide_slam_tpu.factorgraph import schur as jschur
from slide_slam_tpu.factorgraph import solver as jsolver
from slide_slam_tpu.factorgraph.graph import GraphState as JGraphState
from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu_torch import convert
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.factorgraph import schur as tschur
from slide_slam_tpu_torch.factorgraph import solver as tsolver
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import engine as tengine
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import jax_state_from_numpy

REL_TOL = 1e-4
POS_TOL = 1e-3      # m
ROT_TOL = 1e-3      # rad (quaternion vector part)
ORACLE_ATE = 0.05   # m

CAPACITY = dict(max_poses_per_robot=32, max_cylinders=128, max_cuboids=32,
                max_points=32, max_scan_objects=32, max_cylinder_factors=768,
                max_cuboid_factors=256, max_point_factors=256,
                max_between_factors=8)


def _configs():
    kw = dict(number_of_robots=1, turn_off_intra_loop_closure=True)
    return (JSlamConfig(capacity=JCapacityConfig(**CAPACITY), **kw),
            SlamConfig(capacity=CapacityConfig(**CAPACITY), **kw))


@pytest.fixture(scope="module")
def logged():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=40, n_poles=6, n_cars=6,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(24, extent=16.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01,
                             pos_noise=0.03)
    node = SlamNode(tcfg, robot_id=0, device="cpu")
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    assert sum(node.overflow_report().values()) == 0, node.overflow_report()
    counts = node.landmark_counts()
    assert min(counts.values()) > 0, counts     # every family is present
    state = convert.state_to_numpy(node.state)
    # perturb poses and cylinder roots so that the solves have work to do
    prng = np.random.default_rng(3)
    poses = state["poses"] + prng.normal(0, 0.05, state["poses"].shape)
    poses[:, :4] /= np.linalg.norm(poses[:, :4], axis=1, keepdims=True)
    state["poses"] = poses.astype(np.float32)
    state["cyl_root"] = (state["cyl_root"] + prng.normal(
        0, 0.05, state["cyl_root"].shape)).astype(np.float32)
    return jcfg, tcfg, state


def _both(state):
    return (jax_state_from_numpy(state),
            convert.state_from_numpy(state, device="cpu"))


def _close(got, want, name):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * scale,
                               err_msg=name)


def test_convert_round_trip(logged):
    _, _, state = logged
    t = convert.state_from_numpy(state, device="cpu")
    back = convert.state_to_numpy(t)
    assert set(back) == set(JGraphState._fields)
    for k, v in state.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert t.cf_pose.dtype == torch.int32 and t.pose_count.dtype == torch.int32


def test_linearize(logged):
    jcfg, _, state = logged
    js, ts = _both(state)
    sig = (jcfg.noise.cylinder, jcfg.noise.bearing)
    want = jax.jit(jsolver.linearize, static_argnums=(1, 2))(js, *sig)
    got = tsolver.linearize(ts, *sig)
    for name in jsolver.Linearization._fields:
        if name == "od_prev":
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        else:
            _close(getattr(got, name), getattr(want, name), name)
    _close(tsolver.cost(ts, *sig), jsolver.cost(js, *sig), "cost")


@pytest.mark.parametrize("exact_curvature", [False, True])
def test_build_operands(logged, exact_curvature):
    jcfg, _, state = logged
    js, ts = _both(state)
    args = (jcfg.noise.cylinder, jcfg.noise.bearing, 1e-4, True)
    want = jax.jit(jschur.build_operands, static_argnums=(1, 2, 3, 4),
                   static_argnames="exact_curvature")(
        js, *args, exact_curvature=exact_curvature)
    got = tschur.build_operands(ts, *args)     # exact sums: both branches
    for name in ("A", "Hll_inv", "Dp", "diag_p", "prec_inv", "g_p", "g_l",
                 "lm_active", "frozen"):
        _close(getattr(got, name), getattr(want, name), name)
    x = np.random.default_rng(1).normal(size=got.g_p.shape).astype(np.float32)
    _close(tschur.s_matvec(got, torch.as_tensor(x), 1e-4),
           jschur.s_matvec(want, jnp.asarray(x), 1e-4), "s_matvec")


def _check_poses(got, want, n):
    np.testing.assert_allclose(got[:n, 4:7], want[:n, 4:7], atol=POS_TOL,
                               rtol=0)
    sign = np.sign((got[:n, :4] * want[:n, :4]).sum(1, keepdims=True))
    np.testing.assert_allclose(sign * got[:n, 1:4], want[:n, 1:4],
                               atol=ROT_TOL, rtol=0)


@pytest.mark.parametrize("budget", ["incremental", "full"])
def test_schur_solve(logged, budget):
    jcfg, tcfg, state = logged
    js, ts = _both(state)
    if budget == "full":
        want = jengine.solve_full(jcfg, js)
        got = tengine.solve_full(tcfg, ts)
    else:
        want = jengine.solve_incremental(jcfg, js)
        got = tengine.solve_incremental(tcfg, ts)
    n = int(state["pose_count"][0])
    want_p, got_p = np.asarray(want.poses), got.poses.numpy()
    assert np.abs(got_p[:n] - state["poses"][:n]).max() > 1e-3, "no step"
    _check_poses(got_p, want_p, n)
    if budget == "incremental":
        # After the 16 thorough iterations the cylinder roots are not held
        # to the pose tolerance: their information (sigma 400 m, 1/sigma^2
        # ~ 6e-6 per factor) is below the solver's 1e-4 ridge, so a root
        # drifts along directions that change the cost by < 1e-6 relative,
        # and the two packages' last-bit differences move it by cm there.
        # The cost check below covers them.
        np.testing.assert_allclose(got.cyl_root.numpy(),
                                   np.asarray(want.cyl_root), atol=POS_TOL,
                                   rtol=0)
    sig = (jcfg.noise.cylinder, jcfg.noise.bearing)
    c_j = float(jsolver.cost(want, *sig))
    c_t = float(tsolver.cost(got, *sig))
    assert abs(c_t - c_j) <= 1e-3 * c_j, (c_t, c_j)
    assert c_t < float(tsolver.cost(ts, *sig))
    if budget == "full":
        oracle, _ = rs.solve_reference(JGraphState(**state),
                                       cyl_sigma=sig[0],
                                       bearing_sigma=sig[1])
        gap = np.linalg.norm(oracle[:n, 4:7] - got_p[:n, 4:7], axis=1)
        assert float(np.sqrt(np.mean(gap ** 2))) < ORACLE_ATE


def _inline_line_search(s, dx, scales, cyl_sigma, bearing_sigma, rel_tol):
    """The line search as schur.solve ran it inline before it became one
    function (the reference the function is held to)."""
    c0 = tsolver.cost(s, cyl_sigma, bearing_sigma)
    costs = torch.stack([
        tsolver.cost(tsolver.retract_state(s, tsolver.tree_scale(a, dx)),
                     cyl_sigma, bearing_sigma) for a in scales])
    best = torch.argmin(costs)
    accept = costs[best] < c0
    alpha = torch.where(accept, scales[best], torch.zeros_like(c0))
    improved = (c0 - costs[best]) > rel_tol * (c0 + 1e-9)
    s = tsolver.retract_state(s, tsolver.tree_scale(alpha, dx))
    return s, accept & improved


@pytest.mark.parametrize("direction", [1.0, -1.0])
def test_line_search_equals_the_inline_code(logged, direction):
    """schur.line_search returns exactly what the inline code returned, on
    an accepted step (the PCG direction) and a rejected one (reversed):
    every state field bit for bit, and the stop flag."""
    _, tcfg, state = logged
    _, s = _both(state)
    sig = (tcfg.noise.cylinder, tcfg.noise.bearing)
    op = tschur.build_operands(s, *sig, 1e-6)
    dp, dl = tschur.solve_reduced(op, 1e-6, 48, 1e-6)
    NC, NK = s.cyl_ray.shape[0], s.cub_pose.shape[0]
    dx = tsolver.tree_scale(direction, tsolver.Tangent(
        pose=dp, cyl=dl[:NC, :7], cub=dl[NC:NC + NK], pt=dl[NC + NK:, :3]))
    scales = torch.tensor([1.0, 0.5, 0.25])
    want, want_more = _inline_line_search(s, dx, scales, *sig, 1e-6)
    got, more = tschur.line_search(s, dx, scales, *sig, 1e-6)
    assert bool(more) is bool(want_more) is (direction > 0)
    for f in s._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).stride() == getattr(want, f).stride(), f


def test_pcg_blocks_equal_early_exit():
    """The blocked PCG (host reads its stop flag every PCG_BLOCK iterations,
    a device mask freezes the carry) returns exactly what a loop that stops
    at the first failing test returns, for every stop reason."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(30, 30))
    H = torch.as_tensor(M @ M.T + 30 * np.eye(30), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=30), dtype=torch.float32)
    hv = lambda x: H @ x
    pre = lambda r: r / torch.diagonal(H)
    old = tsolver.PCG_BLOCK
    try:
        for max_iters, tol, step_tol in ((48, 1e-3, 1e-3), (13, 1e-12, 0.0),
                                         (256, 1e-6, 0.0)):
            tsolver.PCG_BLOCK = 1
            ref = tsolver.pcg(hv, b, pre, max_iters, tol, step_tol)
            tsolver.PCG_BLOCK = 8
            got = tsolver.pcg(hv, b, pre, max_iters, tol, step_tol)
            assert torch.equal(got, ref), (max_iters, tol, step_tol)
    finally:
        tsolver.PCG_BLOCK = old


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 1e-8])
def test_pcg_threshold_needs_no_host_tensor(tol):
    """pcg_threshold (tol squared in float32 as a Python number) equals the
    threshold it replaced, tol_t * tol_t * clamp(rz) with tol_t a tensor
    made from host data, bit for bit: over rz from 1e-38 to 1e30 and 0."""
    g = torch.Generator().manual_seed(0)
    rz = torch.cat([torch.zeros(1), 10.0 ** (torch.rand(20000, generator=g)
                                             * 68.0 - 38.0)])
    tol_t = torch.tensor(tol, dtype=rz.dtype)
    want = tol_t * tol_t * torch.clamp(rz, min=1e-30)
    for got in (tsolver.pcg_threshold(rz, tol),
                torch.stack([tsolver.pcg_threshold(v, tol) for v in rz[:64]])):
        assert torch.equal(got.view(torch.int32),
                           want[:got.shape[0]].view(torch.int32))


def test_tangent_helpers_match_jax():
    """tangent_zeros, tree_dot, tree_axpy and tree_scale on the same
    tangents as the JAX package's pytree helpers (f32, to 1e-5)."""
    from _torch_parity import small_configs
    from slide_slam_tpu.factorgraph import graph as jgraph
    from slide_slam_tpu_torch.factorgraph import graph as tgraph
    jcfg, tcfg = small_configs()
    jz = jsolver.tangent_zeros(jgraph.empty_state(jcfg))
    tz = tsolver.tangent_zeros(tgraph.empty_state(tcfg, device="cpu"))
    assert [tuple(x.shape) for x in tz] == [x.shape for x in jz]
    assert all(float(x.abs().sum()) == 0.0 for x in tz)
    rng = np.random.default_rng(8)
    a, b = ([rng.normal(size=x.shape).astype(np.float32) for x in jz]
            for _ in range(2))
    ta, tb = (tsolver.Tangent(*(torch.as_tensor(x) for x in v))
              for v in (a, b))
    ja, jb = (jsolver.Tangent(*(jnp.asarray(x) for x in v)) for v in (a, b))
    np.testing.assert_allclose(float(tsolver.tree_dot(ta, tb)),
                               float(jsolver.tree_dot(ja, jb)), rtol=1e-5)
    for got, want in zip(tsolver.tree_axpy(0.5, ta, tb),
                         jsolver.tree_axpy(0.5, ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for got, want in zip(tsolver.tree_scale(-2.0, ta),
                         jsolver.tree_scale(-2.0, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

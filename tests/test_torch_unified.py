"""The unified-variable solve of the port (factorgraph/solver.py `solve` and
its packed operators, engine.solve_full with SolverConfig.use_schur=False)
and the helper functions of ops/distances, ops/submap, frontend/cylinder_fit
and factorgraph/residuals, against the JAX package on the CPU. The engine's
keyframe steps on the unified solve: tests/test_torch_unified_steps.py.

Tolerances: the packed operators within 1e-4 of each array's largest
entry (the two packages sum in another order; the JAX operators run their
exact scatter path, plan=None); solved poses within 1e-3 m and 1e-3 rad and
costs within 1e-3 relative (f32 PCG over 24 keyframes amplifies the order
of the sums); integer and boolean outputs identical; the helpers within
1e-6 (elementwise f32 arithmetic) and 1e-5 for the plane fit's eigh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
from slide_slam_tpu.config import SlamConfig as JSlamConfig
from slide_slam_tpu.factorgraph import residuals as jres
from slide_slam_tpu.factorgraph import solver as jsolver
from slide_slam_tpu.factorgraph.graph import empty_state as jempty_state
from slide_slam_tpu.frontend import cylinder_fit as jcyl
from slide_slam_tpu.geometry import se3 as jse3
from slide_slam_tpu.objects import Cuboids as JCuboids
from slide_slam_tpu.ops import distances as jdist
from slide_slam_tpu.ops import submap as jsubmap
from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu_torch import convert
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.factorgraph import residuals as tres
from slide_slam_tpu_torch.factorgraph import solver as tsolver
from slide_slam_tpu_torch.frontend import cylinder_fit as tcyl
from slide_slam_tpu_torch.objects import Cuboids
from slide_slam_tpu_torch.ops import distances as tdist
from slide_slam_tpu_torch.ops import submap as tsubmap
from slide_slam_tpu_torch.runtime import engine as tengine

from _torch_parity import (jax_state_from_numpy, jax_state_numpy,
                           one_torch_thread, solver_fixture)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 1e-4
POS_TOL = 1e-3      # m
ROT_TOL = 1e-3      # rad (quaternion vector part)
COST_TOL = 1e-3     # relative

CAPACITY = dict(max_poses_per_robot=32, max_cylinders=128, max_cuboids=32,
                max_points=32, max_scan_objects=32, max_cylinder_factors=768,
                max_cuboid_factors=256, max_point_factors=256,
                max_between_factors=8)


def _configs(**solver_kw):
    kw = dict(number_of_robots=1, turn_off_intra_loop_closure=True)
    j = JSlamConfig(capacity=JCapacityConfig(**CAPACITY), **kw)
    t = SlamConfig(capacity=CapacityConfig(**CAPACITY), **kw)
    if solver_kw:
        import dataclasses
        j = j.replace(solver=dataclasses.replace(j.solver, **solver_kw))
        t = t.replace(solver=dataclasses.replace(t.solver, **solver_kw))
    return j, t


@pytest.fixture(scope="module")
def logged():
    jcfg, tcfg = _configs()
    state, log = solver_fixture(tcfg)
    return jcfg, tcfg, state, log


def _both(state):
    return (jax_state_from_numpy(state),
            convert.state_from_numpy(state, device="cpu"))


def _close(got, want, name, tol=REL_TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def _check_poses(got, want, n):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:n, 4:7], want[:n, 4:7], atol=POS_TOL,
                               rtol=0)
    sign = np.sign((got[:n, :4] * want[:n, :4]).sum(1, keepdims=True))
    np.testing.assert_allclose(sign * got[:n, 1:4], want[:n, 1:4],
                               atol=ROT_TOL, rtol=0)


@jax.jit
def _jax_packed(js, x, cyl_sigma, bearing_sigma):
    """The JAX package's packed operators on one state, in one program."""
    jp = jsolver.pack_linearization(
        js, jsolver.linearize(js, cyl_sigma, bearing_sigma))
    jd = jsolver.diagonal_packed(js, jp)
    jb = jsolver.block_diagonal_packed(js, jp)
    return (jp, jsolver.gradient_packed(js, jp), jd,
            jsolver.hessian_vec_packed(js, jp, x, 1e-4, jd), jb,
            jsolver._block_precond_inverse(jb, 1e-4),
            jsolver.x_to_tangent(js, x))


def test_packed_operators_match_jax(logged):
    jcfg, _, state, _ = logged
    js, ts = _both(state)
    sig = (jcfg.noise.cylinder, jcfg.noise.bearing)
    nv = sum(state[k].shape[0] for k in ("poses", "cyl_ray", "cub_pose",
                                         "pt_pos"))
    x = np.random.default_rng(1).normal(size=(nv, 9)).astype(np.float32)
    jp, jg, jd, jh, jb, jbi, jtan = _jax_packed(js, jnp.asarray(x), *sig)
    tp = tsolver.pack_linearization(ts, tsolver.linearize(ts, *sig))
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    _close(tp.r, jp.r, "r")
    _close(tp.J, jp.J, "J")
    _close(tsolver.gradient_packed(ts, tp), jg, "gradient")
    td = tsolver.diagonal_packed(ts, tp)
    _close(td, jd, "diagonal")
    _close(tsolver.hessian_vec_packed(ts, tp, torch.as_tensor(x), 1e-4, td),
           jh, "hessian_vec")
    tb = tsolver.block_diagonal_packed(ts, tp)
    _close(tb, jb, "block_diagonal")
    _close(tsolver._block_precond_inverse(tb, 1e-4), jbi, "block inverse",
           1e-3)
    for got, want in zip(tsolver.x_to_tangent(ts, torch.as_tensor(x)), jtan):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block_precond,budget", [
    (False, "full"), (True, "full")])
def test_unified_solve_matches_jax(logged, block_precond, budget):
    """engine's unified path (use_schur=False) on both packages; the
    incremental budget runs in tests/test_torch_unified_steps.py."""
    jcfg, tcfg, state, _ = logged
    jcfg, tcfg = _configs(use_schur=False, use_block_jacobi=block_precond)
    js, ts = _both(state)
    if budget == "full":
        want = jengine.solve_full(jcfg, js)
        got = tengine.solve_full(tcfg, ts)
    else:
        want = jengine.solve_incremental(jcfg, js)
        got = tengine.solve_incremental(tcfg, ts)
    n = int(state["pose_count"][0])
    assert np.abs(got.poses.numpy()[:n] - state["poses"][:n]).max() > 1e-3
    _check_poses(got.poses.numpy(), want.poses, n)
    sig = (jcfg.noise.cylinder, jcfg.noise.bearing)
    c_j = float(jsolver.cost(want, *sig))
    c_t = float(tsolver.cost(got, *sig))
    assert abs(c_t - c_j) <= COST_TOL * c_j, (c_t, c_j)
    assert c_t < float(tsolver.cost(ts, *sig))


# ---- tests/test_factors.py:93,106,148 on both packages -------------------
def _small_cfgs():
    cap = dict(max_poses_per_robot=32, max_cylinders=32, max_cuboids=32,
               max_points=32, max_cylinder_factors=128,
               max_cuboid_factors=128, max_point_factors=128,
               max_between_factors=16)
    return (JSlamConfig(number_of_robots=2, capacity=JCapacityConfig(**cap)),
            SlamConfig(number_of_robots=2, capacity=CapacityConfig(**cap)))


def _chain(truth, noise_rng=None, sigma=0.0):
    """tests/test_factors.py's _build_odometry_chain: robot 0's chain at
    the true poses with (optionally noisy) odometry, as a numpy state."""
    jcfg, _ = _small_cfgs()
    s = jempty_state(jcfg)
    n = len(truth)
    poses = np.asarray(truth, np.float32)
    s = s._replace(
        poses=s.poses.at[0:n].set(jnp.asarray(poses)),
        pose_count=s.pose_count.at[0].set(n),
        prior_pose=s.prior_pose.at[0].set(jnp.asarray(poses[0])),
        prior_valid=s.prior_valid.at[0].set(True),
        keypose_xyz=s.keypose_xyz.at[0:n].set(jnp.asarray(poses[:, 4:7])))
    rels = []
    for i in range(1, n):
        rel = jse3.between(jnp.asarray(poses[i - 1]), jnp.asarray(poses[i]))
        if noise_rng is not None and sigma > 0:
            rel = jse3.retract(rel, jnp.asarray(
                noise_rng.normal(size=6).astype(np.float32) * sigma))
        rels.append(rel)
    if rels:
        s = s._replace(odom_rel=s.odom_rel.at[1:n].set(jnp.stack(rels)),
                       odom_sigma=s.odom_sigma.at[1:n].set(0.1))
    return s


_jsolve = jax.jit(jsolver.solve, static_argnames=("cyl_sigma",
                                                  "bearing_sigma"))


def _solve_both(s, outer_iters, pcg_iters):
    """JAX solver.solve and the port's on the same state (numpy dicts);
    one JAX program serves every budget."""
    kw = dict(cyl_sigma=400.0, bearing_sigma=1.0)
    want = _jsolve(s, outer_iters=jnp.int32(outer_iters),
                   pcg_iters=jnp.int32(pcg_iters), **kw)
    got = tsolver.solve(convert.state_from_numpy(jax_state_numpy(s), "cpu"),
                        outer_iters=outer_iters, pcg_iters=pcg_iters, **kw)
    return convert.state_to_numpy(got), jax_state_numpy(want)


def _truth_line(n, yaw_step):
    return [np.asarray(jse3.from_xyz_yaw(float(i), 0.0, 0.0, yaw_step * i))
            for i in range(n)]


def test_solver_noiseless_chain_stays_put():
    truth = _truth_line(8, 0.1)
    got, want = _solve_both(_chain(truth), outer_iters=2, pcg_iters=64)
    np.testing.assert_allclose(got["poses"][:8], np.stack(truth), atol=1e-4)
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-5)


def test_solver_loop_closure_corrects_drift():
    n = 17
    truth, pos, yaw = [], np.zeros(3), 0.0
    truth.append(np.asarray(jse3.from_xyz_yaw(*pos, yaw)))
    for k in range(n - 1):
        if k in (3, 7, 11):
            yaw += np.pi / 2
        pos = pos + np.array([np.cos(yaw), np.sin(yaw), 0.0])
        truth.append(np.asarray(jse3.from_xyz_yaw(*pos, yaw)))
    s = _chain(truth, noise_rng=np.random.default_rng(7), sigma=0.03)
    rel = jse3.between(jnp.asarray(truth[0]), jnp.asarray(truth[-1]))
    s = s._replace(bf_i=s.bf_i.at[0].set(0), bf_j=s.bf_j.at[0].set(n - 1),
                   bf_rel=s.bf_rel.at[0].set(rel),
                   bf_sigma=s.bf_sigma.at[0].set(0.001),
                   bf_count=jnp.int32(1))
    drifted = [jnp.asarray(truth[0])]
    for i in range(1, n):
        drifted.append(jse3.compose(drifted[-1], s.odom_rel[i]))
    s = s._replace(poses=s.poses.at[0:n].set(jnp.stack(drifted)))
    before = float(np.linalg.norm(np.asarray(drifted[-1])[4:7]
                                  - truth[-1][4:7]))
    got, want = _solve_both(s, outer_iters=6, pcg_iters=128)
    after = float(np.linalg.norm(got["poses"][n - 1, 4:7] - truth[-1][4:7]))
    assert after < 0.05 and after < 0.5 * before, (before, after)
    _check_poses(got["poses"], want["poses"], n)


def test_solver_cylinder_landmark_refinement():
    n = 5
    truth = _truth_line(n, 0.0)
    s = _chain(truth)
    lm_true = np.array([0.0, 0.0, 1.0, 2.0, 3.0, 0.0, 0.3], np.float32)
    meas = np.stack([tres.cylinder_to_local(
        torch.tensor(lm_true), torch.tensor(truth[i])).numpy()
        for i in range(n)])
    s = s._replace(
        cf_pose=s.cf_pose.at[:n].set(jnp.arange(n, dtype=jnp.int32)),
        cf_lm=s.cf_lm.at[:n].set(0), cf_meas=s.cf_meas.at[:n].set(meas),
        cf_count=jnp.int32(n),
        cyl_ray=s.cyl_ray.at[0].set(lm_true[0:3] + np.array([0.05, 0, 0])),
        cyl_root=s.cyl_root.at[0].set(lm_true[3:6]
                                      + np.array([0.4, -0.3, 0.2])),
        cyl_radius=s.cyl_radius.at[0].set(lm_true[6] + 0.1),
        cyl_count=jnp.int32(1))
    got, want = _solve_both(s, outer_iters=6, pcg_iters=64)
    np.testing.assert_allclose(got["cyl_root"][0], lm_true[3:6], atol=1e-2)
    np.testing.assert_allclose(got["cyl_radius"][0], 0.3, atol=1e-2)
    np.testing.assert_allclose(got["cyl_root"][0], want["cyl_root"][0],
                               atol=1e-4)


# ---- the four helpers of ROADMAP §2 item 6 -------------------------------
def _boxes(pkg_cuboids, centers, scales, labels, valid=None, to=np.asarray):
    n = len(centers)
    pose = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32), (n, 1))
    pose[:, 4:7] = np.asarray(centers, np.float32)
    v = np.ones(n, bool) if valid is None else np.asarray(valid)
    return pkg_cuboids(pose=to(pose), scale=to(np.asarray(scales, np.float32)),
                       label=to(np.asarray(labels, np.int32)), valid=to(v))


@pytest.mark.parametrize("dim_weight", [0.5, 0.25])
def test_cuboid_distances_match_jax(dim_weight):
    """tests/test_distances.py:20-48 on random boxes, both packages."""
    rng = np.random.default_rng(2)
    args = []
    for n in (7, 9):
        args.append((rng.uniform(-3, 3, (n, 3)), rng.uniform(0.5, 3, (n, 3)),
                     rng.integers(5, 7, n), rng.uniform(size=n) > 0.2))
    ja = [_boxes(JCuboids, *a, to=jnp.asarray) for a in args]
    ta = [_boxes(Cuboids, *a, to=torch.as_tensor) for a in args]
    np.testing.assert_allclose(
        tdist.cuboid_weighted_pairwise(*ta, dim_weight=dim_weight).numpy(),
        np.asarray(jdist.cuboid_weighted_pairwise(*ja, dim_weight=dim_weight)),
        atol=1e-6)
    np.testing.assert_allclose(tdist.cuboid_iou_pairwise(*ta).numpy(),
                               np.asarray(jdist.cuboid_iou_pairwise(*ja)),
                               atol=1e-6)
    half = [_boxes(Cuboids, [c], [[2, 2, 2]], [5], to=torch.as_tensor)
            for c in ([0, 0, 0], [1, 0, 0])]
    assert abs(float(tdist.cuboid_iou_pairwise(*half)[0, 0]) - 4 / 12) < 1e-6


def test_fit_plane_lsq_matches_jax():
    """tests/test_frontend.py:156: a noisy plane with outliers."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-5, 5, (200, 2))
    z = 0.1 * xy[:, 0] + 0.5 + rng.normal(0, 0.01, 200)
    pts = np.column_stack([xy, z]).astype(np.float32)
    pts[:10, 2] += 3.0
    mask = np.ones((2, 200), bool)
    mask[1, 100:] = False
    both = np.stack([pts, pts])
    n_t, d_t = tcyl.fit_plane_lsq(torch.as_tensor(both), torch.as_tensor(mask))
    n_j, d_j = jcyl.fit_plane_lsq(jnp.asarray(both), jnp.asarray(mask))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    assert abs(float(n_t[0] @ torch.tensor([0, 0, 0.5])) + float(d_t[0])) < 0.05
    assert float(n_t[0, 2]) > 0.9


def test_cylinder_to_local_and_radius_mask_match_jax():
    """tests/test_factors.py:42 (zero residual at truth) and
    ops/submap.radius_mask, both packages."""
    pose = np.asarray(jse3.from_xyz_yaw(1.0, 2.0, 0.0, 0.3))
    lm = np.array([0.0, 0.1, 1.0, 5.0, 6.0, 0.0, 0.4], np.float32)
    meas = tres.cylinder_to_local(torch.tensor(lm), torch.tensor(pose))
    np.testing.assert_allclose(
        meas.numpy(), np.asarray(jres.cylinder_to_local(jnp.asarray(lm),
                                                        jnp.asarray(pose))),
        atol=1e-6)
    r = tres.cylinder_residual(torch.as_tensor(pose), torch.as_tensor(lm),
                               meas)
    np.testing.assert_allclose(r.numpy(), 0, atol=1e-5)
    rng = np.random.default_rng(4)
    cen = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    valid = rng.uniform(size=64) > 0.1
    q = np.array([1.0, -2.0, 0.5], np.float32)
    for z_gate in (None, 1.5):
        got = tsubmap.radius_mask(torch.as_tensor(cen), torch.as_tensor(valid),
                                  torch.as_tensor(q), 6.0, z_gate)
        want = jsubmap.radius_mask(jnp.asarray(cen), jnp.asarray(valid),
                                   jnp.asarray(q), 6.0, z_gate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not got.all()

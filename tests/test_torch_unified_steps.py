"""The engine's keyframe steps on the port's unified-variable solve
(engine.keyframe_step / keyframe_step_packed, SlamNode with
SolverConfig.use_schur=False) against the JAX package on the CPU, and the
port's Schur solve against its unified one (tests/test_schur.py:67).

Tolerances: integer outputs and the states of steps without a solve
identical (the same arithmetic in the same order); poses within 1e-3 m
and 1e-3 rad after solves (f32 PCG sums in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
from slide_slam_tpu.config import SlamConfig as JSlamConfig
from slide_slam_tpu.factorgraph.graph import empty_state as jempty_state
from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu.runtime.node import SlamNode as JSlamNode
from slide_slam_tpu_torch import convert
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.factorgraph import schur as tschur
from slide_slam_tpu_torch.factorgraph import solver as tsolver
from slide_slam_tpu_torch.factorgraph.graph import empty_state, noise_arrays
from slide_slam_tpu_torch.runtime import engine as tengine
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import (jax_state_numpy, one_torch_thread,  # noqa: F401
                           solver_fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POS_TOL = 1e-3      # m
ROT_TOL = 1e-3      # rad (quaternion vector part)


@pytest.fixture(scope="module")
def logged():
    from test_torch_unified import _configs
    jcfg, tcfg = _configs()
    state, log = solver_fixture(tcfg)
    return jcfg, tcfg, state, log


def _check_poses(got, want, n):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:n, 4:7], want[:n, 4:7], atol=POS_TOL,
                               rtol=0)
    sign = np.sign((got[:n, :4] * want[:n, :4]).sum(1, keepdims=True))
    np.testing.assert_allclose(sign * got[:n, 1:4], want[:n, 1:4],
                               atol=ROT_TOL, rtol=0)


def test_schur_matches_unified_converged(logged):
    """tests/test_schur.py:67 on the port: from the same perturbed start,
    both solvers reach the same optimum with a thorough budget."""
    jcfg, _, state, _ = logged
    ts = convert.state_from_numpy(state, device="cpu")
    kw = dict(cyl_sigma=jcfg.noise.cylinder, bearing_sigma=jcfg.noise.bearing,
              outer_iters=16, pcg_iters=256, pcg_tol=1e-8)
    a = tsolver.solve(ts, **kw)
    b = tschur.solve(ts, **kw)
    sig = (jcfg.noise.cylinder, jcfg.noise.bearing)
    ca, cb = float(tsolver.cost(a, *sig)), float(tsolver.cost(b, *sig))
    c0 = float(tsolver.cost(ts, *sig))
    assert cb < 0.01 * c0
    assert cb < ca * 1.05 + 1e-6
    n = int(state["pose_count"][0])
    gap = np.linalg.norm(a.poses.numpy()[:n, 4:7] - b.poses.numpy()[:n, 4:7],
                         axis=1)
    assert float(np.sqrt(np.mean(gap ** 2))) < 0.05


# ---- keyframe_step_packed sequentially against replay_batch --------------
def _tiny_cfgs():
    cap = dict(max_poses_per_robot=32, max_cylinders=64, max_cuboids=32,
               max_points=16, max_scan_objects=8, max_cylinder_factors=256,
               max_cuboid_factors=128, max_point_factors=64,
               max_between_factors=8)
    return (JSlamConfig(number_of_robots=2, capacity=JCapacityConfig(**cap)),
            SlamConfig(number_of_robots=2, capacity=CapacityConfig(**cap)))


def _replay_inputs(n, S, seed=3):
    """tests/test_replay_batch.py's random packed scans and chain."""
    rng = np.random.default_rng(seed)
    par = np.zeros((n, 2, 7), np.float32)
    par[:, :, 0] = 1.0
    par[:, 0, 4] = np.cumsum(rng.normal(1.0, 0.1, n))
    par[:, 1, 4] = 1.0
    out = np.zeros((n, S, 33), np.float32)
    out[:, :, 12] = 1.0
    out[:, :, 24] = 1.0
    out[:, :4, 0:3] = rng.normal(0, 5.0, (n, 4, 3))
    out[:, :4, 3:6] = [0.0, 0.0, 1.0]
    out[:, :4, 6] = np.abs(rng.normal(0.3, 0.05, (n, 4)))
    out[:, :4, 7] = 8
    out[:, :4, 8] = 1.0
    return par, out


def test_keyframe_step_packed_matches_replay_batch_and_jax():
    """tests/test_replay_batch.py:59: keyframe_step_packed once per keyframe
    equals the port's replay_batch (but for the gauge anchor, which replay
    does not set) and JAX's keyframe_step_packed, bit for bit."""
    jcfg, tcfg = _tiny_cfgs()
    n, S = 11, tcfg.capacity.max_scan_objects
    par, packed = _replay_inputs(n, S)
    odom_n, cube_n = (torch.as_tensor(noise_arrays(tcfg)[k])
                      for k in ("odom", "cube"))
    j_odom = jnp.asarray(np.asarray(jcfg.noise.odom, np.float32))
    j_cube = jnp.asarray(np.asarray(jcfg.noise.cube, np.float32))
    seq = empty_state(tcfg, device="cpu")
    jseq = jempty_state(jcfg)
    for i in range(n):
        seq, out = tengine.keyframe_step_packed(
            tcfg, seq, 1, torch.as_tensor(par[i]), torch.as_tensor(packed[i]),
            (False, False), odom_n, cube_n, enable_solve=False)
        jseq, jout = jengine.keyframe_step_packed(
            jcfg, jseq, jnp.int32(1), jnp.asarray(par[i]),
            jnp.asarray(packed[i]), jnp.asarray(np.array([False, False])),
            j_odom, j_cube, enable_solve=False)
        np.testing.assert_array_equal(out.cyl_matches.numpy(),
                                      np.asarray(jout.cyl_matches))
    bat = tengine.replay_batch(tcfg, empty_state(tcfg, device="cpu"), 1,
                               torch.as_tensor(par), torch.as_tensor(packed),
                               odom_n, cube_n)
    want = jax_state_numpy(jseq)
    for name in seq._fields:
        a = getattr(seq, name).numpy()
        np.testing.assert_array_equal(a, want[name], err_msg=name)
        if name not in ("prior_pose", "prior_valid"):
            np.testing.assert_array_equal(a, getattr(bat, name).numpy(),
                                          err_msg=name)
    assert not bool(bat.prior_valid[1]) and int(bat.pose_count[1]) == n


def test_keyframe_step_with_solve_matches_jax():
    """keyframe_step with do_solve on a unified-solver config: each step's
    pose and match indices against the JAX keyframe_step."""
    jcfg, tcfg = _tiny_cfgs()
    jcfg = jcfg.replace(solver=dataclasses.replace(jcfg.solver,
                                                   use_schur=False))
    tcfg = tcfg.replace(solver=dataclasses.replace(tcfg.solver,
                                                   use_schur=False))
    n, S = 6, tcfg.capacity.max_scan_objects
    par, packed = _replay_inputs(n, S, seed=5)
    odom_n, cube_n = (torch.as_tensor(noise_arrays(tcfg)[k])
                      for k in ("odom", "cube"))
    j_odom = jnp.asarray(np.asarray(jcfg.noise.odom, np.float32))
    j_cube = jnp.asarray(np.asarray(jcfg.noise.cube, np.float32))
    s, js = empty_state(tcfg, device="cpu"), jempty_state(jcfg)
    for i in range(n):
        s, out = tengine.keyframe_step_packed(
            tcfg, s, 0, torch.as_tensor(par[i]), torch.as_tensor(packed[i]),
            (False, True), odom_n, cube_n)
        js, jout = jengine.keyframe_step_packed(
            jcfg, js, jnp.int32(0), jnp.asarray(par[i]),
            jnp.asarray(packed[i]), jnp.asarray(np.array([False, True])),
            j_odom, j_cube)
        np.testing.assert_array_equal(out.cyl_matches.numpy(),
                                      np.asarray(jout.cyl_matches))
        np.testing.assert_allclose(out.pose.numpy(), np.asarray(jout.pose),
                                   atol=POS_TOL)


def test_slam_node_unified_matches_jax(logged):
    """The slice as a whole: 12 keyframes through SlamNode with
    use_schur=False in both packages (incremental solves every keyframe):
    match counts identical, trajectories within 1e-3 m."""
    _, _, _, log = logged
    from test_torch_unified import _configs
    jcfg, tcfg = _configs(use_schur=False)
    node = SlamNode(tcfg, robot_id=0, device="cpu")
    jnode = JSlamNode(jcfg, robot_id=0)
    for kf in log.keyframes[:12]:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        jnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    assert node.landmark_counts() == jnode.landmark_counts()
    _check_poses(node.optimized_trajectory(), jnode.optimized_trajectory(),
                 12)



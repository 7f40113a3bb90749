"""The port's f64 oracle (slide_slam_tpu_torch/factorgraph/reference_solver.py)
against the JAX package's, and tests/test_solver_vs_reference.py mirrored on
the port: the port's engine (SlamNode on the CPU) over that test's world and
config, judged by the port's oracle with that test's bounds.

Parity: one GraphState (the port's keyframe-60 state with the kf 5 <-> 55
closure appended, every factor family present) through both oracles gives
equal Problem fields (exactly), residual vectors within 1e-12 and solved
poses within 1e-9 m with equal iteration counts. A state on the CPU as
tensors, as a dict of arrays and as a GraphState of arrays extracts the
same problem.

The mirror of test_slam_beats_dead_reckoning fails as the reference's does
(ROADMAP §4, reference-side): the engine beats odometry, but ends more than
2 cm of ATE above the converged optimum of its own factors.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slide_slam_tpu.factorgraph import reference_solver as jrs
from slide_slam_tpu_torch import config, convert
from slide_slam_tpu_torch.factorgraph import reference_solver as rs
from slide_slam_tpu_torch.factorgraph.graph import GraphState
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime import engine
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg():
    # tests/test_solver_vs_reference.py:22-33
    return config.SlamConfig(
        number_of_robots=1,
        capacity=config.CapacityConfig(
            max_poses_per_robot=128, max_cylinders=256, max_cuboids=64,
            max_points=64, max_scan_objects=32, max_cylinder_factors=2048,
            max_cuboid_factors=512, max_point_factors=1024,
            max_between_factors=16))


class Run:
    """The port's engine over the reference test's log (:36-56), with host
    copies at keyframes 20, 40 and 60 and each oracle solve kept once."""

    def __init__(self):
        self.cfg = _cfg()
        rng = np.random.default_rng(0)
        world = synthetic.make_forest_world(rng, n_trees=60, n_poles=10,
                                            n_cars=8, extent=30.0)
        self.traj = synthetic.lawnmower_trajectory(60, extent=25.0, rows=3,
                                                   step=1.5)
        self.log = synthetic.make_log(world, self.traj,
                                      odom_drift_sigma=0.01, pos_noise=0.03,
                                      dropout=0.1)
        self.node = SlamNode(self.cfg, robot_id=0, device="cpu")
        self.snaps = {}
        for i, kf in enumerate(self.log.keyframes):
            self.node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
            if i + 1 in (20, 40, 60):
                self.snaps[i + 1] = convert.state_to_numpy(self.node.state)
        assert sum(self.node.overflow_report().values()) == 0
        self._solved = {}

    def ref_solve(self, key, state, **kw):
        k = (key, tuple(sorted(kw.items())))
        if k not in self._solved:
            self._solved[k] = rs.solve_reference(
                state, cyl_sigma=self.cfg.noise.cylinder,
                bearing_sigma=self.cfg.noise.bearing, **kw)
        return self._solved[k]

    def closed(self):
        """The keyframe-60 state with a tight ground-truth kf 5 <-> 55
        between factor appended (:118-140)."""
        rel = se3np.between(self.traj[5], self.traj[55])
        return engine.add_between_factor(
            self.cfg, convert.state_from_numpy(self.snaps[60], device="cpu"),
            5, 55, torch.as_tensor(rel),
            torch.full((6,), 0.01, dtype=torch.float32))


@pytest.fixture(scope="module")
def run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield Run()
    finally:
        torch.set_num_threads(n)


def test_oracles_agree_with_jax(run):
    """The same state through both oracles: Problem fields equal, residuals
    within 1e-12, LM's poses within 1e-9 m after the same iterations."""
    cfg = run.cfg
    host = convert.state_to_numpy(run.closed())
    assert host["bf_count"] == 1 and min(
        int(host[k]) for k in ("cf_count", "kf_count", "uf_count")) > 0
    jstate = SimpleNamespace(**host)
    sig = (cfg.noise.cylinder, cfg.noise.bearing)
    for odo in (False, True):
        a = rs.extract_problem(host, *sig, from_odometry=odo)
        b = jrs.extract_problem(jstate, *sig, from_odometry=odo)
        for f in dataclasses.fields(jrs.Problem):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        np.testing.assert_allclose(rs.residual_vector(a),
                                   jrs.residual_vector(b), rtol=0,
                                   atol=1e-12)
        assert rs.cost(a) == pytest.approx(jrs.cost(b), rel=1e-12)
    p, info = rs.solve_reference(host, cyl_sigma=sig[0],
                                 bearing_sigma=sig[1])
    q, jinfo = jrs.solve_reference(jstate, cyl_sigma=sig[0],
                                   bearing_sigma=sig[1])
    assert info["iters"] == jinfo["iters"] and info["iters"] > 1
    np.testing.assert_allclose(p, q, rtol=0, atol=1e-9)
    assert info["final_cost"] == pytest.approx(jinfo["final_cost"],
                                               rel=1e-12)
    assert info["final_cost"] < info["initial_cost"]


def test_state_forms_extract_the_same_problem(run):
    """Tensors, a dict of arrays and a GraphState of arrays: one problem;
    the poses come back in the state's slot layout, as f64."""
    cfg = run.cfg
    tensors = run.closed()
    host = convert.state_to_numpy(tensors)
    forms = (tensors, host,
             GraphState(**{k: host[k] for k in GraphState._fields}))
    probs = [rs.extract_problem(s, cfg.noise.cylinder, cfg.noise.bearing)
             for s in forms]
    for f in dataclasses.fields(rs.Problem):
        for p in probs[1:]:
            np.testing.assert_array_equal(getattr(p, f.name),
                                          getattr(probs[0], f.name))
    assert probs[0].poses.dtype == np.float64
    n = int(host["pose_count"][0])
    np.testing.assert_array_equal(probs[0].pose_slot, np.arange(n))
    assert rs.host_state(tensors).poses.shape == host["poses"].shape


def test_converged_optimum_independent_of_init(run):
    """The oracle's optimum from the port engine's estimate and from dead
    reckoning: max 1e-4 m apart, cost equal to 1e-6 relative, and LM
    descended from the odometry start (:63-77)."""
    state = run.snaps[60]
    p_engine, info1 = run.ref_solve(60, state)
    p_odom, info2 = run.ref_solve(60, state, from_odometry=True)
    n = int(state["pose_count"][0])
    gap = np.linalg.norm(p_engine[:n, 4:7] - p_odom[:n, 4:7], axis=1)
    assert gap.max() < 1e-4
    assert info2["final_cost"] == pytest.approx(info1["final_cost"], rel=1e-6)
    assert info2["initial_cost"] > 5 * info2["final_cost"]


def test_incremental_tracks_converged_per_keyframe(run):
    """At keyframes 20, 40 and 60 the port's warm-started estimate stays
    within 8 cm RMS and 15 cm max of the optimum of its own factors
    (:80-98)."""
    for n_kf, state in run.snaps.items():
        n = int(state["pose_count"][0])
        est = state["poses"][:n]
        conv, _ = run.ref_solve(n_kf, state)
        gap = np.linalg.norm(conv[:n, 4:7] - est[:, 4:7], axis=1)
        ate_gap = float(np.sqrt(np.mean(gap ** 2)))
        assert ate_gap < 0.08, f"kf {n_kf}: ATE gap {ate_gap:.4f} m"
        assert gap.max() < 0.15, f"kf {n_kf}: max gap {gap.max():.4f} m"


def test_slam_beats_dead_reckoning(run):
    """The reference test's anchors (:101-115): SLAM beats odometry, and the
    converged optimum is not meaningfully better than the engine. Fails on
    the reference as here (ROADMAP §4)."""
    n = len(run.node.optimized_trajectory())
    truth = run.traj[:n, 4:7]
    est = run.node.optimized_trajectory()[:, 4:7]
    odom = np.stack([kf.odom_pose for kf in run.log.keyframes[:n]])[:, 4:7]
    ate_slam = synthetic.ate_rmse(est, truth, align=False)
    ate_odom = synthetic.ate_rmse(odom, truth, align=False)
    conv, _ = run.ref_solve(60, run.snaps[60])
    ate_conv = synthetic.ate_rmse(conv[:n, 4:7], truth, align=False)
    assert ate_slam < ate_odom
    assert ate_slam < ate_conv + 0.02


def test_tracks_converged_with_loop_closure(run):
    """With the kf 5 <-> 55 closure, the port's solve_full (Schur and
    unified) stays within 5 cm RMS of the oracle on the same graph
    (:118-140)."""
    closed = run.closed()
    n = int(closed.pose_count[0])
    for schur in (True, False):
        cfg = run.cfg.replace(solver=dataclasses.replace(
            run.cfg.solver, use_schur=schur))
        solved = engine.solve_full(cfg, closed)
        est = solved.poses[:n].numpy()
        conv, _ = run.ref_solve(("closed", schur), solved)
        gap = np.linalg.norm(conv[:n, 4:7] - est[:, 4:7], axis=1)
        ate_gap = float(np.sqrt(np.mean(gap ** 2)))
        assert ate_gap < 0.05, f"schur={schur}: post-closure gap {ate_gap}"

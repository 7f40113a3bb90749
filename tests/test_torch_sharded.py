"""The port's sharded solves (parallel/distributed_ba.py, factor-sharded
unified solve; parallel/landmark_sharded.py, landmark-sharded Schur solve)
against the local solve and against the JAX package's on the 4-device CPU
mesh of tests/conftest.py: the cases of tests/test_distributed_ba.py and
tests/test_landmark_sharded.py, plus a two-process gloo run (slow).

Protocol (the JAX tests'): pre-converge with the local solve, then compare
the sharded and local solves at the optimum, where identical math must stay
put. Tolerances: shard counts and layouts exact; sharded vs local poses
within 1e-2 m and well-observed (>= 8 hits) cylinder roots within 2e-2 m
(the JAX tests' bounds: both are budgeted f32 solvers that sum in another
order, and a weakly observed root moves below the solvers' stopping
tolerance); the port's sharded poses within 1e-2 m of the JAX package's;
the two-process run equal to the in-process one within 1e-5 m.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from slide_slam_tpu.config import CapacityConfig as JCapacityConfig
from slide_slam_tpu.config import SlamConfig as JSlamConfig
from slide_slam_tpu.parallel import distributed_ba as jdba
from slide_slam_tpu.parallel import landmark_sharded as jls
from slide_slam_tpu_torch import convert
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.factorgraph import schur, solver
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.parallel import distributed_ba as dba
from slide_slam_tpu_torch.parallel import landmark_sharded as ls
from slide_slam_tpu_torch.runtime import engine
from slide_slam_tpu_torch.runtime.node import SlamNode

from _torch_parity import jax_state_from_numpy, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = 1e-2
ROOT_TOL = 2e-2

CAP = dict(max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
           max_points=64, max_scan_objects=32, max_cylinder_factors=1024,
           max_cuboid_factors=512, max_point_factors=512,
           max_between_factors=32)


def cfgs():
    return (JSlamConfig(number_of_robots=2, capacity=JCapacityConfig(**CAP)),
            SlamConfig(number_of_robots=2, capacity=CapacityConfig(**CAP)))


def populated(tcfg):
    """The JAX tests' populated state (25 keyframes, drift 0.02) through the
    port's node on the CPU, as numpy."""
    rng = np.random.default_rng(0)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=6, n_cars=6,
                                        extent=20.0)
    traj = synthetic.lawnmower_trajectory(25, extent=16.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.02, seed=1)
    node = SlamNode(tcfg, robot_id=0, device="cpu")
    for kf in log.keyframes:
        node.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    return convert.state_to_numpy(node.state)


@pytest.fixture(scope="module")
def state():
    return populated(cfgs()[1])


def _t(d):
    return convert.state_from_numpy(d, device="cpu")


def _close_at_optimum(got, want, hits):
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=POSE_TOL)
    well = hits >= 8
    assert well.sum() >= 20
    np.testing.assert_allclose(got.cyl_root.numpy()[well],
                               np.asarray(want.cyl_root)[well], atol=ROOT_TOL)


def test_factor_shard_roundtrip(state):
    t = _t(state)
    stacked = dba.shard_state(t, 4)
    assert int(stacked.cf_count.sum()) == int(t.cf_count)
    assert int(stacked.kf_count.sum()) == int(t.kf_count)
    np.testing.assert_array_equal(stacked.poses[0].numpy(),
                                  stacked.poses[3].numpy())
    want = jdba.shard_state(jax_state_from_numpy(state), 4)
    for f, a in zip(stacked._fields, stacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_distributed_matches_local_and_jax(state):
    """4 factor shards in lockstep in this process against the local
    unified solve, and against the JAX package's 4-device solve."""
    jcfg, tcfg = cfgs()
    jcfg = jcfg.replace(solver=jcfg.solver.__class__(use_schur=False))
    tcfg = tcfg.replace(solver=tcfg.solver.__class__(use_schur=False))
    conv = engine.solve_full(tcfg, _t(state))
    local = engine.solve_full(tcfg, conv)
    dist = dba.distributed_solve(conv, tcfg, n_shards=4)
    _close_at_optimum(dist, local, state["cyl_hits"])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("shard",))
    jdist = jdba.distributed_solve(
        jax_state_from_numpy(convert.state_to_numpy(conv)), jcfg, mesh)
    np.testing.assert_allclose(dist.poses.numpy(), np.asarray(jdist.poses),
                               atol=POSE_TOL)
    # the factor arrays are the original ones
    np.testing.assert_array_equal(dist.cf_lm.numpy(), state["cf_lm"])


def test_landmark_shard_roundtrip(state):
    t = _t(state)
    stacked = ls.shard_state_by_landmark(t, 4)
    assert int(stacked.cyl_count.sum()) == int(t.cyl_count)
    assert int(stacked.cf_count.sum()) == int(t.cf_count)
    shard_cap = stacked.cyl_ray.shape[1]
    for shard in range(4):
        k = int(stacked.cf_count[shard])
        assert (stacked.cf_lm[shard, :k] < shard_cap).all()
    restored = ls.unshard_state_by_landmark(stacked, t)
    np.testing.assert_array_equal(restored.cyl_root.numpy(),
                                  state["cyl_root"])
    np.testing.assert_array_equal(restored.poses.numpy(), state["poses"])
    want = jls.shard_state_by_landmark(jax_state_from_numpy(state), 4)
    for f, a in zip(stacked._fields, stacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_landmark_sharded_matches_local_and_jax(state):
    jcfg, tcfg = cfgs()
    kw = dict(cyl_sigma=tcfg.noise.cylinder, bearing_sigma=tcfg.noise.bearing,
              outer_iters=tcfg.solver.max_outer_iterations,
              pcg_iters=tcfg.solver.pcg_max_iterations,
              pcg_tol=tcfg.solver.pcg_tol)
    conv = schur.solve(_t(state), **kw)
    local = schur.solve(conv, **kw)
    shard = ls.landmark_sharded_solve(conv, tcfg, n_shards=4)
    _close_at_optimum(shard, local, state["cyl_hits"])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("lm",))
    jshard = jls.landmark_sharded_solve(
        jax_state_from_numpy(convert.state_to_numpy(conv)), jcfg, mesh)
    np.testing.assert_allclose(shard.poses.numpy(), np.asarray(jshard.poses),
                               atol=POSE_TOL)
    np.testing.assert_array_equal(shard.cyl_count.numpy(), state["cyl_count"])


@pytest.mark.parametrize("kind", ["factor", "landmark"])
def test_sharded_solve_from_logged_state_equals_local(state, kind):
    """From the logged (unconverged) state, where the solves move, the
    sharded solve lands where the local one does: poses within 1e-3 m and
    the cost within 1e-4 relative (the CPU sums in a fixed order; the
    shards' partial sums round differently). A chain counted other than
    once (sigma not inflated by sqrt(n)) moves them apart."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(solver=tcfg.solver.__class__(
        use_schur=kind == "landmark"))
    fn = (dba.distributed_solve if kind == "factor"
          else ls.landmark_sharded_solve)
    local = engine.solve_full(tcfg, _t(state))
    sharded = fn(_t(state), tcfg, n_shards=4)
    assert np.abs(local.poses.numpy() - state["poses"]).max() > 1e-3
    np.testing.assert_allclose(sharded.poses.numpy(), local.poses.numpy(),
                               atol=1e-3, rtol=0)
    sig = (tcfg.noise.cylinder, tcfg.noise.bearing)
    c_local = float(solver.cost(local, *sig))
    assert abs(float(solver.cost(sharded, *sig)) - c_local) <= 1e-4 * c_local


WORKER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from slide_slam_tpu_torch import convert
from slide_slam_tpu_torch.config import CapacityConfig, SlamConfig
from slide_slam_tpu_torch.parallel import distributed_ba as dba
from slide_slam_tpu_torch.parallel import landmark_sharded as ls
from slide_slam_tpu_torch.parallel import multiprocess as mp

dist = mp.initialize(mp.ProcessSpec({init!r}, world_size=2, rank={rank},
                                    device="cpu"))
cfg = SlamConfig(number_of_robots=2, capacity=CapacityConfig(**{cap!r}))
with np.load({path!r}) as z:
    state = convert.state_from_numpy(dict(z), device="cpu")
a = dba.distributed_solve(state, cfg, group=dist.group.WORLD)
b = ls.landmark_sharded_solve(state, cfg, group=dist.group.WORLD)
print("RESULT" + json.dumps(dict(
    rank={rank}, factor=a.poses.numpy().tolist(),
    landmark=b.poses.numpy().tolist(), roots=b.cyl_root.numpy().tolist())))
dist.destroy_process_group()
"""


@pytest.mark.slow
def test_two_process_gloo_matches_in_process(state, tmp_path):
    """distributed_solve and landmark_sharded_solve over a two-process gloo
    group equal the same solves with two shards in one process."""
    _, tcfg = cfgs()
    path = str(tmp_path / "state.npz")
    np.savez(path, **state)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(
            repo=REPO, init=f"tcp://localhost:{port}", rank=r, cap=CAP,
            path=path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se[-3000:]
        line = [x for x in so.splitlines() if x.startswith("RESULT")][-1]
        outs.append(json.loads(line[len("RESULT"):]))
    a = dba.distributed_solve(_t(state), tcfg, n_shards=2)
    b = ls.landmark_sharded_solve(_t(state), tcfg, n_shards=2)
    for out in outs:
        np.testing.assert_allclose(np.asarray(out["factor"]), a.poses.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(out["landmark"]),
                                   b.poses.numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out["roots"]),
                                   b.cyl_root.numpy(), atol=1e-5)
    print("two-process gloo: factor-sharded max |dpose| "
          f"{np.abs(np.asarray(outs[0]['factor']) - a.poses.numpy()).max():.3e}"
          ", landmark-sharded "
          f"{np.abs(np.asarray(outs[0]['landmark']) - b.poses.numpy()).max():.3e}")

"""The keyframe engine on a run that overflows every capacity: the port (on
the CPU) vs the JAX package, keyframe by keyframe.

Tiny capacities make both packages drop pose slots, landmarks of each family
and factors of each family; the JAX version drops out-of-range destinations
in its `mode="drop"` scatters, the port masks them. Match indices, new-
landmark counts, slots and the eight overflow counters must be IDENTICAL;
key poses agree to 1e-3 m and 1e-3 rad (f32 sums in another order).
"""
from pathlib import Path

import numpy as np
import pytest

from slide_slam_tpu.runtime import engine as jengine
from slide_slam_tpu.runtime.node import SlamNode as JNode
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.node import SlamNode as TNode

from _torch_parity import one_torch_thread, small_configs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

POS_TOL = 1e-3
ROT_TOL = 1e-3
TINY = dict(max_poses_per_robot=8, max_cylinders=12, max_cuboids=3,
            max_points=3, max_scan_objects=16, max_cylinder_factors=48,
            max_cuboid_factors=8, max_point_factors=8)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(1)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=4, n_cars=6,
                                        extent=15.0)
    traj = synthetic.lawnmower_trajectory(11, extent=12.0, rows=1, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01)
    jcfg, tcfg = small_configs(**TINY)

    j_outs = []
    orig = jengine.keyframe_step_fused

    def recording_step(*a, **k):
        s, out = orig(*a, **k)
        j_outs.append({k: np.asarray(v) for k, v in out._asdict().items()})
        return s, out

    jnode = JNode(jcfg, robot_id=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "keyframe_step_fused", recording_step)
        for kf in log.keyframes:
            jnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))

    t_outs = []
    tnode = TNode(tcfg, robot_id=0, device="cpu")
    for kf in log.keyframes:
        tnode.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
        t_outs.append({k: v.numpy() for k, v in
                       tnode.last_step._asdict().items()})
    return j_outs, t_outs, jnode, tnode


def test_every_family_overflows(runs):
    _, _, jnode, tnode = runs
    report = tnode.overflow_report()
    assert report == jnode.overflow_report()
    for name in ("poses", "cylinders", "cuboids", "points",
                 "cylinder_factors", "cuboid_factors", "point_factors"):
        assert report[f"overflow_{name}"] > 0, (name, report)
    assert tnode.landmark_counts() == jnode.landmark_counts()


@pytest.mark.parametrize("kf", range(11))
def test_step_outputs_identical(runs, kf):
    j, t = runs[0][kf], runs[1][kf]
    for key in ("slot", "n_new_cyl", "n_new_cub", "n_new_pt", "cyl_matches",
                "cub_matches", "pt_matches", "overflow"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert t["cyl_matches"].dtype == np.int32 and t["slot"].dtype == np.int32
    np.testing.assert_allclose(t["pose"][4:7], j["pose"][4:7], atol=POS_TOL,
                               rtol=0)
    np.testing.assert_allclose(t["pose"][1:4], j["pose"][1:4], atol=ROT_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Batched entry points: replay_batch, keyframe_batch_fused, add_between_factor
# ---------------------------------------------------------------------------
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from slide_slam_tpu.config import CapacityConfig as JCap  # noqa: E402
from slide_slam_tpu.config import SlamConfig as JCfg  # noqa: E402
from slide_slam_tpu.factorgraph.graph import empty_state as j_empty  # noqa: E402
from slide_slam_tpu_torch.config import CapacityConfig as TCap  # noqa: E402
from slide_slam_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from slide_slam_tpu_torch.factorgraph.graph import \
    empty_state as t_empty  # noqa: E402
from slide_slam_tpu_torch.runtime import engine as tengine  # noqa: E402

# the JAX package's tests/test_replay_batch.py capacities
REPLAY_CAP = dict(max_poses_per_robot=32, max_cylinders=64, max_cuboids=32,
                  max_points=16, max_scan_objects=8, max_cylinder_factors=256,
                  max_cuboid_factors=128, max_point_factors=64,
                  max_between_factors=8)


def _replay_inputs(n, S, seed=3):
    """[n, 2, 7] (pose, rel odom) walking forward and [n, S, 33] packed
    scans with four valid cylinders each (tests/test_replay_batch.py)."""
    rng = np.random.default_rng(seed)
    par = np.zeros((n, 2, 7), np.float32)
    par[:, :, 0] = 1.0
    par[:, 0, 4] = np.cumsum(rng.normal(1.0, 0.1, n))
    par[:, 1, 4] = 1.0
    packed = np.zeros((n, S, 33), np.float32)
    packed[:, :, 12] = 1.0
    packed[:, :, 24] = 1.0
    packed[:, :4, 0:3] = rng.normal(0, 5.0, (n, 4, 3))
    packed[:, :4, 3:6] = [0.0, 0.0, 1.0]
    packed[:, :4, 6] = np.abs(rng.normal(0.3, 0.05, (n, 4)))
    packed[:, :4, 7] = 8
    packed[:, :4, 8] = 1.0
    return par, packed


def _tstate_np(s):
    return {k: getattr(s, k).numpy() for k in s._fields}


def test_replay_batch_matches_jax_and_sequential():
    """The port's replay_batch (host loop over the rows) equals its own
    one-keyframe-at-a-time fold bit for bit, sets no prior on the peer
    chain, and matches the JAX replay_batch (padded lax.scan): counts,
    landmark indices and overflow identical, floats within 1e-5."""
    jcfg = JCfg(number_of_robots=2, capacity=JCap(**REPLAY_CAP))
    tcfg = TCfg(number_of_robots=2, capacity=TCap(**REPLAY_CAP))
    n, S, C = 11, REPLAY_CAP["max_scan_objects"], 16
    par, packed = _replay_inputs(n, S)
    on = np.asarray(tcfg.noise.odom, np.float32)
    cn = np.asarray(tcfg.noise.cube, np.float32)
    t_on, t_cn = torch.as_tensor(on), torch.as_tensor(cn)

    t_bat = tengine.replay_batch(tcfg, t_empty(tcfg, device="cpu"), 1,
                                 torch.as_tensor(par),
                                 torch.as_tensor(packed), t_on, t_cn)
    t_seq = t_empty(tcfg, device="cpu")
    for i in range(n):
        t_seq = tengine.replay_batch(tcfg, t_seq, 1,
                                     torch.as_tensor(par[i:i + 1]),
                                     torch.as_tensor(packed[i:i + 1]),
                                     t_on, t_cn)
    for k in t_bat._fields:
        assert torch.equal(getattr(t_bat, k), getattr(t_seq, k)), k
    assert not bool(t_bat.prior_valid[1]) and int(t_bat.pose_count[1]) == n
    # an empty chunk is a no-op
    t_none = tengine.replay_batch(tcfg, t_bat, 0, torch.zeros((0, 2, 7)),
                                  torch.zeros((0, S, 33)), t_on, t_cn)
    for k in t_bat._fields:
        assert torch.equal(getattr(t_none, k), getattr(t_bat, k)), k

    par_p = np.zeros((C, 2, 7), np.float32)
    par_p[:, :, 0] = 1.0
    par_p[:n] = par
    packed_p = np.zeros((C, S, 33), np.float32)
    packed_p[:, :, 12] = 1.0
    packed_p[:, :, 24] = 1.0
    packed_p[:n] = packed
    j_bat = jengine.replay_batch(
        jcfg, j_empty(jcfg), jnp.int32(1), jnp.asarray(par_p),
        jnp.asarray(packed_p), jnp.asarray(np.arange(C) < n),
        jnp.asarray(on), jnp.asarray(cn))
    t_np = _tstate_np(t_bat)
    for k in j_bat._fields:
        a, b = np.asarray(getattr(j_bat, k)), t_np[k]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=k)


def test_keyframe_batch_matches_sequential_and_jax():
    """process_keyframe_batch (engine.keyframe_batch_fused) equals one
    process_keyframe per item in the port (same ops, bit for bit) and
    matches the JAX batch path: counts identical, poses within 1e-3 m /
    1e-3 rad (f32 sums in another order), stamps identical
    (tests/test_keyframe_batch.py)."""
    cap = dict(max_poses_per_robot=64, max_cylinders=128, max_cuboids=64,
               max_points=64, max_scan_objects=16, max_cylinder_factors=1024,
               max_cuboid_factors=256, max_point_factors=256,
               max_between_factors=8)
    jcfg = JCfg(number_of_robots=1, capacity=JCap(**cap))
    tcfg = TCfg(number_of_robots=1, capacity=TCap(**cap))
    rng = np.random.default_rng(5)
    world = synthetic.make_forest_world(rng, n_trees=30, n_poles=5, n_cars=5,
                                        extent=18.0)
    traj = synthetic.lawnmower_trajectory(20, extent=14.0, rows=2, step=1.5)
    log = synthetic.make_log(world, traj, odom_drift_sigma=0.01,
                             pos_noise=0.03, seed=2)
    kfs = log.keyframes
    chunks = [kfs[:16], kfs[16:]]          # a full batch and a partial one

    seq = TNode(tcfg, robot_id=0, device="cpu")
    for kf in kfs:
        seq.process_keyframe(kf.stamp, kf.odom_pose, vars(kf))
    bat = TNode(tcfg, robot_id=0, device="cpu")
    jbat = JNode(jcfg, robot_id=0)
    for chunk in chunks:
        items = [(kf.stamp, kf.odom_pose, vars(kf)) for kf in chunk]
        bat.process_keyframe_batch(items)
        jbat.process_keyframe_batch(items)
    for k in seq.state._fields:
        assert torch.equal(getattr(seq.state, k), getattr(bat.state, k)), k
    assert seq.key_stamps == bat.key_stamps == jbat.key_stamps
    assert bat.landmark_counts() == jbat.landmark_counts()
    assert bat.overflow_report() == jbat.overflow_report()
    assert int(bat.state.cf_count) == int(jbat.state.cf_count)
    t, j = bat.optimized_trajectory(), jbat.optimized_trajectory()
    assert len(t) == len(j) == len(kfs)
    np.testing.assert_allclose(t[:, 4:7], j[:, 4:7], atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=ROT_TOL, rtol=0)


def test_add_between_factor_overflow_matches_jax():
    """Appends past max_between_factors are dropped and counted in
    overflow[7]; the factor array and counters equal the JAX version's."""
    cap = dict(REPLAY_CAP, max_between_factors=3)
    jcfg = JCfg(number_of_robots=2, capacity=JCap(**cap))
    tcfg = TCfg(number_of_robots=2, capacity=TCap(**cap))
    js, ts = j_empty(jcfg), t_empty(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    for k in range(5):
        rel = rng.normal(size=7).astype(np.float32)
        sig = np.abs(rng.normal(size=6)).astype(np.float32)
        js = jengine.add_between_factor(jcfg, js, jnp.int32(k),
                                        jnp.int32(32 + k), jnp.asarray(rel),
                                        jnp.asarray(sig))
        ts = tengine.add_between_factor(tcfg, ts, k, 32 + k,
                                        torch.as_tensor(rel),
                                        torch.as_tensor(sig))
    for k in ("bf_i", "bf_j", "bf_rel", "bf_sigma", "bf_count", "overflow"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    assert int(ts.bf_count) == 3 and int(ts.overflow[7]) == 2


def _mission_configs():
    """Both packages' SlamConfig of chip_smoke.py's 3-robot mission."""
    import dataclasses

    from slide_slam_tpu import config as jconfig
    from slide_slam_tpu_torch import config as tconfig
    out = []
    for config in (jconfig, tconfig):
        cfg = config.SlamConfig(
            number_of_robots=3, capacity=config.mission_capacity(150),
            solver=config.realtime_solver(),
            intra_robot_place_recognition_frequency=0.2)
        out.append(cfg.replace(noise=dataclasses.replace(cfg.noise,
                                                         cylinder=10.0)))
    return out


def test_mission_drift_starts_in_an_ill_conditioned_full_solve():
    """Where the 3 x 150 sync mission's port and JAX runs part: robot 2's
    periodic full solve at its keyframe 32 (scripts/jax_mission_reference.py
    --trace: host poses within 7.6e-6 m before it, 4.4 mm after it; robot
    2's first inter-robot search, ten keyframes later, is the first
    decision that differs). The states both packages held just before that
    solve (`--dump-full-solve 2 32`) are the test's input. They agree
    (integers identical, poses within 1e-5 m). On the JAX state, the port's
    full solve lands within 3 mm of the JAX package's; the JAX package
    itself moves further, 4.3 mm, when its bf16x3 one-hot segment sums are
    replaced by exact f32 sums, so the gap is the reference's own
    conditioning, not a port fault."""
    import jax
    import jax.numpy as jnp

    from slide_slam_tpu.factorgraph import schur as jschur
    from slide_slam_tpu_torch.convert import state_from_numpy, state_to_numpy
    from slide_slam_tpu_torch.runtime import engine as tengine

    from _torch_parity import jax_state_from_numpy
    data = Path(__file__).parent / "data"
    jin = dict(np.load(data / "mission_robot2_kf32_jax.npz"))
    tin = dict(np.load(data / "mission_robot2_kf32_port.npz"))
    for k in jin:
        if jin[k].dtype.kind in "iub":
            np.testing.assert_array_equal(tin[k], jin[k], err_msg=k)
    assert np.abs(tin["poses"] - jin["poses"]).max() < 1e-5
    jcfg, tcfg = _mission_configs()

    def jax_full(matmul=None):
        with pytest.MonkeyPatch.context() as mp:
            if matmul is not None:
                mp.setattr(jschur, "_bf16x2_matmul", matmul)
            jax.clear_caches()
            s = jengine.solve_full(jcfg, jax_state_from_numpy(jin))
            out = np.asarray(s.poses)
        jax.clear_caches()
        return out

    def exact(onehot_t, y):
        return jnp.einsum("nf,fd->nd", onehot_t.astype(jnp.float32), y,
                          precision=jax.lax.Precision.HIGHEST)

    want = jax_full()
    want_exact = jax_full(exact)
    got = state_to_numpy(tengine.solve_full(
        tcfg, state_from_numpy(jin, device="cpu")))["poses"]
    port_gap = np.abs(got[:, 4:7] - want[:, 4:7]).max()
    reference_gap = np.abs(want_exact[:, 4:7] - want[:, 4:7]).max()
    assert 1e-3 < reference_gap < 1e-2
    assert port_gap <= 3e-3 and port_gap <= reference_gap

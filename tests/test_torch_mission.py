"""The decentralized multi-robot mission: the PyTorch port (on the CPU)
against the JAX package, and the inter-robot database.

The mission is tests/test_mission_runtime.py's small world (40 trees, 6
poles, 4 cars), 2 robots x 50 keyframes (a 1.5-lap loop and a lawnmower),
run synchronously (async results depend on timing), through the input
manager, with intra-LC attempts and AprilTag-style relative measurements.
chip_smoke.py runs the same mission on the card and on the CPU
(phase card_vs_cpu:mission). Tolerances:
* decisions and counts identical: merged robot pairs and TF keys, closure
  attempts and successes, relative factors, landmark counts, overflow;
* merge TFs within 1e-3 m / 1e-3 rad;
* each robot's own trajectory within 1 cm (f32 solver sums in another
  order, carried through 100 keyframe steps and several full solves),
  per-robot ATE within 5 mm of the JAX package's;
* a node's replayed PEER chain within 2.5 cm: it carries no gauge anchor
  (replay sets no prior), so its absolute placement rests only on shared
  landmarks and relative factors and moves as a whole with the summation
  order (5.3 mm here).
"""
import dataclasses

import numpy as np
import pytest

import chip_smoke

from slide_slam_tpu import config as jconfig
from slide_slam_tpu.comm import database as jdb
from slide_slam_tpu.runtime import scheduler as jsch
from slide_slam_tpu.runtime.mission import MultiRobotMission as JMission
from slide_slam_tpu_torch import config as tconfig
from slide_slam_tpu_torch.comm import database as tdb
from slide_slam_tpu_torch.geometry import se3np
from slide_slam_tpu_torch.io import synthetic
from slide_slam_tpu_torch.runtime.mission import MultiRobotMission as TMission

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAJ_TOL = 1e-2     # m, own chains
PEER_TOL = 2.5e-2   # m, replayed peer chains
ATE_TOL = 5e-3      # m
TF_TOL = 1e-3


def small_mission(config):
    """(cfg, trajs, logs, relative measurements) of the small mission, with
    `config` either package's config module (the data is numpy); 64 pose
    slots per robot and room for every landmark and factor."""
    return chip_smoke.small_mission(config, synthetic)


@pytest.fixture(scope="module")
def missions():
    jcfg, trajs, logs, rel = small_mission(jconfig)
    jrel = [(rid, jsch.RelativeMeas(**vars(m))) for rid, m in rel]
    jrep = JMission(jcfg, logs, relative_meas=jrel, async_runtime=False,
                    use_input_manager=True).run(intra_lc=True)
    tcfg, _, _, _ = small_mission(tconfig)
    trep = TMission(tcfg, logs, relative_meas=rel, async_runtime=False,
                    use_input_manager=True, device="cpu").run(intra_lc=True)
    return jrep, trep, trajs, logs, rel


def test_mission_decisions_identical(missions):
    jrep, trep, _, _, rel = missions
    assert len(rel) > 0
    for j, t in zip(jrep.nodes, trep.nodes):
        assert sorted(t.dbm.loop_closure_tf) == sorted(j.dbm.loop_closure_tf)
        for rid, tf in j.dbm.loop_closure_tf.items():
            d = se3np.between(tf, t.dbm.loop_closure_tf[rid])
            assert np.abs(d[4:7]).max() < TF_TOL
            assert np.abs(d[1:4]).max() < TF_TOL
        assert (t.num_attempts_inter, t.num_success_inter) == \
            (j.num_attempts_inter, j.num_success_inter)
        assert (t.num_attempts_intra, t.num_success_intra) == \
            (j.num_attempts_intra, j.num_success_intra)
        assert t.num_rel_factors == j.num_rel_factors
        assert t.landmark_counts() == j.landmark_counts()
        assert t.overflow_report() == j.overflow_report()
        assert t.key_stamps == j.key_stamps
        assert int(t.state.bf_count) == int(j.state.bf_count)
    # the mission exercises every path it claims to
    assert sum(len(n.dbm.loop_closure_tf) for n in trep.nodes) == 2
    assert sum(n.num_rel_factors for n in trep.nodes) > 0
    assert sum(n.num_attempts_intra for n in trep.nodes) > 0
    assert sum(sum(n.overflow_report().values()) for n in trep.nodes) == 0


def test_mission_trajectories_match(missions):
    jrep, trep, trajs, logs, _ = missions
    for j, t, traj, log in zip(jrep.nodes, trep.nodes, trajs, logs):
        for rid in range(2):      # own chain and the replayed peer chain
            a, b = t.trajectory_of(rid), j.trajectory_of(rid)
            assert a.shape == b.shape
            tol = TRAJ_TOL if rid == t.robot_id else PEER_TOL
            np.testing.assert_allclose(a[:, 4:7], b[:, 4:7], atol=tol,
                                       rtol=0)
        ate_t = synthetic.stamp_matched_ate(t.optimized_trajectory(),
                                            t.key_stamps, log, traj)
        ate_j = synthetic.stamp_matched_ate(j.optimized_trajectory(),
                                            j.key_stamps, log, traj)
        assert abs(ate_t - ate_j) < ATE_TOL, (ate_t, ate_j)
        assert ate_t < 0.3


# ---------------------------------------------------------------------------
# Inter-robot database: bundles, TF gossip, byte accounting
# ---------------------------------------------------------------------------
def _packets(db, rng, n):
    out = []
    for i in range(n):
        obs = {"cyl_root": rng.normal(size=(3, 3)),
               "cyl_ray": rng.normal(size=(3, 3)),
               "cyl_radius": rng.uniform(0.1, 0.5, 3),
               "cyl_label": np.full(3, 8),
               "cub_pose": np.tile(se3np.identity(), (1, 1)),
               "cub_scale": np.ones((1, 3)), "cub_label": np.ones(1)}
        out.append(db.packet_from_obs(float(i), se3np.identity(),
                                      se3np.identity(), obs))
    return out


@pytest.mark.parametrize("prior_tf_known", [False, True])
def test_database_exchange_matches_jax(prior_tf_known):
    """Three robots, robot 0 knows TFs to 1 (found) and 1 knows 2: after
    two all-to-all rounds, every TF table (transitive gossip and inverse
    on receipt), packet pool and the comm_stats byte counts (TF bytes
    counted once per received packet, as in the reference) match."""
    tables = {}
    for name, db in (("jax", jdb), ("port", tdb)):
        rng = np.random.default_rng(2)
        dbs = [db.DatabaseManager(r, 3, prior_tf_known=prior_tf_known,
                                  prior_tf_xyz=np.array([r * 2.0, 1.0, 0.0]))
               for r in range(3)]
        for r, d in enumerate(dbs):
            d.host_record().packets.extend(_packets(db, rng, 3 + r))
            d.update_robot_map(rng.normal(size=(5 + r, 7)))
        if not prior_tf_known:
            dbs[0].loop_closure_tf[1] = np.asarray(
                se3np.from_xyz_yaw(1.0, 2.0, 0.0, 0.3), np.float32)
            dbs[1].loop_closure_tf[2] = np.asarray(
                se3np.from_xyz_yaw(-1.0, 0.5, 0.0, -0.2), np.float32)
        for now in (10.0, 20.0):
            sent = [(d.host_robot_id, d.make_bundles(now)) for d in dbs
                    if d.should_communicate(now)]
            for sender, bundles in sent:
                for d in dbs:
                    if d.host_robot_id != sender:
                        for b in bundles:
                            d.ingest_bundle(b)
        tables[name] = dbs
    for j, t in zip(tables["jax"], tables["port"]):
        assert sorted(t.loop_closure_tf) == sorted(j.loop_closure_tf)
        for rid in j.loop_closure_tf:
            np.testing.assert_allclose(t.loop_closure_tf[rid],
                                       j.loop_closure_tf[rid], atol=1e-6)
        assert t.comm_stats() == j.comm_stats()
        assert t.stamps_by_robot() == j.stamps_by_robot()
        assert {r: len(x.packets) for r, x in t.records.items()} == \
            {r: len(x.packets) for r, x in j.records.items()}
    if not prior_tf_known:
        assert sorted(tables["port"][2].loop_closure_tf) == [1]


def test_relative_measurements_are_noisy_true_relatives():
    """Each sighting relates two robots' keyframes of the same stamp: the
    lower id observes, the relative pose is the true one within its 0.02 m
    noise (6 sigma), the odometry pose is the observer's."""
    _, _, logs, rel = small_mission(tconfig)
    for rid, m in rel:
        a = [k for k in logs[rid].keyframes
             if round(k.stamp, 3) == round(m.stamp, 3)][0]
        b = [k for k in logs[m.robot_index].keyframes
             if round(k.stamp, 3) == round(m.stamp, 3)][0]
        true_rel = se3np.between(a.true_pose, b.true_pose)
        assert np.abs(m.relative_pose[4:7] - true_rel[4:7]).max() < 0.12
        np.testing.assert_array_equal(m.relative_pose[:4], true_rel[:4])
        np.testing.assert_array_equal(m.odom_pose, a.odom_pose)
        assert rid < m.robot_index and not m.only_use_odom


def test_mission_parity_setup_uses_the_reference_config():
    """Apart from capacity, the small mission runs the packages' default
    config, whose fields the port copies one for one."""
    jcfg, _, _, _ = small_mission(jconfig)
    tcfg, _, _, _ = small_mission(tconfig)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)

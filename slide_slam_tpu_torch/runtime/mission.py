"""Single-host multi-robot mission runner (PyTorch twin of
slide_slam_tpu/runtime/mission.py).

Replaces the reference's tmux/roslaunch demo layer
(multi_robot_utils_launch/script/tmux_multi_robot_with_bags_*.sh +
decentralized_sloam.launch): N decentralized SlamNodes replaying per-robot
measurement logs on one simulated clock, with intermittent communication
every `communication_wait_time` seconds of sim time, inter/intra
place-recognition attempts at their configured frequencies, and relative
inter-robot factor generation at 1 Hz — the same event structure the
reference builds from ROS timers (inputNode.cpp:16, databaseManager.cpp:14,
sloamNode.cpp:46-48).

Two runtime modes:
* `async_runtime=True` (default): loop-closure searches and mirror fetches
  run on a worker pool concurrently with keyframe dispatches — the
  reference's 3-detached-thread model (sloamNode.cpp:100-119). Results are
  applied at event boundaries on the main thread, like the reference's
  mutex-guarded factor insertion.
* `async_runtime=False`: every path inline + blocking — deterministic,
  used by replay-parity tests.

Measurement routing: `use_input_manager=True` feeds the raw streams
through each robot's InputManager queues (`on_observation`/
`on_relative_measurement` + `tick` at `main_node_rate`), exercising the
reference's scheduler discipline (msg_delay_tolerance, odometry
downsampling, PickNextMeasurementToAdd — inputNode.cpp:88-186) under the
mission clock. The direct mode calls `process_keyframe` straight away
(stamp order identical; a parity test asserts equal trajectories).

Every node's graph lives on `device` ("cuda" by default; tests pass "cpu").
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..io.synthetic import RobotLog
from ..place_recognition.slidematch import SlideMatchDims
from . import engine
from .input_manager import InputManager
from .node import SlamNode
from .profiling import phase, phase_add, to_host


@dataclass
class MissionReport:
    nodes: List[SlamNode]

    def trajectories(self) -> Dict[int, np.ndarray]:
        return {n.robot_id: n.optimized_trajectory() for n in self.nodes}


class MultiRobotMission:
    def __init__(self, cfg: SlamConfig, logs: Sequence[RobotLog],
                 prior_tf_known: bool = False,
                 prior_tf_xyz: Optional[dict] = None,
                 slidematch_dims: Optional[SlideMatchDims] = None,
                 relative_meas: Optional[List] = None,
                 async_runtime: bool = True,
                 use_input_manager: bool = False,
                 use_native_queues: bool = False,
                 device="cuda"):
        """relative_meas: optional list of (receiving_robot_id,
        scheduler.RelativeMeas) AprilTag-style sightings to inject."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.logs = list(logs)
        self.pool = (ThreadPoolExecutor(
            max_workers=max(2, len(self.logs)),
            thread_name_prefix="slam-worker") if async_runtime else None)
        self.nodes = [
            SlamNode(cfg, log.robot_id, prior_tf_known=prior_tf_known,
                     prior_tf_xyz=(prior_tf_xyz or {}).get(log.robot_id),
                     slidematch_dims=slidematch_dims, pool=self.pool,
                     device=self.device)
            for log in self.logs
        ]
        self.by_id = {n.robot_id: n for n in self.nodes}
        self.relative_meas = relative_meas or []
        self.use_input_manager = use_input_manager
        if use_input_manager:
            self.input_managers = {
                n.robot_id: InputManager(cfg, n, use_native=use_native_queues)
                for n in self.nodes}
        # pending async LC jobs: (robot_id, kind) -> Future
        self._jobs: Dict[tuple, Future] = {}

    # ------------------------------------------------------------------
    # Async job plumbing
    # ------------------------------------------------------------------
    def _drain_jobs(self, block: bool = False):
        """Apply finished worker results on the main thread (the
        reference applies LC results under the factor-graph mutex)."""
        done = []
        for key, fut in self._jobs.items():
            if block or fut.done():
                done.append(key)
        for key in done:
            fut = self._jobs.pop(key)
            rid, kind = key
            node = self.by_id[rid]
            res = fut.result()
            if kind == "intra":
                with phase("intra_apply"):
                    node._apply_intra_result(res)
            elif kind == "inter":
                with phase("inter_apply"):
                    node._apply_inter_result(res)

    def _submit(self, rid: int, kind: str, fut: Optional[Future]):
        if fut is not None:
            self._jobs[(rid, kind)] = fut

    def _finish_job(self, rid: int, kind: str):
        """Block on one node's in-flight LC job and apply its result."""
        fut = self._jobs.pop((rid, kind), None)
        if fut is None:
            return
        res = fut.result()
        node = self.by_id[rid]
        if kind == "intra":
            with phase("intra_apply"):
                node._apply_intra_result(res)
        else:
            with phase("inter_apply"):
                node._apply_inter_result(res)

    # ------------------------------------------------------------------
    def run(self, intra_lc: bool = False, verbose: bool = False,
            final_solve: bool = True) -> MissionReport:
        cfg = self.cfg
        events = []   # (stamp, order, kind, payload)
        for log in self.logs:
            for kf in log.keyframes:
                events.append((kf.stamp, 0, "keyframe", (log.robot_id, kf)))
        for rid, meas in self.relative_meas:
            events.append((meas.stamp, 1, "relative", (rid, meas)))
        t0 = min(e[0] for e in events)
        t1 = max(e[0] for e in events)
        if self.use_input_manager:
            # main-loop ticks at main_node_rate (inputNode.cpp:16); the
            # trailing ticks flush entries younger than msg_delay_tolerance
            tick_dt = 1.0 / cfg.main_node_rate
            for t in np.arange(t0 + tick_dt,
                               t1 + cfg.msg_delay_tolerance + 2 * tick_dt,
                               tick_dt):
                events.append((float(t), 1.5, "tick", None))
        for t in np.arange(t0, t1 + 1e-6, cfg.communication_wait_time):
            events.append((float(t), 2, "comm", None))
        # per-robot cadences, staggered by offset * robot_id so attempts
        # don't spike simultaneously (sloamNode.cpp:50-64)
        stagger = cfg.place_recognition_attempt_time_offset
        lc_period = 1.0 / cfg.inter_robot_place_recognition_frequency
        for node in self.nodes:
            off = stagger * node.robot_id
            for t in np.arange(t0 + 1.0 + off, t1 + 1e-6,
                               min(lc_period, t1 - t0 + 1.0)):
                events.append((float(t), 3, "inter_lc", node.robot_id))
            if intra_lc:
                # thread-tick cadence; the success cool-down
                # (1/intra_frequency) is enforced by the node's gate
                for t in np.arange(t0 + 1.0 + off, t1 + 1e-6,
                                   min(cfg.intra_attempt_period,
                                       t1 - t0 + 1.0)):
                    events.append((float(t), 4, "intra_lc", node.robot_id))
            for t in np.arange(t0 + off, t1 + 1e-6,
                               1.0 / cfg.rel_inter_robot_factor_frequency):
                events.append((float(t), 5, "rel_factor", node.robot_id))
        events.sort(key=lambda e: (e[0], e[1]))

        asyncmode = self.pool is not None
        for stamp, _, kind, payload in events:
            if asyncmode:
                self._drain_jobs()
            if kind == "keyframe":
                rid, kf = payload
                if self.use_input_manager:
                    self.input_managers[rid].on_observation(
                        kf.stamp, kf.odom_pose, vars(kf))
                else:
                    self.by_id[rid].process_keyframe(kf.stamp, kf.odom_pose,
                                                     vars(kf))
            elif kind == "tick":
                for im in self.input_managers.values():
                    im.tick(stamp)
            elif kind == "relative":
                rid, meas = payload
                if self.use_input_manager:
                    self.input_managers[rid].on_relative_measurement(meas)
                elif not meas.only_use_odom:
                    self.by_id[rid].add_relative_measurement(meas)
            elif kind == "comm":
                self._exchange(stamp)
            elif kind == "inter_lc":
                n = self.by_id[payload]
                if asyncmode:
                    # PACED async: the attempt cadence rides the SIM clock.
                    # An in-flight search from the previous tick is waited
                    # out (and applied) instead of skipping the tick — a
                    # faster-than-realtime replay otherwise races past
                    # every remaining tick while one search runs, starving
                    # the closure machinery to ~1 attempt per mission.
                    # Between ticks the search still overlaps keyframe
                    # dispatch.
                    self._finish_job(n.robot_id, "inter")
                    self._submit(n.robot_id, "inter",
                                 n.submit_inter_loop_closure())
                else:
                    found = n.attempt_inter_loop_closure()
                    if found and verbose:
                        print(f"[t={stamp:.1f}] robot {n.robot_id} found "
                              f"TF to {found}")
            elif kind == "intra_lc":
                n = self.by_id[payload]
                if asyncmode:
                    self._finish_job(n.robot_id, "intra")
                    self._submit(n.robot_id, "intra",
                                 n.submit_intra_loop_closure(stamp))
                else:
                    n.attempt_intra_loop_closure(stamp)
            elif kind == "rel_factor":
                self.by_id[payload].process_relative_factors()

        # final flush: drain workers, then one last exchange + merge so
        # trailing keyframes that arrived after the last comm tick are
        # folded in everywhere
        if asyncmode:
            self._drain_jobs(block=True)
        self._exchange(t1 + 10 * cfg.communication_wait_time,
                       block_maps=True)
        # one final inter-LC round per required confirmation: a TF first
        # detected here must still earn its re-detection witness
        # (inter_tf_confirmations) before a merge is accepted
        for _ in range(max(1, cfg.inter_tf_confirmations)):
            for n in self.nodes:
                if asyncmode:
                    self._submit(n.robot_id, "inter",
                                 n.submit_inter_loop_closure())
                else:
                    found = n.attempt_inter_loop_closure()
                    if found and verbose:
                        print(f"[final] robot {n.robot_id} found TF to "
                              f"{found}")
            if asyncmode:
                self._drain_jobs(block=True)
        for n in self.nodes:
            n.replay_peers()
            n.process_relative_factors()
        if final_solve:
            # finalize: one thorough solve per node so exported
            # trajectories/maps reflect the optimum rather than the last
            # real-time incremental nudge
            # drain the queued device backlog (trailing replays/exchange
            # work) before the solves, so the pose_fetch phase below
            # measures the fetch itself
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            phase_add("final_backlog_wait", time.perf_counter() - t0)
            for n in self.nodes:
                n.state = engine.solve_full(cfg, n.state)
            if self.pool is not None:
                # fetch every node's chain on the pool, concurrently
                futs = [(n, self.pool.submit(to_host, n._snapshot_poses(),
                                             "pose_fetch"))
                        for n in self.nodes]
                t0 = time.perf_counter()
                chains = [(n, f.result()) for n, f in futs]
                phase_add("pose_fetch", time.perf_counter() - t0)
                for n, chain in chains:
                    n._pose_future = None   # stale in-flight refresh, drop
                    n.refresh_poses(chain)
            else:
                for n in self.nodes:
                    n.refresh_poses()
        return MissionReport(self.nodes)

    def _exchange(self, now: float, block_maps: bool = False):
        """All-to-all bundle exchange (databaseManager.cpp:219-279 + the
        per-robot subscriptions :57-60)."""
        with phase("comm_exchange"):
            self._exchange_inner(now, block_maps)

    def _exchange_inner(self, now: float, block_maps: bool = False):
        communicating = [n for n in self.nodes if n.dbm.should_communicate(now)]
        if self.pool is not None:
            # Non-blocking map policy: fold whatever background map fetch
            # has COMPLETED, then start a new one. Blocking here would
            # serialize the mission clock behind the device backlog;
            # the reference's maps
            # are equally stale — each robot broadcasts the map it last
            # refreshed at its own cadence (sloamNode.cpp:1017 vs the
            # comm timer, databaseManager.cpp:14).
            for n in communicating:
                n.collect_map_refresh(block=block_maps)
                n.request_map_refresh()
        else:
            for n in communicating:
                n.refresh_robot_map()
        all_bundles = [(n.robot_id, n.dbm.make_bundles(now))
                       for n in communicating]
        for sender, bundles in all_bundles:
            for n in self.nodes:
                if n.robot_id == sender:
                    continue
                for b in bundles:
                    n.dbm.ingest_bundle(b)

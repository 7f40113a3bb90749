"""Host-side per-robot SLAM node (PyTorch twin of
slide_slam_tpu/runtime/node.py).

A thin host loop that packs each keyframe's measurements into one [S, 33]
tensor, drives the engine on the device, runs the loop-closure and
map-merge paths, and keeps the host database (stamps + body-frame
measurement packets, the PoseMstPair deque of databaseManager.h:45-73).

Async runtime (the reference's 3-detached-thread model,
sloamNode.cpp:100-119): with a `pool` (ThreadPoolExecutor), device->host
fetches and the loop-closure searches run on worker threads while the main
loop keeps dispatching keyframes. Every engine call that changes the graph
is made on the main thread; a worker only copies device results to the host
and runs the place-recognition search (whose raster and CLIPPER work runs
on the node's device, on the default stream). A tensor handed to a worker
is a clone made on the main thread, so no later step writes it. With
`pool=None` every path is synchronous and deterministic (the mode parity
tests use).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..comm.database import DatabaseManager, PoseMstPair, packet_from_obs
from ..config import SlamConfig
from ..factorgraph.graph import OVERFLOW_FIELDS, GraphState, empty_state
from ..geometry import se3np
from ..place_recognition.slidegraph import SlideGraph
from ..place_recognition.slidematch import (PlaceRecognition, SlideMatchDims,
                                            _icp_refine)
from . import engine, scheduler
from .profiling import annotate, phase, phase_add, to_host


def _np(x):
    return np.asarray(x, np.float32)


def _filter_compact_rows(rows_dev: torch.Tensor) -> np.ndarray:
    """Worker-side tail of the compact-map refresh: fetch + validity filter
    (column 7 is the device-side valid flag)."""
    rows = to_host(rows_dev, "compact_map")
    return np.ascontiguousarray(rows[rows[:, 7] > 0.5, :7], np.float32)


class SlamNode:
    """One robot's backend: device GraphState + host database.

    `robot_id` owns pose chain `robot_id` inside the shared GraphState; peer
    chains are filled by the replay/merge path (sloamNode.cpp:912-1008)."""

    # keyframes per process_keyframe_batch call, as the JAX node
    KEYFRAME_BATCH = 16
    # peer keyframes per replay_batch call
    REPLAY_CHUNK = 32

    def __init__(self, cfg: SlamConfig, robot_id: int = 0,
                 prior_tf_known: bool = False,
                 prior_tf_xyz: Optional[np.ndarray] = None,
                 slidematch_dims: Optional[SlideMatchDims] = None,
                 pool: Optional[ThreadPoolExecutor] = None,
                 device="cuda"):
        self.cfg = cfg
        self.robot_id = robot_id
        self.device = torch.device(device)
        self.pool = pool
        self._pose_future: Optional[tuple] = None   # (n_at_snapshot, Future)
        self._map_future: Optional[Future] = None
        self._map_lock = threading.Lock()
        self.state: GraphState = empty_state(cfg, device=self.device)
        self.dbm = DatabaseManager(
            robot_id, cfg.number_of_robots,
            communication_wait_time=cfg.communication_wait_time,
            prior_tf_known=prior_tf_known, prior_tf_xyz=prior_tf_xyz)
        self.place_recognition = PlaceRecognition(
            cfg.place_recognition, slidematch_dims, device=self.device)
        self.slidegraph = SlideGraph(cfg.slidegraph, device=self.device)
        self.key_poses: List[np.ndarray] = []   # host pose mirror (np [7])
        self.key_stamps: List[float] = []
        self.latest_odom: Optional[np.ndarray] = None
        self.is_in_lc_region = False
        # host mirrors: odometry-composed estimates, re-synced from the
        # device in one transfer every `pose_refresh_every` keyframes and
        # after closure solves
        self._xyz_hist: List[np.ndarray] = []
        self.pose_refresh_every = 16
        self._kf_since_refresh = 0
        self._peer_pose_count: Dict[int, int] = {}
        self.feasible_relative_meas: List[scheduler.RelativeMeas] = []
        self.last_step: Optional[engine.StepOutput] = None
        # runtime accounting (sloamNode.h:79-91)
        self.data_association_time: List[float] = []
        self.fg_time: List[float] = []
        self.intra_lc_time: List[float] = []
        self.inter_lc_time: List[float] = []
        self.num_attempts_intra = 0
        self.num_success_intra = 0
        self.num_attempts_inter = 0
        self.num_success_inter = 0
        self.num_rel_factors = 0
        self.last_intra_attempt_pose = -1
        # success cool-down clock (sloamNode.cpp:361-366: attempts retry
        # every thread tick; only a SUCCESS arms the 1/frequency interval)
        self.last_intra_success_stamp = -np.inf
        self._last_intra_attempt_stamp: Optional[float] = None
        # unconfirmed inter-robot TF candidates: rid -> (tf7, n_detections)
        self._pending_inter_tf: Dict[int, tuple] = {}
        self._map_dirty = True
        self._noise_odom = torch.as_tensor(_np(cfg.noise.odom),
                                           device=self.device)
        self._noise_cube = torch.as_tensor(_np(cfg.noise.cube),
                                           device=self.device)
        self._closure_sigma = _np(cfg.noise.odom) * cfg.noise.closure_scale
        self._kf_since_full_solve = 0

    # ------------------------------------------------------------------
    def _pack_obs(self, p: PoseMstPair) -> np.ndarray:
        """One [S, 33] f32 scan array (see engine.unpack_scan layout).

        Cached on the packet: in a mission the same PoseMstPair object is
        shared by every node's database and replayed by each peer, so each
        packet is packed once per mission."""
        S = self.cfg.capacity.max_scan_objects
        cached = getattr(p, "_packed", None)
        if cached is not None and cached.shape[0] == S:
            return cached
        out = np.zeros((S, 33), np.float32)
        out[:, 12] = 1.0   # cub pose qw identity
        out[:, 24] = 1.0   # ell pose qw identity
        k = min(len(p.cyl_radius), S)
        if k:
            out[:k, 0:3] = p.cyl_root[:k]
            out[:k, 3:6] = p.cyl_ray[:k]
            out[:k, 6] = p.cyl_radius[:k]
            out[:k, 7] = p.cyl_label[:k]
            out[:k, 8] = 1.0
        k = min(len(p.cub_label), S)
        if k:
            out[:k, 9:16] = p.cub_pose[:k]
            out[:k, 16:19] = p.cub_scale[:k]
            out[:k, 19] = p.cub_label[:k]
            out[:k, 20] = 1.0
        k = min(len(p.ell_label), S)
        if k:
            out[:k, 21:28] = p.ell_pose[:k]
            out[:k, 28:31] = p.ell_scale[:k]
            out[:k, 31] = p.ell_label[:k]
            out[:k, 32] = 1.0
        p._packed = out
        return out

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def prev_key_pose(self) -> np.ndarray:
        """Host value of the latest key pose (the last device snapshot
        composed forward with odometry)."""
        if not self.key_poses:
            return se3np.identity()
        return self.key_poses[-1]

    def refresh_poses(self, chain_full: Optional[np.ndarray] = None):
        """Pull the optimized pose chain from the device in one transfer and
        rebase the host mirrors onto it. chain_full: an already fetched
        [R*P, 7] pose array (skips the blocking read)."""
        n = len(self.key_poses)
        if n == 0:
            return
        t0 = time.perf_counter()
        base = self.robot_id * self.cfg.capacity.max_poses_per_robot
        if chain_full is None:
            chain = to_host(self.state.poses[base:base + n], "pose_fetch")
        else:
            chain = chain_full[base:base + n]
        phase_add("pose_fetch", time.perf_counter() - t0)
        for i in range(n):
            self.key_poses[i] = chain[i]
            self._xyz_hist[i] = chain[i, 4:7]
        self._kf_since_refresh = 0

    # ------------------------------------------------------------------
    # Async mirror refreshes (worker-thread device fetches)
    # ------------------------------------------------------------------
    def _snapshot_poses(self) -> torch.Tensor:
        """A device copy of the pose array, made now on the main thread: a
        worker may fetch it later while new steps replace the state."""
        return self.state.poses.clone()

    def request_pose_refresh(self):
        """Non-blocking refresh_poses: fold a finished background fetch into
        the mirrors, then start a new one (blocking without a pool)."""
        if self.pool is None:
            self.refresh_poses()
            return
        self.collect_pose_refresh(block=False)
        if self._pose_future is None and self.key_poses:
            snap = self._snapshot_poses()
            self._pose_future = (len(self.key_poses),
                                 self.pool.submit(to_host, snap,
                                                  "pose_fetch"))

    def collect_pose_refresh(self, block: bool = True):
        """Fold a completed background pose fetch into the host mirrors;
        poses appended after the snapshot are rebased onto it."""
        if self._pose_future is None:
            return False
        n, fut = self._pose_future
        if not block and not fut.done():
            return False
        t0 = time.perf_counter()
        chain_full = fut.result()
        phase_add("pose_fetch_wait", time.perf_counter() - t0)
        self._pose_future = None
        base = self.robot_id * self.cfg.capacity.max_poses_per_robot
        chain = chain_full[base:base + n]
        if n == 0 or not self.key_poses:
            return True
        old_anchor = self.key_poses[n - 1]
        for i in range(min(n, len(self.key_poses))):
            self.key_poses[i] = chain[i]
            self._xyz_hist[i] = chain[i, 4:7]
        if len(self.key_poses) > n:
            shift = se3np.compose(chain[n - 1], se3np.inverse(old_anchor))
            for i in range(n, len(self.key_poses)):
                p = se3np.compose(shift, self.key_poses[i])
                self.key_poses[i] = p
                self._xyz_hist[i] = p[4:7]
        self._kf_since_refresh = 0
        return True

    def _maybe_refresh_poses(self):
        self._kf_since_refresh += 1
        if self._kf_since_refresh >= self.pose_refresh_every:
            if self.pool is not None:
                self.request_pose_refresh()
            else:
                self.refresh_poses()

    def _maybe_full_solve(self, k: int = 1) -> bool:
        """The periodic thorough solve every `full_solve_every` keyframes;
        True where it ran."""
        every = self.cfg.solver.full_solve_every
        if not every:
            return False
        self._kf_since_full_solve += k
        if self._kf_since_full_solve < every:
            return False
        self._kf_since_full_solve = 0
        with phase("periodic_full_solve"):
            self.state = engine.solve_full(self.cfg, self.state)
        return True

    def rebuild_mirrors(self):
        """Re-derive host mirrors after key_poses / the database were
        replaced wholesale (checkpoint restore): the xyz mirror from
        key_poses, the folded peer counts from the bookmarks; the async
        fetches, the last step's outputs, the refresh counter and the
        buffered relative sightings start afresh (io/checkpoint.py restores
        the last two when the checkpoint carries them)."""
        self._xyz_hist = [np.asarray(p[4:7]) for p in self.key_poses]
        self._kf_since_refresh = 0
        self._peer_pose_count = {
            rid: rec.bookmark_fg for rid, rec in self.dbm.records.items()
            if rid != self.robot_id}
        self.feasible_relative_meas = []
        self.last_step = None
        self._pose_future = None
        self._map_future = None
        self._map_dirty = True

    # ------------------------------------------------------------------
    # Main keyframe path
    # ------------------------------------------------------------------
    def _new_packet(self, stamp, odom_pose):
        """(odom_pose, rel, pose_est) of the next own keyframe, with the
        loop-closure-region check (inputNode.cpp:88-119)."""
        odom_pose = _np(odom_pose)
        if self.latest_odom is None:
            rel = se3np.identity()
        else:
            rel = se3np.between(self.latest_odom, odom_pose)
        if not self.key_poses:
            pose_est = odom_pose
        else:
            # host estimate; the device step composes the exact previous
            # optimized pose itself
            pose_est = se3np.compose(self.prev_key_pose(), rel)
        if not self.cfg.turn_off_intra_loop_closure:
            self.is_in_lc_region = self.in_loop_closure_region(pose_est)
        return odom_pose, rel, pose_est

    def _push_own(self, stamp, odom_pose, pose_est):
        self.key_poses.append(pose_est)
        self._xyz_hist.append(pose_est[4:7])
        self.key_stamps.append(float(stamp))
        self.latest_odom = odom_pose

    def process_keyframe(self, stamp: float, odom_pose: np.ndarray,
                         obs: dict) -> np.ndarray:
        """inputNode.cpp:88-186 case 1/2: integrate one keyframe; returns
        the host pose estimate. odom_pose: the raw odometry pose synced
        with the observation."""
        with phase("kf", key=(self.robot_id, float(stamp))):
            odom_pose, rel, pose_est = self._new_packet(stamp, odom_pose)
            packet = packet_from_obs(stamp, pose_est, rel, obs)
            rec = self.dbm.host_record()
            rec.packets.append(packet)
            self._fused_step(odom_pose, rel, packet,
                             drop=self.is_in_lc_region)
            self._push_own(stamp, odom_pose, pose_est)
            rec.bookmark_fg = len(rec.packets)
            # multi-robot: fold any pending peer keyframes
            # (sloamNode.cpp:912-1008)
            self.replay_peers()
            self._map_dirty = True   # compact map refreshed lazily
            annotate(full_solve=self._maybe_full_solve())
            self._maybe_refresh_poses()
        return self.key_poses[-1]

    def _budget(self):
        sc = self.cfg.solver
        return (sc.incremental_outer_iterations,
                sc.incremental_pcg_iterations,
                float(np.float32(sc.incremental_pcg_tol)))

    def process_keyframe_batch(self, items) -> np.ndarray:
        """Integrate several keyframes with one engine call.

        items: sequence of (stamp, odom_pose, obs), applied in order. The
        device result equals one process_keyframe per item
        (engine.keyframe_batch_fused runs the fused step per keyframe);
        host mirrors, packets and LC-region gating update per item.
        Returns the last host pose estimate."""
        k = len(items)
        assert 0 < k <= self.KEYFRAME_BATCH, k
        S = self.cfg.capacity.max_scan_objects
        oar = np.zeros((k, 2, 7), np.float32)
        packed = np.zeros((k, S, 33), np.float32)
        drops = []
        rec = self.dbm.host_record()
        for i, (stamp, odom_pose, obs) in enumerate(items):
            odom_pose, rel, pose_est = self._new_packet(stamp, odom_pose)
            packet = packet_from_obs(stamp, pose_est, rel, obs)
            rec.packets.append(packet)
            with phase("kf_host_pack"):
                packed[i] = self._pack_obs(packet)
            oar[i, 0] = odom_pose
            oar[i, 1] = rel
            drops.append(self.is_in_lc_region)
            self._push_own(stamp, odom_pose, pose_est)
        t0 = time.perf_counter()
        with phase("kf_dispatch"):
            self.state, _ = engine.keyframe_batch_fused(
                self.cfg, self.state, self.robot_id, self._tensor(oar),
                self._tensor(packed), drops, self._budget(),
                self._noise_odom, self._noise_cube)
        self.fg_time.append(time.perf_counter() - t0)
        rec.bookmark_fg = len(rec.packets)
        self.replay_peers()
        self._map_dirty = True
        self._maybe_full_solve(k)
        self._kf_since_refresh += k - 1
        self._maybe_refresh_poses()
        return self.key_poses[-1]

    def _fused_step(self, odom_pose, rel, packet: PoseMstPair, drop: bool):
        """One device step (DA + insert + solve); nothing is read back."""
        with phase("kf_host_pack"):
            packed = self._tensor(self._pack_obs(packet))
            odom_and_rel = self._tensor(np.stack([_np(odom_pose), _np(rel)]))
        t0 = time.perf_counter()
        with phase("kf_dispatch"):
            self.state, self.last_step = engine.keyframe_step_fused(
                self.cfg, self.state, self.robot_id, odom_and_rel, packed,
                drop, self._budget(), self._noise_odom, self._noise_cube)
        self.fg_time.append(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # Multi-robot merge (sloamNode.cpp:912-1008)
    # ------------------------------------------------------------------
    def replay_peers(self):
        """Fold pending peer keyframes into the local graph: packed on the
        host in chunks of REPLAY_CHUNK, each chunk one engine.replay_batch
        call, then ONE solve after all peers fold (thorough on a first
        fold, when a whole history lands at once; incremental otherwise).
        The fold is the `mission.replay` span, opened only where a peer
        has keyframes to fold."""
        pending = []
        for rid, rec in self.dbm.records.items():
            if rid == self.robot_id:
                continue
            tf = self.dbm.loop_closure_tf.get(rid)
            if tf is None:
                continue
            n = len(rec.packets)
            if rec.bookmark_fg >= n:
                continue
            pending.append((rid, rec, tf, n))
        if not pending:
            return
        first_fold = any(rec.bookmark_fg == 0 for _, rec, _, _ in pending)
        with phase("mission.replay", key=self._key(),
                   first_fold=int(first_fold),
                   poses_replayed=sum(n - rec.bookmark_fg
                                      for _, rec, _, n in pending)):
            self._replay(pending, first_fold)

    def _replay(self, pending, first_fold: bool):
        C = self.REPLAY_CHUNK
        S = self.cfg.capacity.max_scan_objects
        for rid, rec, tf, n in pending:
            t0 = time.perf_counter()
            pending_packets = rec.packets[rec.bookmark_fg:n]
            for lo in range(0, len(pending_packets), C):
                chunk = pending_packets[lo:lo + C]
                with phase("replay_pack"):
                    par = np.zeros((len(chunk), 2, 7), np.float32)
                    packed = np.zeros((len(chunk), S, 33), np.float32)
                    for i, p in enumerate(chunk):
                        par[i, 0] = se3np.compose(tf, p.key_pose)
                        par[i, 1] = p.rel_odom
                        packed[i] = self._pack_obs(p)
                with phase("replay_dispatch"):
                    self.state = engine.replay_batch(
                        self.cfg, self.state, rid, self._tensor(par),
                        self._tensor(packed), self._noise_odom,
                        self._noise_cube)
            self.data_association_time.append(time.perf_counter() - t0)
            rec.bookmark_fg = n
            self._peer_pose_count[rid] = n
        t1 = time.perf_counter()
        with phase("replay_solve"):
            if first_fold:
                self.state = engine.solve_full(self.cfg, self.state)
            else:
                self.state = engine.solve_incremental(self.cfg, self.state)
        self.fg_time.append(time.perf_counter() - t1)
        if first_fold:
            self.request_pose_refresh()

    def _key(self, stamp: Optional[float] = None) -> tuple:
        """A span's key: (robot id, `stamp`, or else the latest keyframe's
        stamp)."""
        if stamp is None and self.key_stamps:
            stamp = self.key_stamps[-1]
        return (self.robot_id, None if stamp is None else float(stamp))

    # ------------------------------------------------------------------
    # Loop-closure paths
    # ------------------------------------------------------------------
    def in_loop_closure_region(self, pose: np.ndarray) -> bool:
        """CylinderMapManager::InLoopClosureRegion
        (cylinderMapManager.cpp:114-158) over the host xyz mirror: within
        lc_max_dist of a pose at least lc_min_poses_old_region older."""
        cfg = self.cfg
        n = len(self._xyz_hist)
        if n < cfg.lc_min_poses_old_region:
            return False
        xyz = np.asarray(self._xyz_hist[:n])
        q = _np(pose)[4:7]
        dxy = np.linalg.norm(xyz[:, :2] - q[:2], axis=1)
        dz = np.abs(xyz[:, 2] - q[2])
        old = (n - 1) - np.arange(n) > cfg.lc_min_poses_old_region
        return bool(np.any((dxy <= cfg.lc_max_dist_xy)
                           & (dz <= cfg.lc_max_dist_z) & old))

    @staticmethod
    def packet_measurement_rows(p: PoseMstPair) -> np.ndarray:
        """prepareLCInput on a packet's body-frame measurements."""
        rows = []
        if len(p.cyl_radius):
            rows.append(np.concatenate([
                p.cyl_label[:, None].astype(np.float32), p.cyl_root,
                p.cyl_radius[:, None],
                np.zeros((len(p.cyl_radius), 2), np.float32)], axis=1))
        if len(p.cub_label):
            rows.append(np.concatenate([
                p.cub_label[:, None].astype(np.float32), p.cub_pose[:, 4:7],
                p.cub_scale], axis=1))
        if len(p.ell_label):
            rows.append(np.concatenate([
                p.ell_label[:, None].astype(np.float32), p.ell_pose[:, 4:7],
                p.ell_scale], axis=1))
        if not rows:
            return np.zeros((0, 7), np.float32)
        return np.concatenate(rows, axis=0)

    def _intra_gate(self, now: Optional[float] = None) -> Optional[int]:
        """Attempt gates (sloamNode.cpp:355-385); returns the query pose
        index when an attempt should run. Attempts retry every thread tick
        while in region; only a success arms the 1/frequency cool-down."""
        cfg = self.cfg
        if not self.is_in_lc_region:
            return None
        if now is not None:
            cooldown = 1.0 / cfg.intra_robot_place_recognition_frequency
            if now - self.last_intra_success_stamp < cooldown:
                return None
        latest = len(self.key_poses) - 1
        if latest < cfg.lc_min_pose_idx or latest == self.last_intra_attempt_pose:
            return None
        return latest

    @staticmethod
    def _candidate_from_chain(cfg, chain_xyz: np.ndarray,
                              pose_idx: int) -> Optional[int]:
        """getLoopCandidateIdx (cylinderMapManager.cpp:160-184): nearest pose
        within lc_candidate_max_dist that is old enough."""
        n = len(chain_xyz)
        if n < 50:
            return None
        d = np.linalg.norm(chain_xyz - chain_xyz[pose_idx], axis=1)
        eligible = ((d <= cfg.lc_candidate_max_dist)
                    & (pose_idx - np.arange(n) > cfg.lc_candidate_min_poses_old))
        if not np.any(eligible):
            return None
        d = np.where(eligible, d, np.inf)
        return int(np.argmin(d))

    @staticmethod
    def _submap_from_rows(rows: np.ndarray, center_xyz: np.ndarray,
                          radius: float) -> np.ndarray:
        """getkeyPoseSubmap over fetched compact rows (sloamNode.cpp:420-437
        + the 1.5 m z gate, cylinderMapManager.cpp:186-211)."""
        if len(rows) == 0:
            return rows
        d = np.linalg.norm(rows[:, 1:4] - center_xyz[None, :], axis=1)
        keep = (d <= radius) & (np.abs(rows[:, 3] - center_xyz[2]) < 1.5)
        return rows[keep]

    def _intra_search(self, latest: int, poses_snap: torch.Tensor,
                      rows_dev: torch.Tensor, packet,
                      stamp: Optional[float] = None):
        """Worker body of one intra-LC attempt, the `closure.search` span:
        fetch the optimized chain and compact map, candidate search,
        SlideMatch. Returns (cand, latest, rel7, chain, fit) or None."""
        with phase("closure.search", key=self._key(stamp),
                   kind="slidematch_intra", peers=[self.robot_id]) as span:
            res = self._intra_search_body(latest, poses_snap, rows_dev,
                                          packet)
            span.set(found=int(res is not None))
        return res

    def _intra_search_body(self, latest, poses_snap, rows_dev, packet):
        t0 = time.perf_counter()
        cfg = self.cfg
        base = self.robot_id * cfg.capacity.max_poses_per_robot
        chain = to_host(poses_snap, "intra_chain")[base:base + latest + 1]
        cand = self._candidate_from_chain(cfg, chain[:, 4:7], latest)
        if cand is None:
            self.intra_lc_time.append(time.perf_counter() - t0)
            return None
        rows = _filter_compact_rows(rows_dev)
        cand_pose = chain[cand]
        submap = self._submap_from_rows(rows, cand_pose[4:7],
                                        cfg.lc_submap_radius)
        meas = self.packet_measurement_rows(packet)
        found, tf_q2c, fit = self.place_recognition.find_intra_loop_closure(
            meas, submap, chain[latest], cand_pose)
        self.intra_lc_time.append(time.perf_counter() - t0)
        if not found:
            return None
        return cand, latest, se3np.from_matrix(tf_q2c), chain, fit

    def _apply_intra_result(self, res) -> bool:
        """Main-thread application of a completed intra-LC search: fit and
        consistency gates, closure factor, thorough solve."""
        if res is None:
            return False
        cand, latest, rel, chain, (n_fit, fit_rms) = res
        # an aliased alignment's per-pair residual approaches the threshold
        if fit_rms > 1.5 * self.cfg.place_recognition.match_threshold_position:
            return False
        gate = self.cfg.intra_closure_max_correction
        if gate > 0 and latest < len(self.key_poses):
            # a true closure corrects by at most the accumulated drift
            expected = se3np.between(self.key_poses[cand],
                                     self.key_poses[latest])
            corr = float(np.linalg.norm(
                np.asarray(expected)[4:7] - np.asarray(rel)[4:7]))
            if corr > gate:
                return False
        self.num_success_intra += 1
        if self._last_intra_attempt_stamp is not None:
            self.last_intra_success_stamp = self._last_intra_attempt_stamp
        # closure sigma floored at the fit's standard error (the JAX
        # package's documented deviation, PARITY.md #6)
        sigma = np.maximum(self._closure_sigma,
                           np.float32(fit_rms / max(np.sqrt(n_fit), 1.0)))
        self.add_loop_closure_factor(cand, self.robot_id, latest,
                                     self.robot_id, rel, sigma=sigma)
        self.state = engine.solve_full(self.cfg, self.state)
        self.request_pose_refresh()
        return True

    def apply_closure(self, kind: str, res, stamp: Optional[float] = None):
        """Apply one finished search on the main thread, as the
        `closure.apply` span: `kind` "intra" (returns whether the closure
        was added) or "inter" (returns the peers merged)."""
        with phase("closure.apply", key=self._key(stamp), kind=kind) as span:
            if kind == "intra":
                out = self._apply_intra_result(res)
                merged = int(out)
            else:
                out = self._apply_inter_result(res)
                merged = len(out)
            span.set(merged=merged)
        return out

    def submit_intra_loop_closure(self, now: Optional[float] = None
                                  ) -> Optional[Future]:
        """Async intra-LC attempt: gate and snapshot on the main thread,
        search on a worker (the reference's intraLoopClosureThread_)."""
        latest = self._intra_gate(now)
        if latest is None:
            return None
        self.num_attempts_intra += 1
        self.last_intra_attempt_pose = latest
        self._last_intra_attempt_stamp = now
        poses_snap = self._snapshot_poses()
        rows_dev = engine.compact_map_rows(self.cfg, self.state, 1)
        packet = self.dbm.host_record().packets[latest]
        return self.pool.submit(self._intra_search, latest, poses_snap,
                                rows_dev, packet, now)

    def attempt_intra_loop_closure(self, now: Optional[float] = None) -> bool:
        """intraLoopClosureThread_ body (sloamNode.cpp:355-486), synchronous
        form."""
        with phase("intra_lc"):
            latest = self._intra_gate(now)
            if latest is None:
                return False
            self.num_attempts_intra += 1
            self.last_intra_attempt_pose = latest
            self._last_intra_attempt_stamp = now
            # the candidate search runs over optimized keyposes
            self.refresh_poses()
            poses_snap = self._snapshot_poses()
            rows_dev = engine.compact_map_rows(self.cfg, self.state, 1)
            packet = self.dbm.host_record().packets[latest]
            res = self._intra_search(latest, poses_snap, rows_dev, packet,
                                     now)
            if res is None:
                return False
            ok = self.apply_closure("intra", res, now)
            if ok:
                self.refresh_poses()
            return ok

    def refresh_robot_map(self):
        """Push the current compact map into the database (lazily: before
        comm broadcasts and place-recognition attempts)."""
        if self._map_dirty:
            with phase("compact_map"):
                self.dbm.update_robot_map(self.compact_map())
            self._map_dirty = False

    def request_map_refresh(self):
        """Async refresh_robot_map: compute the compact rows on the device
        now, fetch and filter them on a worker."""
        if self.pool is None:
            self.refresh_robot_map()
            return
        if not self._map_dirty or self._map_future is not None:
            return
        rows_dev = engine.compact_map_rows(self.cfg, self.state,
                                           self.cfg.min_landmark_hits)
        self._map_future = self.pool.submit(_filter_compact_rows, rows_dev)
        self._map_dirty = False

    def collect_map_refresh(self, block: bool = True) -> bool:
        with self._map_lock:
            fut = self._map_future
            if fut is None:
                return False
            if not block and not fut.done():
                return False
            self._map_future = None
        t0 = time.perf_counter()
        rows = fut.result()
        phase_add("compact_map_wait", time.perf_counter() - t0)
        self.dbm.update_robot_map(rows)
        return True

    def _inter_peers(self) -> List[int]:
        return [rid for rid in self.dbm.records
                if rid != self.robot_id and rid not in self.dbm.loop_closure_tf]

    def _inter_search(self, peers: List[int], peer_maps: Dict[int, np.ndarray],
                      ref_map: np.ndarray, stamp: Optional[float] = None
                      ) -> Dict[int, np.ndarray]:
        """Worker body, the `closure.search` span: SlideMatch/SlideGraph
        each unmatched peer's compact map against ours; returns
        {peer: tf7}."""
        kind = "slidematch_inter" if self.cfg.use_slidematch else "slidegraph"
        with phase("closure.search", key=self._key(stamp), kind=kind,
                   peers=list(peers)) as span:
            found = (self._inter_search_body(peers, peer_maps, ref_map)
                     if len(ref_map) else {})
            span.set(found=len(found))
        return found

    def _inter_search_body(self, peers, peer_maps, ref_map):
        cfg = self.cfg
        found: Dict[int, np.ndarray] = {}
        for rid in peers:
            qry_map = peer_maps[rid]
            if len(qry_map) == 0:
                continue
            t0 = time.perf_counter()
            if cfg.use_slidematch:
                ok, tf = self.place_recognition.find_inter_loop_closure(
                    ref_map, qry_map)
            else:
                ok, tf = self.slidegraph.find_inter_loop_closure(
                    ref_map, qry_map)
            self.inter_lc_time.append(time.perf_counter() - t0)
            if ok:
                found[rid] = se3np.from_matrix(tf)
        return found

    def _tf_consistent(self, a: np.ndarray, b: np.ndarray) -> bool:
        """Two tf7 estimates agree within the confirmation tolerances."""
        d = se3np.between(a, b)
        if np.linalg.norm(d[4:7]) > self.cfg.inter_tf_confirm_pos:
            return False
        yaw = abs(np.arctan2(2 * (d[0] * d[3] + d[1] * d[2]),
                             1 - 2 * (d[2] ** 2 + d[3] ** 2)))
        return yaw <= np.deg2rad(self.cfg.inter_tf_confirm_yaw_deg)

    def _apply_inter_result(self, found: Dict[int, np.ndarray]) -> List[int]:
        """Accept discovered TFs once re-detected consistently
        (SlamConfig.inter_tf_confirmations), after an ICP polish."""
        ids = []
        need = self.cfg.inter_tf_confirmations
        for rid, tf in found.items():
            if rid in self.dbm.loop_closure_tf:
                continue
            if need > 1:
                pend = self._pending_inter_tf.get(rid)
                if pend is None or not self._tf_consistent(pend[0], tf):
                    self._pending_inter_tf[rid] = (tf, 1)
                    continue
                if pend[1] + 1 < need:
                    self._pending_inter_tf[rid] = (tf, pend[1] + 1)
                    continue
                self._pending_inter_tf.pop(rid, None)
            tf = self._refine_inter_tf(rid, tf)
            self.num_success_inter += 1
            self.dbm.loop_closure_tf[rid] = tf
            ids.append(rid)
        return ids

    def _refine_inter_tf(self, rid: int, tf7: np.ndarray) -> np.ndarray:
        """Map-to-map ICP polish of an accepted merge TF (a few rounds of
        re-match + LSQ re-fit on the whole compact maps), the
        `closure.polish` span."""
        with phase("closure.polish", peer=int(rid)):
            own = self.dbm.get_robot_map(self.robot_id)
            peer = self.dbm.get_robot_map(rid)
            if len(own) < 5 or len(peer) < 5:
                return tf7
            tf_ref, n_fit, _rms = _icp_refine(
                se3np.matrix(np.asarray(tf7, np.float32)), own, peer,
                self.cfg.place_recognition, iters=4)
            if n_fit < 5:
                return tf7
            return se3np.from_matrix(tf_ref)

    def submit_inter_loop_closure(self, stamp: Optional[float] = None
                                  ) -> Optional[Future]:
        """Async inter-LC attempt (the reference's interLoopClosureThread_).
        The own-map fetch rides inside the same worker job; peer maps are
        captured by reference (immutable arrays). `stamp` keys its span."""
        peers = self._inter_peers()
        if not peers:
            return None
        self.num_attempts_inter += 1
        rows_dev = None
        if self._map_dirty:
            rows_dev = engine.compact_map_rows(self.cfg, self.state,
                                               self.cfg.min_landmark_hits)
            self._map_dirty = False
        peer_maps = {rid: self.dbm.get_robot_map(rid) for rid in peers}

        def job():
            if rows_dev is not None:
                self.dbm.update_robot_map(_filter_compact_rows(rows_dev))
            return self._inter_search(peers, peer_maps,
                                      self.dbm.get_robot_map(self.robot_id),
                                      stamp)

        return self.pool.submit(job)

    def attempt_inter_loop_closure(self, stamp: Optional[float] = None
                                   ) -> List[int]:
        """interLoopClosureThread_ body (sloamNode.cpp:578-697), synchronous
        form. Returns ids of peers whose TF was accepted this attempt."""
        with phase("inter_lc"):
            peers = self._inter_peers()
            if not peers:
                return []
            with phase("inter_map_refresh"):
                self.refresh_robot_map()
            self.num_attempts_inter += 1
            ref_map = self.dbm.get_robot_map(self.robot_id)
            if len(ref_map) == 0:
                return []
            with phase("inter_search"):
                found = self._inter_search(
                    peers, ref_map=ref_map,
                    peer_maps={rid: self.dbm.get_robot_map(rid)
                               for rid in peers}, stamp=stamp)
            return self.apply_closure("inter", found, stamp)

    def add_loop_closure_factor(self, prev_idx: int, robot1: int,
                                cur_idx: int, robot2: int, rel: np.ndarray,
                                sigma: Optional[np.ndarray] = None):
        P = self.cfg.capacity.max_poses_per_robot
        if sigma is None:
            sigma = self._closure_sigma
        self.state = engine.add_between_factor(
            self.cfg, self.state, robot1 * P + prev_idx, robot2 * P + cur_idx,
            self._tensor(rel), self._tensor(sigma))

    # ------------------------------------------------------------------
    # Relative inter-robot measurements (sloamNode.cpp:707-760)
    # ------------------------------------------------------------------
    def add_relative_measurement(self, meas: scheduler.RelativeMeas):
        self.feasible_relative_meas.append(meas)

    def process_relative_factors(self) -> int:
        with phase("rel_factors"):
            return self._process_relative_factors()

    def _process_relative_factors(self) -> int:
        if not self.feasible_relative_meas:
            return 0
        # host mirror of per-robot pose counts: own = keyframes integrated,
        # peers = packets folded by replay (zero until their TF is known)
        pose_counter = [len(self.key_poses) if r == self.robot_id
                        else self._peer_pose_count.get(r, 0)
                        for r in range(self.cfg.number_of_robots)]
        matches = scheduler.find_relative_measurement_matches(
            self.feasible_relative_meas, pose_counter,
            self.dbm.stamps_by_robot(), self.robot_id)
        P = self.cfg.capacity.max_poses_per_robot
        base = _np(self.cfg.noise.rel_meas)
        for m in matches:
            rel = _np(m.meas.relative_pose)
            dist = max(float(np.linalg.norm(rel[4:7])),
                       self.cfg.noise.noise_floor)
            self.state = engine.add_between_factor(
                self.cfg, self.state, self.robot_id * P + m.index_host,
                m.meas.robot_index * P + m.index_other, self._tensor(rel),
                self._tensor(base * dist))
        if matches:
            self.state = engine.solve_incremental(self.cfg, self.state)
            self.request_pose_refresh()
        self.num_rel_factors += len(matches)
        return len(matches)

    # ------------------------------------------------------------------
    def optimized_trajectory(self) -> np.ndarray:
        return self.trajectory_of(self.robot_id)

    def trajectory_of(self, robot_id: int) -> np.ndarray:
        n = int(self.state.pose_count[robot_id])
        base = robot_id * self.cfg.capacity.max_poses_per_robot
        return to_host(self.state.poses[base:base + n], "trajectory")

    def landmark_counts(self) -> Dict[str, int]:
        return {"cylinders": int(self.state.cyl_count),
                "cuboids": int(self.state.cub_count),
                "points": int(self.state.pt_count)}

    def overflow_report(self) -> Dict[str, int]:
        """Capacity-overflow counters (dropped appends) by family."""
        vals = to_host(self.state.overflow, "overflow")
        return {f"overflow_{name}": int(v)
                for name, v in zip(OVERFLOW_FIELDS, vals)}

    def compact_map(self, min_hits: Optional[int] = None) -> np.ndarray:
        """Rows [label, x, y, z, dim1, dim2, dim3] of the hit-gated map
        (databaseManager.cpp:64-96 with getFinalMap hit gating)."""
        if min_hits is None:
            min_hits = self.cfg.min_landmark_hits
        return _filter_compact_rows(
            engine.compact_map_rows(self.cfg, self.state, min_hits))

    def write_trajectory(self, path: str, robot_id: Optional[int] = None):
        """TUM-style `stamp x y z qx qy qz qw` (sloamNode.cpp:318-337)."""
        rid = self.robot_id if robot_id is None else robot_id
        traj = self.trajectory_of(rid)
        if rid == self.robot_id:
            stamps = self.key_stamps
        elif rid in self.dbm.records:
            stamps = [p.stamp for p in self.dbm.records[rid].packets]
        else:
            stamps = list(range(len(traj)))
        with open(path, "w") as f:
            for st, p in zip(stamps, traj):
                qw, qx, qy, qz, x, y, z = p
                f.write(f"{st} {x} {y} {z} {qx} {qy} {qz} {qw}\n")

    def write_runtime_analysis(self, path: str):
        """results/runtime_analysis schema (inputNode.cpp:232-317)."""
        def stats(xs):
            xs = np.asarray(xs or [0.0])
            return xs.mean(), xs.max()
        da_m, da_x = stats(self.data_association_time)
        fg_m, fg_x = stats(self.fg_time)
        il_m, il_x = stats(self.intra_lc_time)
        el_m, el_x = stats(self.inter_lc_time)
        with open(path, "w") as f:
            f.write(f"robot_id: {self.robot_id}\n")
            f.write(f"num_keyframes: {len(self.key_poses)}\n")
            f.write(f"avg_data_association_time: {da_m:.6f} max: {da_x:.6f}\n")
            f.write(f"avg_factor_graph_time: {fg_m:.6f} max: {fg_x:.6f}\n")
            f.write(f"avg_intra_loop_closure_time: {il_m:.6f} max: {il_x:.6f}\n")
            f.write(f"intra_loop_closure_attempts: {self.num_attempts_intra} "
                    f"successes: {self.num_success_intra}\n")
            f.write(f"avg_inter_loop_closure_time: {el_m:.6f} max: {el_x:.6f}\n")
            f.write(f"inter_loop_closure_attempts: {self.num_attempts_inter} "
                    f"successes: {self.num_success_inter}\n")
            f.write(f"num_relative_factors: {self.num_rel_factors}\n")
            for k, v in self.dbm.comm_stats().items():
                f.write(f"{k}: {v:.6f}\n")
            for k, v in self.overflow_report().items():
                f.write(f"{k}: {v}\n")

"""Host-side per-robot SLAM node, single-robot slice (PyTorch twin of
slide_slam_tpu/runtime/node.py).

A thin host loop that packs each keyframe's measurements into one [S, 33]
tensor, drives `engine.keyframe_step_fused` on the device, queues the
periodic thorough solve and keeps the host mirrors (key poses, stamps,
packets). The place-recognition, merge, replay and relative-factor paths
wait for the multi-robot slice; with one robot there are no peers to
replay.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..comm.database import PoseMstPair, packet_from_obs
from ..config import SlamConfig
from ..factorgraph.graph import OVERFLOW_FIELDS, GraphState, empty_state
from ..geometry import se3np
from . import engine


def _np(x):
    return np.asarray(x, np.float32)


class SlamNode:
    """One robot's backend: device GraphState + host mirrors."""

    def __init__(self, cfg: SlamConfig, robot_id: int = 0, device="cuda"):
        self.cfg = cfg
        self.robot_id = robot_id
        self.device = torch.device(device)
        self.state: GraphState = empty_state(cfg, device=self.device)
        self.packets: List[PoseMstPair] = []
        self.key_poses: List[np.ndarray] = []   # host pose mirror (np [7])
        self.key_stamps: List[float] = []
        self.latest_odom: Optional[np.ndarray] = None
        self.is_in_lc_region = False
        # host xyz mirror, re-synced from the device every
        # `pose_refresh_every` keyframes (one transfer of the pose array)
        self._xyz_hist: List[np.ndarray] = []
        self.pose_refresh_every = 16
        self._kf_since_refresh = 0
        self.fg_time: List[float] = []
        self.last_step: Optional[engine.StepOutput] = None
        self._noise_odom = torch.as_tensor(_np(cfg.noise.odom),
                                           device=self.device)
        self._noise_cube = torch.as_tensor(_np(cfg.noise.cube),
                                           device=self.device)
        self._kf_since_full_solve = 0

    # ------------------------------------------------------------------
    def _pack_obs(self, p: PoseMstPair) -> np.ndarray:
        """One [S, 33] f32 scan array (see engine.unpack_scan layout)."""
        S = self.cfg.capacity.max_scan_objects
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
        return out

    def prev_key_pose(self) -> np.ndarray:
        if not self.key_poses:
            return se3np.identity()
        return self.key_poses[-1]

    def refresh_poses(self):
        """Pull the optimized pose chain from the device in one transfer and
        rebase the host mirrors onto it."""
        n = len(self.key_poses)
        if n == 0:
            return
        base = self.robot_id * self.cfg.capacity.max_poses_per_robot
        chain = self.state.poses[base:base + n].cpu().numpy()
        for i in range(n):
            self.key_poses[i] = chain[i]
            self._xyz_hist[i] = chain[i, 4:7]
        self._kf_since_refresh = 0

    def _maybe_refresh_poses(self):
        self._kf_since_refresh += 1
        if self._kf_since_refresh >= self.pose_refresh_every:
            self.refresh_poses()

    def _maybe_full_solve(self, k: int = 1):
        """The periodic thorough solve every `full_solve_every` keyframes."""
        every = self.cfg.solver.full_solve_every
        if not every:
            return
        self._kf_since_full_solve += k
        if self._kf_since_full_solve >= every:
            self._kf_since_full_solve = 0
            self.state = engine.solve_full(self.cfg, self.state)

    # ------------------------------------------------------------------
    def process_keyframe(self, stamp: float, odom_pose: np.ndarray,
                         obs: dict) -> np.ndarray:
        """Integrate one keyframe; returns the host pose estimate.

        odom_pose: raw odometry pose synced with the observation."""
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

        packet = packet_from_obs(stamp, pose_est, rel, obs)
        self.packets.append(packet)
        self._fused_step(odom_pose, rel, packet, drop=self.is_in_lc_region)
        self.key_poses.append(pose_est)
        self._xyz_hist.append(pose_est[4:7])
        self.key_stamps.append(float(stamp))
        self.latest_odom = odom_pose
        self._maybe_full_solve()
        self._maybe_refresh_poses()
        return self.key_poses[-1]

    def _fused_step(self, odom_pose, rel, packet: PoseMstPair, drop: bool):
        """One device step (DA + insert + solve); nothing is read back."""
        packed = torch.as_tensor(self._pack_obs(packet), device=self.device)
        odom_and_rel = torch.as_tensor(
            np.stack([_np(odom_pose), _np(rel)]), device=self.device)
        sc = self.cfg.solver
        budget = (sc.incremental_outer_iterations,
                  sc.incremental_pcg_iterations,
                  float(np.float32(sc.incremental_pcg_tol)))
        t0 = time.perf_counter()
        self.state, self.last_step = engine.keyframe_step_fused(
            self.cfg, self.state, self.robot_id, odom_and_rel, packed,
            drop, budget, self._noise_odom, self._noise_cube)
        self.fg_time.append(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def in_loop_closure_region(self, pose: np.ndarray) -> bool:
        """Within lc_max_dist of a pose at least lc_min_poses_old_region
        keyframes older (host xyz mirror)."""
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

    # ------------------------------------------------------------------
    def optimized_trajectory(self) -> np.ndarray:
        return self.trajectory_of(self.robot_id)

    def trajectory_of(self, robot_id: int) -> np.ndarray:
        n = int(self.state.pose_count[robot_id])
        base = robot_id * self.cfg.capacity.max_poses_per_robot
        return self.state.poses[base:base + n].cpu().numpy()

    def landmark_counts(self) -> Dict[str, int]:
        return {"cylinders": int(self.state.cyl_count),
                "cuboids": int(self.state.cub_count),
                "points": int(self.state.pt_count)}

    def overflow_report(self) -> Dict[str, int]:
        """Capacity-overflow counters (dropped appends) by family."""
        vals = self.state.overflow.cpu().numpy()
        return {f"overflow_{name}": int(v)
                for name, v in zip(OVERFLOW_FIELDS, vals)}

    def compact_map(self, min_hits: Optional[int] = None) -> np.ndarray:
        """Rows [label, x, y, z, dim1, dim2, dim3] of the hit-gated map."""
        if min_hits is None:
            min_hits = self.cfg.min_landmark_hits
        rows = engine.compact_map_rows(self.cfg, self.state,
                                       min_hits).cpu().numpy()
        return np.ascontiguousarray(rows[rows[:, 7] > 0.5, :7], np.float32)

    def write_trajectory(self, path: str):
        """TUM-style `stamp x y z qx qy qz qw`."""
        traj = self.optimized_trajectory()
        with open(path, "w") as f:
            for st, p in zip(self.key_stamps, traj):
                qw, qx, qy, qz, x, y, z = p
                f.write(f"{st} {x} {y} {z} {qx} {qy} {qz} {qw}\n")

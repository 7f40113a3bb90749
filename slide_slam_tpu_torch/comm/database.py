"""Inter-robot database and communication protocol (copy of
slide_slam_tpu/comm/database.py; host-side numpy, no tensors).

Per-robot packet deques with factor-graph bookmarks, compact Vector7d
object maps, the loop-closure TF table with transitive gossip, the
full-database rebroadcast on a throttled cadence, and the byte-constant
communication accounting of the reference (databaseManager.cpp:194-208).
The payload layout mirrors PoseMstBundle.msg.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..geometry import se3np as se3


@dataclass
class PoseMstPair:
    """One keyframe packet (== sloam_msgs/PoseMst): key pose estimate at
    insertion time, raw relative odometry, stamp, body-frame measurements."""
    stamp: float
    key_pose: np.ndarray            # [7]
    rel_odom: np.ndarray            # [7]
    cyl_root: np.ndarray
    cyl_ray: np.ndarray
    cyl_radius: np.ndarray
    cyl_label: np.ndarray
    cub_pose: np.ndarray
    cub_scale: np.ndarray
    cub_label: np.ndarray
    ell_pose: np.ndarray
    ell_scale: np.ndarray
    ell_label: np.ndarray


def packet_from_obs(stamp, key_pose, rel_odom, obs: dict) -> PoseMstPair:
    return PoseMstPair(
        stamp=float(stamp), key_pose=np.asarray(key_pose, np.float32),
        rel_odom=np.asarray(rel_odom, np.float32),
        cyl_root=np.asarray(obs.get("cyl_root", np.zeros((0, 3))), np.float32),
        cyl_ray=np.asarray(obs.get("cyl_ray", np.zeros((0, 3))), np.float32),
        cyl_radius=np.asarray(obs.get("cyl_radius", np.zeros((0,))), np.float32),
        cyl_label=np.asarray(obs.get("cyl_label", np.zeros((0,))), np.int32),
        cub_pose=np.asarray(obs.get("cub_pose", np.zeros((0, 7))), np.float32),
        cub_scale=np.asarray(obs.get("cub_scale", np.zeros((0, 3))), np.float32),
        cub_label=np.asarray(obs.get("cub_label", np.zeros((0,))), np.int32),
        ell_pose=np.asarray(obs.get("ell_pose", np.zeros((0, 7))), np.float32),
        ell_scale=np.asarray(obs.get("ell_scale", np.zeros((0, 3))), np.float32),
        ell_label=np.asarray(obs.get("ell_label", np.zeros((0,))), np.int32),
    )


# byte-constant message-size model (databaseManager.cpp:194-208,
# PoseMst.msg:1-6)
BYTES_POSE = 56
BYTES_REL_ODOM = 56
BYTES_STAMP = 8
BYTES_CYLINDER = 37
BYTES_CUBE = 69
BYTES_ELLIPSOID = 69
BYTES_TF = 58
BYTES_MAP_ROW = 32


@dataclass
class RobotRecord:
    packets: List[PoseMstPair] = field(default_factory=list)
    bookmark_fg: int = 0


@dataclass
class Bundle:
    """One broadcast message (== sloam_msgs/PoseMstBundle)."""
    robot_id: int
    packets: List[PoseMstPair]
    compact_map: np.ndarray                  # [N, 7]
    inter_robot_tfs: List[tuple]             # (host_id, target_id, tf7)


def _packet_bytes(p: PoseMstPair) -> float:
    return (BYTES_POSE + BYTES_REL_ODOM + BYTES_STAMP
            + BYTES_CYLINDER * len(p.cyl_radius)
            + BYTES_CUBE * len(p.cub_label)
            + BYTES_ELLIPSOID * len(p.ell_label))


class DatabaseManager:
    def __init__(self, host_robot_id: int, num_robots: int,
                 communication_wait_time: float = 5.0,
                 prior_tf_known: bool = False,
                 prior_tf_xyz: Optional[np.ndarray] = None):
        self.host_robot_id = host_robot_id
        self.num_robots = num_robots
        self.comm_wait_time = communication_wait_time
        self.records: Dict[int, RobotRecord] = {host_robot_id: RobotRecord()}
        self.maps: Dict[int, np.ndarray] = {}
        # peer robot id -> SE3 [7] mapping peer map frame into host map frame
        self.loop_closure_tf: Dict[int, np.ndarray] = {}
        self.last_comm_time = -np.inf
        self.published_mb: List[float] = []
        self.received_mb: List[float] = []
        if prior_tf_known:
            # databaseManager.cpp:22-45: world frame = robot0 frame; each
            # robot knows its own offset, so tfWorld2Robot applies to all
            xyz = np.zeros(3) if prior_tf_xyz is None else np.asarray(prior_tf_xyz)
            prior = np.asarray(se3.from_xyz_yaw(*xyz, 0.0), np.float32)
            tf_world2robot = np.asarray(se3.inverse(prior), np.float32)
            for i in range(num_robots):
                self.loop_closure_tf[i] = tf_world2robot

    # ------------------------------------------------------------------
    def host_record(self) -> RobotRecord:
        return self.records[self.host_robot_id]

    def update_robot_map(self, compact_map: np.ndarray,
                         robot_id: Optional[int] = None):
        self.maps[self.host_robot_id if robot_id is None else robot_id] = \
            np.asarray(compact_map, np.float32)

    def get_robot_map(self, robot_id: int) -> np.ndarray:
        return self.maps.get(robot_id, np.zeros((0, 7), np.float32))

    # ------------------------------------------------------------------
    def should_communicate(self, now: float) -> bool:
        return (now - self.last_comm_time) > self.comm_wait_time

    def make_bundles(self, now: float) -> List[Bundle]:
        """Full-database rebroadcast (databaseManager.cpp:219-279): one
        bundle per known robot, with the host's TF table attached."""
        self.last_comm_time = now
        tfs = [(self.host_robot_id, target, tf)
               for target, tf in self.loop_closure_tf.items()]
        bundles = []
        nbytes = 0.0
        for rid, rec in self.records.items():
            b = Bundle(robot_id=rid, packets=list(rec.packets),
                       compact_map=self.get_robot_map(rid),
                       inter_robot_tfs=tfs)
            bundles.append(b)
            nbytes += sum(_packet_bytes(p) for p in rec.packets)
            nbytes += BYTES_MAP_ROW * len(b.compact_map)
            nbytes += BYTES_TF * len(tfs)
        self.published_mb.append(nbytes / 1e6)
        return bundles

    def ingest_bundle(self, bundle: Bundle):
        """databaseManager::poseMstCb_ (:98-192): tail-append by length diff,
        map refresh, TF gossip with transitive closure."""
        rid = bundle.robot_id
        if rid not in self.records:
            self.records[rid] = RobotRecord()
        pool = self.records[rid].packets
        if len(bundle.packets) <= len(pool) or rid == self.host_robot_id:
            return
        pool.extend(bundle.packets[len(pool):])
        self.maps[rid] = np.asarray(bundle.compact_map, np.float32)

        for (src_host, src_target, tf7) in bundle.inter_robot_tfs:
            tf = np.asarray(tf7, np.float32)
            if src_target == self.host_robot_id:
                # sender knows target->sender; we are the target, so the
                # sender's frame maps into ours via the inverse
                # (databaseManager.cpp:160-166)
                if src_host != self.host_robot_id:
                    self.loop_closure_tf[src_host] = np.asarray(
                        se3.inverse(tf), np.float32)
            else:
                a, b = src_host, src_target
                a_known = a in self.loop_closure_tf or a == self.host_robot_id
                b_known = b in self.loop_closure_tf or b == self.host_robot_id
                if not a_known and b_known:
                    tf_a2b = np.asarray(se3.inverse(tf), np.float32)
                    self.loop_closure_tf[a] = np.asarray(se3.compose(
                        self._tf_to_host(b), tf_a2b), np.float32)
                elif a_known and not b_known:
                    self.loop_closure_tf[b] = np.asarray(se3.compose(
                        self._tf_to_host(a), tf), np.float32)

        # the reference counts the TF table once per PACKET (not once per
        # bundle) on receipt; kept as it is
        nbytes = 1.0
        for p in bundle.packets:
            nbytes += _packet_bytes(p)
            nbytes += BYTES_TF * len(bundle.inter_robot_tfs)
        nbytes += BYTES_MAP_ROW * len(bundle.compact_map)
        self.received_mb.append(nbytes / 1e6)

    def _tf_to_host(self, rid: int) -> np.ndarray:
        if rid == self.host_robot_id:
            return np.asarray(se3.identity(), np.float32)
        return self.loop_closure_tf[rid]

    # ------------------------------------------------------------------
    def stamps_by_robot(self) -> Dict[int, List[float]]:
        return {rid: [p.stamp for p in rec.packets]
                for rid, rec in self.records.items()}

    def comm_stats(self) -> Dict[str, float]:
        pub = np.asarray(self.published_mb or [0.0])
        rec = np.asarray(self.received_mb or [0.0])
        return {
            "total_published_MB": float(pub.sum()),
            "avg_published_MB": float(pub.mean()),
            "max_published_MB": float(pub.max()),
            "total_received_MB": float(rec.sum()),
            "avg_received_MB": float(rec.mean()),
            "max_received_MB": float(rec.max()),
        }

"""Input manager: the per-robot main loop (PyTorch-port copy of
slide_slam_tpu/runtime/input_manager.py; host-side, no tensors).

Re-expression of InputManager::RunInputNode + Robot's subscriber queues
(inputNode.cpp:38-192, robot.cpp:63-175) without ROS timers: callers feed
raw odometry / observations / relative measurements through `on_*` methods
(the subscriber surface), and `tick(now)` runs one main-loop iteration —
publish the high-frequency drift-compensated pose, then drain the
measurement queues through the scheduler discipline into the SLAM node.

Queue backend: the pure-python scheduler (runtime/scheduler.py). The JAX
package's C++ queue core (native.py, `use_native=True`) is not ported yet:
asking for it raises.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SlamConfig
from ..geometry import se3np
from . import scheduler as sch
from .node import SlamNode


@dataclass
class HighFreqPose:
    stamp: float
    pose: np.ndarray             # drift-compensated SLAM-frame pose
    vio_pose: np.ndarray         # raw odometry
    slam_to_vio: np.ndarray      # drift compensation TF (inputNode.cpp:206-209)


class InputManager:
    def __init__(self, cfg: SlamConfig, node: SlamNode,
                 use_native: bool = False):
        self.cfg = cfg
        self.node = node
        self._odom_counter = 0
        if use_native:
            raise NotImplementedError(
                "the native C++ queue core is not ported yet (ROADMAP: "
                "queue item 'checkpoint, elastic mission and native queues')")
        self.odom_queue = deque()
        self.obs_queue = deque()
        self.rel_queue = deque()
        self.latest_odom: Optional[sch.StampedPose] = None
        self.high_freq_log = []

    # ------------------------------------------------------------------
    # Subscriber surface (robot.cpp:63-175)
    # ------------------------------------------------------------------
    def on_odometry(self, stamp: float, pose: np.ndarray):
        """Downsample 1/odom_freq_filter + min-altitude gate
        (robot.cpp:63-99)."""
        self._odom_counter += 1
        if self._odom_counter % self.cfg.odom_freq_filter != 0:
            return
        if pose[6] < self.cfg.min_robot_altitude:
            return
        self.odom_queue.append(sch.StampedPose(stamp=stamp, pose=pose))
        while len(self.odom_queue) > self.cfg.max_queue_size * 10:
            self.odom_queue.popleft()

    def on_observation(self, stamp: float, odom_pose: np.ndarray, obs: dict):
        """Synced semantic measurement (robot.cpp:101-140)."""
        self.obs_queue.append(sch.Observation(
            stamped_pose=sch.StampedPose(stamp=stamp, pose=odom_pose),
            obs=obs))
        while len(self.obs_queue) > self.cfg.max_queue_size:
            self.obs_queue.popleft()

    def on_relative_measurement(self, meas: sch.RelativeMeas):
        """robot.cpp:148-175: observed robots enqueue with only_use_odom."""
        self.rel_queue.append(meas)

    # ------------------------------------------------------------------
    def high_freq_pose(self, stamp: float, vio_pose: np.ndarray) -> HighFreqPose:
        """lastKeyPose o relOdom (inputNode.cpp:49-80) + sloam_to_vio TF."""
        if self.latest_odom is not None and self.node.key_poses:
            rel = se3np.between(self.latest_odom.pose, vio_pose)
            hf = se3np.compose(self.node.prev_key_pose(), rel)
        else:
            hf = np.asarray(vio_pose, np.float32)
        slam_to_vio = se3np.compose(vio_pose, se3np.inverse(hf))
        out = HighFreqPose(stamp=stamp, pose=hf, vio_pose=vio_pose,
                           slam_to_vio=slam_to_vio)
        self.high_freq_log.append(out)
        return out

    # ------------------------------------------------------------------
    def tick(self, now: float) -> int:
        """One main-loop iteration (inputNode.cpp:88-186). Returns the
        number of keyframes integrated."""
        cfg = self.cfg
        n_done = 0
        while True:
            kind = sch.pick_next_measurement(
                self.odom_queue, self.obs_queue, self.rel_queue,
                self.latest_odom, now, cfg.msg_delay_tolerance,
                cfg.min_odom_distance)
            if kind == sch.MEAS_NONE:
                break
            if kind == sch.MEAS_ODOM:
                sp = self.odom_queue.popleft()
                self.node.process_keyframe(sp.stamp, sp.pose, {})
                self._set_latest(sp)
            elif kind == sch.MEAS_OBSERVATION:
                ob = self.obs_queue.popleft()
                self.node.process_keyframe(ob.stamped_pose.stamp,
                                           ob.stamped_pose.pose, ob.obs)
                self._set_latest(ob.stamped_pose)
            elif kind == sch.MEAS_RELATIVE:
                meas = self.rel_queue.popleft()
                if not meas.only_use_odom:
                    self.node.add_relative_measurement(meas)
                # the synced odometry still produces a keyframe
                # (inputNode.cpp:126-149)
                self.node.process_keyframe(meas.stamp, meas.odom_pose, {})
                self._set_latest(sch.StampedPose(stamp=meas.stamp,
                                                 pose=meas.odom_pose))
            n_done += 1
        return n_done

    def _set_latest(self, sp: sch.StampedPose):
        self.latest_odom = sp

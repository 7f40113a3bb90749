"""Measurement queue discipline (copy of slide_slam_tpu/runtime/scheduler.py;
host-side numpy, no tensors).

Host-side re-implementation of the reference's scheduler semantics:

* `pick_next_measurement` == Input::PickNextMeasurementToAdd
  (input.cpp:26-109): pop stale entries, prefer the oldest sufficiently-aged
  {observation, relative measurement}, else odometry if the robot moved far
  enough. Returns 0 none / 1 odometry / 2 observation / 3 relative.
* `index_closest_stamp` == sloam::GetIndexClosestPoseMstPair
  (sloam.cpp:428-440).
* `find_relative_measurement_matches` == sloam::FindRelativeMeasurementMatch
  (sloam.cpp:321-412): match buffered robot-robot sightings to existing pose
  keys of both robots within 1 ms, prune infeasible ones.

These run on timestamps (f64) and tiny queues: host logic by design.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple
from collections import deque

import numpy as np

from ..geometry import se3np as se3

MEAS_NONE, MEAS_ODOM, MEAS_OBSERVATION, MEAS_RELATIVE = 0, 1, 2, 3
MAX_REL_MEAS_TIME_DIFF = 1e-3   # 1 ms (sloam.cpp:330)


@dataclass
class StampedPose:
    stamp: float
    pose: np.ndarray            # [7]


@dataclass
class Observation:
    stamped_pose: StampedPose
    obs: dict = field(default_factory=dict)


@dataclass
class RelativeMeas:
    stamp: float
    relative_pose: np.ndarray   # [7] observer -> observed
    robot_index: int            # the OTHER robot involved
    odom_pose: np.ndarray       # observer's synced odometry
    only_use_odom: bool = False # True on the observed robot (robot.cpp:148-175)


def _translation_norm(a: np.ndarray, b: np.ndarray) -> float:
    rel = se3.between(np.asarray(a), np.asarray(b))
    return float(np.linalg.norm(se3.trans(rel)))


def pick_next_measurement(
    odom_queue: Deque[StampedPose],
    observation_queue: Deque[Observation],
    relative_queue: Deque[RelativeMeas],
    latest_odom: Optional[StampedPose],
    current_time: float,
    msg_delay_tolerance: float,
    min_odom_distance: float,
) -> int:
    """input.cpp:26-109, queue-mutating exactly like the reference."""
    latest_stamp = latest_odom.stamp if latest_odom is not None else -np.inf

    while odom_queue and odom_queue[0].stamp < latest_stamp:
        odom_queue.popleft()
    while observation_queue and observation_queue[0].stamped_pose.stamp < latest_stamp:
        observation_queue.popleft()
    while relative_queue and relative_queue[0].stamp < latest_stamp:
        relative_queue.popleft()

    valid_obs = bool(observation_queue) and (
        current_time - observation_queue[0].stamped_pose.stamp) >= msg_delay_tolerance
    valid_rel = bool(relative_queue) and (
        current_time - relative_queue[0].stamp) >= msg_delay_tolerance

    if valid_obs and valid_rel:
        return (MEAS_OBSERVATION
                if observation_queue[0].stamped_pose.stamp < relative_queue[0].stamp
                else MEAS_RELATIVE)
    if valid_obs:
        return MEAS_OBSERVATION
    if valid_rel:
        return MEAS_RELATIVE

    # newest-first scan for an odometry entry that is old enough AND moved far
    # enough since the last factor (input.cpp:83-104)
    for i in range(len(odom_queue) - 1, -1, -1):
        if (current_time - odom_queue[i].stamp) >= msg_delay_tolerance:
            if latest_odom is not None:
                moved = _translation_norm(latest_odom.pose, odom_queue[i].pose)
            else:
                moved = np.inf
            if moved > min_odom_distance:
                for _ in range(i):
                    odom_queue.popleft()
                return MEAS_ODOM
            break
    return MEAS_NONE


def index_closest_stamp(stamps: List[float], stamp: float) -> Tuple[int, float]:
    """sloam.cpp:428-440: (-1, inf) if empty; first index on ties."""
    if not stamps:
        return -1, np.inf
    diffs = np.abs(np.asarray(stamps, np.float64) - stamp)
    idx = int(np.argmin(diffs))   # argmin returns first occurrence on ties
    return idx, float(diffs[idx])


@dataclass
class RelativeMeasMatch:
    meas: RelativeMeas
    index_host: int
    index_other: int


def find_relative_measurement_matches(
    feasible: List[RelativeMeas],
    pose_counter: List[int],
    stamps_by_robot: dict,
    host_robot_id: int,
) -> List[RelativeMeasMatch]:
    """sloam.cpp:321-412. Mutates `feasible` (consumes matched + prunes stale).

    stamps_by_robot: robot id -> list of packet stamps (the poseMstPacket
    deque timeline)."""
    matches: List[RelativeMeasMatch] = []
    host_stamps = stamps_by_robot.get(host_robot_id, [])

    i = 0
    while i < len(feasible):
        m = feasible[i]
        if m.robot_index == host_robot_id:
            raise ValueError("robotIndex should not be the same as hostRobotID")
        if m.only_use_odom:
            raise ValueError("onlyUseOdom measurements shouldn't get here")
        other_stamps = stamps_by_robot.get(m.robot_index, [])
        idx_other, dt_other = index_closest_stamp(other_stamps, m.stamp)
        if (idx_other == -1 or dt_other > MAX_REL_MEAS_TIME_DIFF
                or idx_other >= pose_counter[m.robot_index]):
            i += 1
            continue
        idx_host, dt_host = index_closest_stamp(host_stamps, m.stamp)
        if (idx_host == -1 or dt_host > MAX_REL_MEAS_TIME_DIFF
                or idx_host >= pose_counter[host_robot_id]):
            i += 1
            continue
        matches.append(RelativeMeasMatch(m, idx_host, idx_other))
        feasible.pop(i)

    # prune measurements that can no longer be matched (both robots have
    # advanced past the stamp) — sloam.cpp:386-407
    i = 0
    while i < len(feasible):
        m = feasible[i]
        n_obs = pose_counter[m.robot_index]
        n_host = pose_counter[host_robot_id]
        stamp_obs = (stamps_by_robot.get(m.robot_index, [0.0])[n_obs - 1]
                     if n_obs > 0 else 0.0)
        stamp_host = (host_stamps[n_host - 1] if n_host > 0 else 0.0)
        if stamp_obs > m.stamp and stamp_host > m.stamp:
            feasible.pop(i)
        else:
            i += 1
    return matches


def make_queues():
    return deque(), deque(), deque()

"""Keyframe packets (the solo slice of slide_slam_tpu/comm/database.py).

`PoseMstPair` is one keyframe packet (== sloam_msgs/PoseMst): the key pose
estimate at insertion time, the raw relative odometry, the stamp and the
body-frame measurements. The inter-robot database waits for the
multi-robot slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

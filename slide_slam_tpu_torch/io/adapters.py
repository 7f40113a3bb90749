"""Sensor adapters: GPS-derived and simulator-derived measurement generation
(copy of slide_slam_tpu/io/adapters.py; host-side numpy, no tensors; it
builds the port's own `runtime.scheduler.RelativeMeas`).

Host-side twins of the reference's `frontend/relative_meas_gen` scripts:

* GPS relative measurements — dummyRelMeas.py:39-84: geodetic->ECEF->ENU
  displacement between two synchronized NavSatFix readings becomes a
  translation-only relative inter-robot measurement. The reference leans on
  pyproj; here the WGS-84 closed form is implemented directly (no orientation
  information, identity quaternion — exactly like the reference's empty
  `geometry_msgs/Quaternion`).
* Simulator ground-truth adapter — multiUGVToSlideSLAM.py:17-223: converts
  ground-truth robot poses + a gazebo `.world` box list into (a) noisy
  relative inter-robot measurements (0.03 m / 0.001 rad per metre of range,
  multiUGVToSlideSLAM.py:131-134) and (b) noisy body-frame cuboid detections
  (0.05 m / 0.017 rad pose noise + 0.01 m scale noise per metre of range,
  :89-100) in the keyframe-observation dict format used across this package.
* `relative_pose` / `add_pose_noise` — transforms.py:5-78 (tested against the
  reference's golden values in testMultiUGV.py:17-37).

All of this is tiny host math on purpose — it generates measurements; the
device only ever sees the resulting batched keyframe arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import xml.etree.ElementTree as ET

from ..geometry import se3np as se3
from ..runtime.scheduler import RelativeMeas

# WGS-84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def geodetic_to_ecef(lat_deg, lon_deg, alt_m) -> np.ndarray:
    """WGS-84 geodetic -> ECEF (closed form; replaces pyproj in
    dummyRelMeas.py:42-47)."""
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt_m, np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * sin_lat**2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - _WGS84_E2) + alt) * sin_lat
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def ecef_to_enu(ecef_ref: np.ndarray, ecef_target: np.ndarray,
                lat_ref_deg: float, lon_ref_deg: float) -> np.ndarray:
    """ECEF displacement -> local ENU at the reference (dummyRelMeas.py:49-64)."""
    lat = np.radians(float(lat_ref_deg))
    lon = np.radians(float(lon_ref_deg))
    rot = np.array([
        [-np.sin(lon), np.cos(lon), 0.0],
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)],
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
    ])
    return rot @ (np.asarray(ecef_target) - np.asarray(ecef_ref))


def gps_to_enu(lat1, lon1, alt1, lat2, lon2, alt2) -> np.ndarray:
    """(X, Y, Z) of GPS fix 2 in the ENU frame of fix 1 (dummyRelMeas.py:66-70)."""
    return ecef_to_enu(geodetic_to_ecef(lat1, lon1, alt1),
                       geodetic_to_ecef(lat2, lon2, alt2), lat1, lon1)


def gps_relative_measurement(stamp: float, observer_fix, observed_fix,
                             observed_robot_index: int,
                             observer_odom_pose: np.ndarray,
                             max_stamp_diff: float = 0.0625) -> Optional[RelativeMeas]:
    """Two synchronized (stamp, lat, lon, alt) fixes -> translation-only
    RelativeMeas, or None when the stamps disagree beyond the sync slop
    (dummyRelMeas.py:24 ApproximateTimeSynchronizer slop)."""
    s1, *g1 = observer_fix
    s2, *g2 = observed_fix
    if abs(float(s1) - float(s2)) > max_stamp_diff:
        return None
    enu = gps_to_enu(*g1, *g2)
    rel = se3.identity()
    rel[4:7] = enu
    return RelativeMeas(stamp=float(stamp), relative_pose=rel.astype(np.float32),
                        robot_index=observed_robot_index,
                        odom_pose=np.asarray(observer_odom_pose, np.float32))


# ---------------------------------------------------------------------------
# transforms.py equivalents (Euler-noise pose perturbation, relative pose)
# ---------------------------------------------------------------------------

def relative_pose(pose1: np.ndarray, pose2: np.ndarray) -> np.ndarray:
    """Pose of `pose2` in the frame of `pose1` (transforms.py:5-39)."""
    return se3.between(np.asarray(pose1), np.asarray(pose2))


def _euler_xyz_from_quat(q: np.ndarray) -> np.ndarray:
    """Extrinsic-xyz Euler angles from a [w,x,y,z] quaternion."""
    w, x, y, z = q
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([roll, pitch, yaw])


def _quat_from_euler_xyz(e: np.ndarray) -> np.ndarray:
    """[w,x,y,z] quaternion from extrinsic-xyz Euler angles."""
    hr, hp, hy = np.asarray(e, np.float64) / 2.0
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    # q = qz(yaw) * qy(pitch) * qx(roll)  (extrinsic xyz == intrinsic zyx)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def add_pose_noise(pose: np.ndarray, std_translation: float,
                   std_rotation: float, rng: np.random.Generator) -> np.ndarray:
    """Zero-mean Gaussian pose perturbation: translation in metres, rotation
    on the Euler-xyz angles in radians (transforms.py:41-78)."""
    out = np.asarray(pose, np.float64).copy()
    out[4:7] += rng.normal(0.0, std_translation, 3) if std_translation > 0 else 0.0
    if std_rotation > 0:
        e = _euler_xyz_from_quat(out[0:4]) + rng.normal(0.0, std_rotation, 3)
        out[0:4] = _quat_from_euler_xyz(e)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Simulator ground-truth adapter (multiUGVToSlideSLAM.py)
# ---------------------------------------------------------------------------

@dataclass
class SimBox:
    """A gazebo `_box_` model: world pose [7] + box dimensions [3]."""
    name: str
    pose: np.ndarray
    size: np.ndarray


def parse_gazebo_world(path_or_xml: str) -> List[SimBox]:
    """Extract `_box_` models (pose + collision box size) from a gazebo
    `.world` SDF file (multiUGVToSlideSLAM.py:161-180).

    Boxes with non-identity rotation are kept with their yaw-only rotation
    (the reference errors out on them; axis-aligned worlds are the norm)."""
    if "<" in path_or_xml:
        root = ET.fromstring(path_or_xml)
    else:
        root = ET.parse(path_or_xml).getroot()
    world = root.find("world") if root.tag != "world" else root
    if world is None:
        world = root
    boxes: List[SimBox] = []
    for model in world.findall("model"):
        name = model.get("name") or ""
        if "_box_" not in name:
            continue
        vals = [float(v) for v in model.find("pose").text.strip().split()]
        x, y, z, roll, pitch, yaw = vals
        pose = np.asarray(se3.from_xyz_yaw(x, y, z, yaw), np.float32)
        size_el = (model.find("link").find("collision")
                   .find("geometry").find("box").find("size"))
        size = np.array([float(v) for v in size_el.text.strip().split()],
                        np.float32)
        boxes.append(SimBox(name=name, pose=pose, size=size))
    return boxes


def sim_relative_measurement(stamp: float, observer_pose: np.ndarray,
                             observed_pose: np.ndarray,
                             observed_robot_index: int,
                             observer_odom_pose: np.ndarray,
                             rng: np.random.Generator,
                             std_t_per_m: float = 0.03,
                             std_r_per_m: float = 0.001) -> RelativeMeas:
    """Ground-truth poses -> noisy relative inter-robot measurement with
    range-proportional noise (multiUGVToSlideSLAM.py:128-150; noise model
    motivated by the AprilTag 2 paper, :131-132)."""
    rel = relative_pose(observer_pose, observed_pose)
    dist = float(np.linalg.norm(se3.trans(rel)))
    rel = add_pose_noise(rel, std_t_per_m * dist, std_r_per_m * dist, rng)
    return RelativeMeas(stamp=float(stamp), relative_pose=rel,
                        robot_index=observed_robot_index,
                        odom_pose=np.asarray(observer_odom_pose, np.float32))


def sim_cuboid_detections(boxes: List[SimBox], robot_pose: np.ndarray,
                          rng: np.random.Generator, label: int = 5,
                          std_t_per_m: float = 0.05,
                          std_r_per_m: float = 0.017,
                          std_s_per_m: float = 0.01,
                          max_range: Optional[float] = None) -> dict:
    """World boxes -> body-frame cuboid observation dict with
    range-proportional pose/scale noise (multiUGVToSlideSLAM.py:62-105).

    Returns the `cub_pose/cub_scale/cub_label` keys consumed by the keyframe
    path; the reference's RViz-marker packaging has no equivalent here."""
    poses, scales = [], []
    for box in boxes:
        rel = relative_pose(robot_pose, box.pose)
        dist = float(np.linalg.norm(se3.trans(rel)))
        if max_range is not None and dist > max_range:
            continue
        poses.append(add_pose_noise(rel, std_t_per_m * dist,
                                    std_r_per_m * dist, rng))
        scales.append(box.size + rng.normal(0.0, std_s_per_m * dist, 3))
    n = len(poses)
    return {
        "cub_pose": (np.stack(poses) if n else np.zeros((0, 7))).astype(np.float32),
        "cub_scale": (np.stack(scales) if n else np.zeros((0, 3))).astype(np.float32),
        "cub_label": np.full((n,), label, np.int32),
    }

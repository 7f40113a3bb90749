"""Indoor-LiDAR semantic pipeline (PyTorch twin of
slide_slam_tpu/frontend/lidar_indoor.py).

A segmented indoor LiDAR scan of chairs, tables and floor becomes centroid
(range-bearing) landmark measurements for the backend:

1. range gate,
2. raw -> unified label remap ({chair: 3, table: 4, floor: 2} raw ->
   {chair: 1, table: 2}),
3. ground-plane RANSAC on the floor class (on the device; the previous
   plane is kept when too few floor points are visible or the fit is not
   roughly horizontal),
4. distance-to-ground gate,
5. two-stage DBSCAN of every class with enough points (one copy up, one
   launch of the CUDA kernel for all classes, one copy back),
6. bbox seeds (median centre, XY extents, length gate) -> Hungarian track
   update, then expiry of tracks lost for more than N scans,
7. aged tracks -> batched hull-PCA cuboid fit with exact min/max extents ->
   each valid object a body-frame centroid measurement with the cuboid dims
   as its scale.

`ransac_draws(n_rows, n_hypotheses)`, when given, supplies the RANSAC draws
(tests pass the JAX package's), as in ProcessCloudPipeline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..geometry import se3
from . import cylinder_fit
from .pipeline import _pad_points, cluster_classes, fit_aged_tracks
from .tracker import MultiClassTracker


@dataclass
class IndoorClassSpec:
    name: str
    raw_label: int              # segmentation output id
    label: int                  # unified backend label
    eps_first: float = 1.25
    min_samples_first: int = 40
    eps_scan: float = 0.35
    min_samples_scan: int = 15
    fit_length_thresh: float = 0.3
    track_age_threshold: int = 3
    assignment_threshold: float = 1.5
    dim_lo: tuple = (0.2, 0.2, 0.2)
    dim_hi: tuple = (4.0, 4.0, 2.5)


def indoor_lidar_classes() -> List[IndoorClassSpec]:
    return [
        IndoorClassSpec("chair", raw_label=3, label=1),
        IndoorClassSpec("table", raw_label=4, label=2,
                        dim_hi=(5.0, 5.0, 1.8)),
    ]


@dataclass
class IndoorLidarConfig:
    classes: List[IndoorClassSpec] = field(
        default_factory=indoor_lidar_classes)
    floor_raw_label: int = 2
    valid_range_threshold: float = 15.0
    ground_median_increment: float = 0.15    # min height above ground
    max_points_per_class: int = 1024
    max_points_per_instance: int = 512
    num_lost_track_times_thresh: int = 10
    downsample_res: float = 0.1


class IndoorLidarPipeline:
    def __init__(self, cfg: Optional[IndoorLidarConfig] = None,
                 device="cuda", ransac_draws: Optional[Callable] = None):
        self.cfg = cfg or IndoorLidarConfig()
        self.device = torch.device(device)
        self.ransac_draws = ransac_draws
        self.tracker = MultiClassTracker(
            {c.label: c.assignment_threshold for c in self.cfg.classes},
            downsample_res=self.cfg.downsample_res)
        self.scan_idx = 0
        self.ground_plane = np.array([0.0, 0.0, 1.0, 0.0])  # ax+by+cz+d=0

    def _t(self, a):
        return torch.as_tensor(a, device=self.device)

    def _update_ground(self, floor_pts: np.ndarray):
        if len(floor_pts) < 50:
            return
        gp, gm = _pad_points(floor_pts, self.cfg.max_points_per_class)
        draws = (None if self.ransac_draws is None
                 else self._t(np.asarray(self.ransac_draws(1, 64))))
        n, d, _ = cylinder_fit.fit_plane_ransac(
            self._t(gp)[None], self._t(gm)[None], thresh=0.1, draws=draws)
        host = torch.cat([n[0], d]).cpu().numpy()
        if abs(host[2]) > 0.5:              # roughly horizontal
            self.ground_plane = np.array([host[0], host[1], host[2],
                                          float(host[3])])

    def _dist_to_ground(self, pts: np.ndarray) -> np.ndarray:
        a, b, c, d = self.ground_plane
        return ((pts[:, 0] * a + pts[:, 1] * b + pts[:, 2] * c + d)
                / max(np.linalg.norm([a, b, c]), 1e-9))

    def process_scan(self, xyz: np.ndarray, raw_labels: np.ndarray,
                     sensor_pose7: np.ndarray) -> Dict[str, np.ndarray]:
        """xyz [N, 3] world-frame points, raw_labels [N] segmentation ids.
        Returns the body-frame measurement dict (ell_* rows) for the
        backend keyframe."""
        cfg = self.cfg
        xyz = np.asarray(xyz, np.float32)
        raw_labels = np.asarray(raw_labels)
        sensor_xyz = np.asarray(sensor_pose7, np.float32)[4:7]
        rng_ok = (np.linalg.norm(xyz - sensor_xyz, axis=1)
                  < cfg.valid_range_threshold)
        self._update_ground(xyz[rng_ok & (raw_labels == cfg.floor_raw_label)])

        clustered = []
        for spec in cfg.classes:
            pts = xyz[rng_ok & (raw_labels == spec.raw_label)]
            if len(pts) == 0:
                continue
            pts = pts[self._dist_to_ground(pts) > cfg.ground_median_increment]
            if len(pts) >= spec.min_samples_scan:
                clustered.append((spec, pts))
        labels = cluster_classes(
            [p for _, p in clustered],
            [(s.eps_first, s.min_samples_first, s.eps_scan,
              s.min_samples_scan) for s, _ in clustered],
            cfg.max_points_per_class, self.device)
        for (spec, pts), lab in zip(clustered, labels):
            k = min(len(pts), cfg.max_points_per_class)
            self._track(spec, pts[:k], lab[:k])

        self.tracker.expire(self.scan_idx, cfg.num_lost_track_times_thresh)
        obs = self._emit_centroids()
        self.scan_idx += 1
        return self._to_body_frame(obs, sensor_pose7)

    def _track(self, spec: IndoorClassSpec, pts: np.ndarray,
               labels: np.ndarray):
        """Bbox seeds of the class's instances (np.unique label order), then
        one tracker update."""
        seeds, raw = [], []
        for lab in np.unique(labels):
            if lab < 0:
                continue
            ipts = pts[labels == lab]
            lo, hi = ipts.min(axis=0), ipts.max(axis=0)
            if max(hi[0] - lo[0], hi[1] - lo[1]) < spec.fit_length_thresh:
                continue
            seeds.append([float(np.median(ipts[:, 0])),
                          float(np.median(ipts[:, 1])),
                          float(hi[0] - lo[0]), float(hi[1] - lo[1])])
            raw.append(ipts)
        if seeds:
            self.tracker.update(spec.label, np.asarray(seeds), raw,
                                self.scan_idx)

    def _emit_centroids(self) -> dict:
        cfg = self.cfg
        tracks, fit = fit_aged_tracks(self.tracker, cfg.classes,
                                      cfg.max_points_per_instance,
                                      self.device, minmax_extents=True)
        obs = {"ell_pose": [], "ell_scale": [], "ell_label": []}
        if not tracks:
            return obs
        host = torch.cat([fit.centroid, fit.dims,
                          fit.valid[:, None].float()], dim=1).cpu().numpy()
        for i in np.nonzero(host[:, 6] > 0)[0]:
            obs["ell_pose"].append(np.concatenate(
                [[1, 0, 0, 0], host[i, :3]]).astype(np.float32))
            obs["ell_scale"].append(host[i, 3:6])
            obs["ell_label"].append(tracks[i].class_label)
        return obs

    def _to_body_frame(self, obs: dict, sensor_pose7) -> dict:
        if not obs["ell_pose"]:
            return {}
        inv = se3.inverse(self._t(np.asarray(sensor_pose7, np.float32)))
        poses = self._t(np.stack(obs["ell_pose"]))
        return {
            "ell_pose": se3.compose(inv, poses).cpu().numpy(),
            "ell_scale": np.stack(obs["ell_scale"]).astype(np.float32),
            "ell_label": np.asarray(obs["ell_label"], np.int32),
        }

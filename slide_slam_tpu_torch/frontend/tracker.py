"""Object instance tracker (host-side numpy copy of
slide_slam_tpu/frontend/tracker.py).

Class-gated Hungarian assignment of new detections to tracks by XY centroid
distance, EMA state updates (alpha = 0.1), age counting, voxel-downsampled
accumulated raw points with a recency cap, XY covariance from the position
history, and expiry of tracks lost for N scans. The assignment is scipy's
linear_sum_assignment over the cost matrix padded with the gate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def hungarian_assignment(cost: np.ndarray, unassigned_cost: float):
    """Pad the cost matrix with the gate so an assignment above threshold
    becomes 'unassigned'. Returns (matches [(track, det)], lost_track_inds,
    new_det_inds)."""
    from scipy.optimize import linear_sum_assignment

    n1, n2 = cost.shape
    size = n1 + n2
    padded = np.full((size, size), unassigned_cost, np.float64)
    padded[:n1, :n2] = cost
    padded[n1:, n2:] = 0.0
    rows, cols = linear_sum_assignment(padded)
    matches, lost, new = [], set(range(n1)), set(range(n2))
    for r, c in zip(rows, cols):
        if r < n1 and c < n2 and cost[r, c] < unassigned_cost:
            matches.append((int(r), int(c)))
            lost.discard(r)
            new.discard(c)
    return matches, sorted(lost), sorted(new)


def voxel_downsample(points: np.ndarray, res: float) -> np.ndarray:
    """Mean point per occupied voxel."""
    if res <= 0 or len(points) == 0:
        return points
    keys = np.floor(points / res).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), points.shape[1]))
    np.add.at(sums, inv.reshape(-1), points)
    return sums / counts[:, None]


@dataclass
class ObjectTrack:
    x: float
    y: float
    l: float
    w: float
    class_label: int
    track_idx: int
    last_update_scan_idx: int
    age: int = 1
    pos_update_rate: float = 0.1
    downsample_res: float = 0.3
    num_points_limit: int = 50000
    xy_hist: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    all_raw_points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    xy_cov: np.ndarray = field(default_factory=lambda: 3 * np.ones((2, 2)))

    def __post_init__(self):
        if len(self.xy_hist) == 0:
            self.xy_hist = np.array([[self.x, self.y]])
        if self.downsample_res > 0 and len(self.all_raw_points):
            self.all_raw_points = voxel_downsample(self.all_raw_points,
                                                   self.downsample_res)

    def update(self, x, y, l, w, raw_points, scan_idx):
        self.xy_hist = np.vstack([self.xy_hist, [[x, y]]])
        self.age += 1
        a = self.pos_update_rate
        self.x = a * x + (1 - a) * self.x
        self.y = a * y + (1 - a) * self.y
        self.l = a * l + (1 - a) * self.l
        self.w = a * w + (1 - a) * self.w
        self.xy_cov = np.cov(self.xy_hist.T)
        pts = (voxel_downsample(raw_points, self.downsample_res)
               if self.downsample_res > 0 else raw_points)
        self.all_raw_points = np.vstack([self.all_raw_points, pts])
        if len(self.all_raw_points) > self.num_points_limit:
            self.all_raw_points = self.all_raw_points[-self.num_points_limit:]
        self.last_update_scan_idx = scan_idx


class MultiClassTracker:
    """Tracks of every class; one instance per pipeline."""

    def __init__(self, assignment_threshold_per_label: Dict[int, float],
                 downsample_res: float = 0.3,
                 num_instance_point_lim: int = 50000):
        self.tracks: List[ObjectTrack] = []
        self.thresholds = assignment_threshold_per_label
        self.downsample_res = downsample_res
        self.point_lim = num_instance_point_lim
        self._next_id = 0

    def update(self, class_label: int, detections: np.ndarray,
               raw_points: Sequence[np.ndarray], scan_idx: int):
        """detections [K, 4] rows (x, y, l, w); raw_points list of [P_k, 3]."""
        detections = np.asarray(detections, np.float64).reshape(-1, 4)
        class_tracks = [t for t in self.tracks if t.class_label == class_label]
        if len(class_tracks) == 0 or len(detections) == 0:
            matches, new_inds = [], list(range(len(detections)))
        else:
            cost = np.linalg.norm(
                np.array([[t.x, t.y] for t in class_tracks])[:, None, :]
                - detections[None, :, :2], axis=-1)
            thr = self.thresholds.get(class_label, 2.0)
            matches, _, new_inds = hungarian_assignment(cost, thr)
        for ti, di in matches:
            class_tracks[ti].update(*detections[di], raw_points[di], scan_idx)
        for di in new_inds:
            self.tracks.append(ObjectTrack(
                x=detections[di, 0], y=detections[di, 1],
                l=detections[di, 2], w=detections[di, 3],
                class_label=class_label, track_idx=self._next_id,
                last_update_scan_idx=scan_idx,
                downsample_res=self.downsample_res,
                num_points_limit=self.point_lim,
                all_raw_points=np.asarray(raw_points[di])))
            self._next_id += 1

    def aged_tracks(self, age_threshold_per_label: Dict[int, float]):
        """Tracks past their class age gate."""
        return [t for t in self.tracks
                if t.age > age_threshold_per_label.get(t.class_label, 1)]

    def expire(self, scan_idx: int, num_lost_track_times_thresh: int):
        """Drop tracks not updated for more than N scans."""
        self.tracks = [
            t for t in self.tracks
            if scan_idx - t.last_update_scan_idx <= num_lost_track_times_thresh]

"""Raw-LiDAR frontend: scan -> segmentation -> object measurements (PyTorch
twin of slide_slam_tpu/frontend/lidar_pipeline.py).

One call takes a raw deskewed point cloud and its synced odometry pose and
returns the body-frame object-measurement dict the backend consumes: the
single-robot raw-LiDAR configuration (BASELINE config 3). The segmenter is
any callable `(model_input [1, H, W, 5]) -> labels [1, H, W]`; the port
ships the simulator's ground-truth labeller (`use_sim`), the network waits
for a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..geometry import se3np
from . import range_projection
from .pipeline import PipelineConfig, ProcessCloudPipeline


@dataclass
class LidarFrontendConfig:
    height: int = 64
    width: int = 1024
    fov_up_deg: float = 15.0
    fov_down_deg: float = -15.0
    desired_period: float = 0.5          # 2 Hz throttle


class LidarFrontend:
    def __init__(self, segment_fn: Callable,
                 cfg: Optional[LidarFrontendConfig] = None,
                 pipeline_cfg: Optional[PipelineConfig] = None,
                 device="cuda", ransac_draws: Optional[Callable] = None):
        """segment_fn(model_input [1, H, W, 5]) -> labels [1, H, W] int."""
        self.cfg = cfg or LidarFrontendConfig()
        self.segment_fn = segment_fn
        self.device = torch.device(device)
        self.pipeline = ProcessCloudPipeline(pipeline_cfg, device=device,
                                             ransac_draws=ransac_draws)
        self._last_stamp = -np.inf

    def process_scan(self, stamp: float, points_body: np.ndarray,
                     remission: np.ndarray, sensor_pose7: np.ndarray):
        """The measurement dict, or None when throttled.

        points_body: [N, 3] deskewed body-frame cloud; sensor_pose7: the
        synced odometry pose (body -> world)."""
        if stamp - self._last_stamp < self.cfg.desired_period:
            return None
        self._last_stamp = stamp
        c = self.cfg
        pts_np = np.asarray(points_body, np.float32)
        pts = torch.as_tensor(pts_np, device=self.device)
        rem = torch.as_tensor(np.asarray(remission, np.float32),
                              device=self.device)
        valid = torch.ones((len(pts_np),), dtype=torch.bool,
                           device=self.device)
        ri = range_projection.project(
            pts, rem, valid, height=c.height, width=c.width,
            fov_up_deg=c.fov_up_deg, fov_down_deg=c.fov_down_deg)
        model_in = torch.movedim(range_projection.make_model_input(ri)[None],
                                 1, -1)                          # [1,H,W,5]
        labels_img = torch.as_tensor(self.segment_fn(model_in),
                                     device=self.device)[0]
        point_labels = range_projection.unproject_labels(
            ri, labels_img).cpu().numpy()
        world_pts = se3np.apply(np.asarray(sensor_pose7, np.float32), pts_np)
        return self.pipeline.process_scan(world_pts, point_labels,
                                          sensor_pose7)


def ground_truth_segmenter(world, sensor_pose7_getter):
    """Simulator labeller: each projected pixel takes the class of the
    nearest world object (the reference's use_sim shortcut). Runs on the
    host."""

    def fn(model_input):
        x = torch.as_tensor(model_input)[0].cpu().numpy()
        H, W, _ = x.shape
        pose = sensor_pose7_getter()
        wpts = se3np.apply(pose, x[..., 1:4].reshape(-1, 3).astype(np.float32))
        labels = np.zeros((H * W,), np.int32)
        mask = x[..., 0].reshape(-1) > 0
        if mask.any():
            labels[mask] = _nearest_object_label(world, wpts[mask])
        return torch.as_tensor(labels.reshape(1, H, W))

    return fn


def _nearest_object_label(world, pts, ground_z=0.25, max_dist=1.5):
    labels = np.full(len(pts), 1, np.int32)       # default: ground
    centers, labs = [], []
    if len(world.cyl_root):
        centers.append(world.cyl_root[:, :2])
        labs.append(world.cyl_label)
    if len(world.cub_pose):
        centers.append(world.cub_pose[:, 4:6])
        labs.append(world.cub_label)
    if centers:
        centers = np.concatenate(centers)
        labs = np.concatenate(labs)
        d = np.linalg.norm(pts[:, None, :2] - centers[None], axis=-1)
        nearest = np.argmin(d, axis=1)
        near_enough = d[np.arange(len(pts)), nearest] < max_dist
        sel = near_enough & (pts[:, 2] > ground_z)
        labels[sel] = labs[nearest[sel]]
    return labels

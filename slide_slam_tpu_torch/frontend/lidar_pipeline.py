"""Raw-LiDAR frontend: scan -> segmentation -> object measurements (PyTorch
twin of slide_slam_tpu/frontend/lidar_pipeline.py).

One call takes a raw deskewed point cloud and its synced odometry pose and
returns the body-frame object-measurement dict the backend consumes: the
single-robot raw-LiDAR configuration (BASELINE config 3). The segmenter is
any callable `(model_input [1, H, W, 5]) -> labels [1, H, W]`: the trained
RangeSegmentator (`lambda x: segmentation.segment(model, x)`, which keeps
the image and the labels on the card), or the simulator's ground-truth
labeller (`use_sim`), which runs on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..geometry import se3np
from ..io.synthetic import nearest_object_label
from ..runtime.profiling import phase, to_host
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
        # keyed as robot 0's keyframe of the same stamp: no LiDAR frontend
        # runs for another robot
        with phase("scan", key=(0, float(stamp))):
            return self._process(points_body, remission, sensor_pose7)

    def _process(self, points_body, remission, sensor_pose7):
        c = self.cfg
        with phase("scan.project"):
            pts_np = np.asarray(points_body, np.float32)
            pts = torch.as_tensor(pts_np, device=self.device)
            rem = torch.as_tensor(np.asarray(remission, np.float32),
                                  device=self.device)
            valid = torch.ones((len(pts_np),), dtype=torch.bool,
                               device=self.device)
            ri = range_projection.project(
                pts, rem, valid, height=c.height, width=c.width,
                fov_up_deg=c.fov_up_deg, fov_down_deg=c.fov_down_deg)
            model_in = torch.movedim(                           # [1,H,W,5]
                range_projection.make_model_input(ri)[None], 1, -1)
            labels_img = torch.as_tensor(self.segment_fn(model_in),
                                         device=self.device)[0]
            point_labels = to_host(range_projection.unproject_labels(
                ri, labels_img), "point_labels")
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
            labels[mask] = nearest_object_label(world, wpts[mask])
        return torch.as_tensor(labels.reshape(1, H, W))

    return fn

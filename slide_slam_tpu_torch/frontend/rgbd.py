"""RGBD detection backprojection (PyTorch twin of
slide_slam_tpu/frontend/rgbd.py).

The reference's detect.py (frontend/object_modeller/script/detect.py:103-260)
runs YOLOv8 instance masks, then backprojects the aligned depth through the
camera intrinsics into a labeled point cloud. The detector itself is an
external model; this module is the device-side geometry: the vectorized
backprojection and the per-instance cloud extraction that turn
(masks, depth, K) into the labeled clouds the object modeller consumes.

The JAX package computes `backproject` in XLA, not in a Pallas kernel, so it
is plain PyTorch ops here. Its scalars are f32, as JAX's weakly typed Python
floats are, and the arithmetic keeps JAX's order ((u - cx) / fx * z), so the
labelled cloud's integers equal JAX's and its points agree to the last bit
of f32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3


class LabeledCloud(NamedTuple):
    xyz: torch.Tensor        # [H*W, 3] camera-frame points
    label: torch.Tensor      # [H*W] int32 (-1 background)
    instance: torch.Tensor   # [H*W] int32 (-1 background)
    confidence: torch.Tensor # [H*W] f32
    valid: torch.Tensor      # [H*W] bool: depth valid & inside a mask


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def backproject(depth: torch.Tensor, masks: torch.Tensor,
                mask_labels: torch.Tensor, mask_conf: torch.Tensor,
                fx: float, fy: float, cx: float, cy: float,
                depth_scale: float = 1.0, max_depth: float = 10.0,
                conf_thresh: float = 0.5) -> LabeledCloud:
    """depth [H, W] (raw units * depth_scale = meters), masks [K, H, W] bool
    instance masks, mask_labels [K] int32, mask_conf [K]; the cloud lies on
    depth's device.

    Camera convention: +z forward, x right, y down (standard pinhole)."""
    dev = depth.device
    H, W = depth.shape
    K = masks.shape[0]
    z = depth.to(torch.float32) * _f32(depth_scale, dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    x = (u - _f32(cx, dev)) / _f32(fx, dev) * z
    y = (v - _f32(cy, dev)) / _f32(fy, dev) * z
    xyz = torch.stack([x, y, z], dim=-1).reshape(-1, 3)

    conf = mask_conf.to(torch.float32)
    conf_ok = conf >= _f32(conf_thresh, dev)
    m = masks & conf_ok[:, None, None]
    # first (highest-priority) mask wins per pixel: the lowest index of a
    # set mask (jnp.argmax over bools), K where none is set
    order = torch.arange(K, dtype=torch.int32, device=dev)[:, None, None]
    first = torch.where(m, order, torch.full_like(order, K)).amin(dim=0)
    flat_inst = torch.where(first < K, first, -1).reshape(-1)
    has = flat_inst >= 0
    safe = flat_inst.clamp(0, K - 1).long()
    label = torch.where(has, mask_labels.to(torch.int32)[safe],
                        -1).to(torch.int32)
    confidence = torch.where(has, conf[safe], _f32(0.0, dev))
    zf = z.reshape(-1)
    depth_ok = (zf > _f32(1e-3, dev)) & (zf < _f32(max_depth, dev))
    return LabeledCloud(xyz=xyz, label=label,
                        instance=flat_inst.to(torch.int32),
                        confidence=confidence, valid=depth_ok & has)


def to_world(cloud: LabeledCloud, cam_pose7) -> LabeledCloud:
    """Transform camera-frame points by the (synced-odometry) camera pose."""
    dev = cloud.xyz.device
    if isinstance(cam_pose7, torch.Tensor):
        pose = cam_pose7.to(dev, torch.float32)
    else:
        pose = torch.as_tensor(np.asarray(cam_pose7, np.float32), device=dev)
    return cloud._replace(xyz=se3.apply(pose, cloud.xyz))


def host_cloud(cloud: LabeledCloud) -> LabeledCloud:
    """The cloud as numpy arrays (one device-to-host copy per field)."""
    return LabeledCloud(*(t.cpu().numpy() if isinstance(t, torch.Tensor)
                          else np.asarray(t) for t in cloud))


def instance_points(cloud: LabeledCloud, instance_id: int, max_points: int):
    """Padded [max_points, 3] + mask for one instance (host numpy).
    Over-capacity instances are stride-subsampled (not truncated) so the
    kept points still span the instance — the reference's analogue is the
    voxel downsample capped at num_instance_point_lim
    (object_tracker.py:8-78)."""
    cloud = host_cloud(cloud)
    sel = cloud.valid & (cloud.instance == instance_id)
    pts = cloud.xyz[sel]
    if len(pts) > max_points:
        idx = np.round(np.linspace(0, len(pts) - 1, max_points)).astype(int)
        pts = pts[idx]
    out = np.zeros((max_points, 3), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros((max_points,), bool)
    mask[:len(pts)] = True
    return out, mask

"""Spherical range-image projection (PyTorch twin of
slide_slam_tpu/frontend/range_projection.py).

Projects a LiDAR cloud onto an HxW range image (fov_up/fov_down vertical
model) keeping the nearest return per pixel. The JAX version scatters the
points in order of decreasing depth (stable argsort) and relies on the last
write winning; a scatter with duplicate indices has no defined winner on
CUDA, so here each pixel is resolved explicitly: the minimum depth by
`scatter_reduce("amin")`, then, among the points at that depth, the highest
point index, which is the point the stable order writes last.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RangeImage(NamedTuple):
    range_img: torch.Tensor      # [H, W] (-1 where empty)
    xyz_img: torch.Tensor        # [H, W, 3]
    remission_img: torch.Tensor  # [H, W]
    proj_x: torch.Tensor         # [N] int32 column of each point
    proj_y: torch.Tensor         # [N] int32 row of each point
    mask: torch.Tensor           # [H, W] valid pixels


def project(points: torch.Tensor, remission: torch.Tensor,
            valid: torch.Tensor, *, height: int = 64, width: int = 1024,
            fov_up_deg: float = 15.0, fov_down_deg: float = -15.0
            ) -> RangeImage:
    """points [N, 3] (invalid rows masked), remission [N]."""
    dev = points.device
    fov_up = np.deg2rad(fov_up_deg)
    fov_down = np.deg2rad(fov_down_deg)
    fov = abs(fov_down) + abs(fov_up)

    depth = torch.linalg.norm(points, dim=1)
    depth_safe = torch.clamp(depth, min=1e-6)
    yaw = -torch.atan2(points[:, 1], points[:, 0])
    pitch = torch.asin(torch.clamp(points[:, 2] / depth_safe, -1.0, 1.0))
    proj_x = 0.5 * (yaw / np.pi + 1.0) * width
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov) * height
    proj_x = torch.clamp(torch.floor(proj_x), 0, width - 1).to(torch.int32)
    proj_y = torch.clamp(torch.floor(proj_y), 0, height - 1).to(torch.int32)

    hw = height * width
    n = points.shape[0]
    flat = (proj_y.long() * width + proj_x.long())
    flat = torch.where(valid, flat, torch.full_like(flat, hw))  # dump pixel
    big = torch.full((hw + 1,), float("inf"), dtype=depth.dtype, device=dev)
    dmin = big.scatter_reduce(0, flat, depth, reduce="amin")
    at_min = valid & (depth == dmin[flat])
    ar = torch.arange(n, device=dev)
    winner = torch.full((hw + 1,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(0, flat, torch.where(at_min, ar, -1),
                                   reduce="amax")[:hw]
    hit = winner >= 0
    src = torch.clamp(winner, min=0)
    rimg = torch.where(hit, depth[src], torch.full_like(depth[src], -1.0))
    ximg = torch.where(hit[:, None], points[src], torch.zeros_like(points[src]))
    mimg = torch.where(hit, remission[src], torch.zeros_like(remission[src]))
    rimg = rimg.reshape(height, width)
    return RangeImage(range_img=rimg, xyz_img=ximg.reshape(height, width, 3),
                      remission_img=mimg.reshape(height, width),
                      proj_x=proj_x, proj_y=proj_y, mask=rimg >= 0)


def unproject_labels(ri: RangeImage, label_img: torch.Tensor) -> torch.Tensor:
    """Per-point labels read from the label image at each point's pixel."""
    return label_img[ri.proj_y.long(), ri.proj_x.long()]


def make_model_input(ri: RangeImage, means=None, stds=None) -> torch.Tensor:
    """[5, H, W] network input: range, x, y, z, remission, normalized and
    zeroed outside the mask."""
    feats = torch.cat([ri.range_img[None], torch.movedim(ri.xyz_img, -1, 0),
                       ri.remission_img[None]], dim=0)
    if means is not None:
        feats = (feats - means[:, None, None]) / stds[:, None, None]
    return feats * ri.mask[None]

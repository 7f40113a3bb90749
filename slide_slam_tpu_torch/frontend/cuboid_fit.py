"""Batched cuboid fitting from clustered instance points (PyTorch twin of
slide_slam_tpu/frontend/cuboid_fit.py).

Over padded instance tensors [I, P, 3]:

* `fit_bbox_seeds`: axis-aligned bbox centroid/dims per instance,
* `fit_cuboids`: PCA-oriented cuboid, the principal 2D direction from the
  closed-form 2x2 covariance over the instance's hull outline (the extreme
  points over N_HULL_DIRS support directions), yaw in [0, pi), masked
  1/99-percentile (or min/max) extents, per-class dimension gates, optional
  facing-direction flip from the front/rear height profile,
* `cluster_cuboid_orientation`: host-side yaw snapping of the final cuboid
  set to the scene's two dominant orthogonal directions.

Two-term projections are written out as `x * c + y * s` in the JAX order,
and the support directions are the correctly rounded f32 cosines and sines
of the JAX package's f32 angles, the same on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CuboidFit(NamedTuple):
    centroid: torch.Tensor   # [I, 3] world
    dims: torch.Tensor       # [I, 3] (length, width, height)
    yaw: torch.Tensor        # [I]
    valid: torch.Tensor      # [I] passed the class dimension gates


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float):
    """Percentile over the masked entries of the last axis (NaN-based,
    linear interpolation, as jnp.nanpercentile)."""
    xm = torch.where(mask, x, torch.nan)
    return torch.nanquantile(xm, q / 100.0, dim=-1, interpolation="linear")


def fit_bbox_seeds(points: torch.Tensor, mask: torch.Tensor,
                   dim_thresh: float):
    """Axis-aligned bbox centroid/dims per instance; instances whose smaller
    XY dim is below dim_thresh are invalidated."""
    big = 1e9
    x, y = points[..., 0], points[..., 1]
    xmax = torch.where(mask, x, -big).amax(dim=-1)
    xmin = torch.where(mask, x, big).amin(dim=-1)
    ymax = torch.where(mask, y, -big).amax(dim=-1)
    ymin = torch.where(mask, y, big).amin(dim=-1)
    xc, yc = 0.5 * (xmax + xmin), 0.5 * (ymax + ymin)
    length, width = xmax - xmin, ymax - ymin
    ok = (torch.minimum(length, width) > dim_thresh) & mask.any(dim=-1)
    return xc, yc, length, width, ok


N_HULL_DIRS = 64
# the JAX package's jnp.linspace(0, 2 pi, 64, endpoint=False) in f32, and
# the correctly rounded cosines and sines of those f32 angles
_ANGLES = (np.arange(N_HULL_DIRS, dtype=np.float32)
           * np.float32(2.0 * np.pi / N_HULL_DIRS))
_HULL_DIRS = np.stack([np.cos(_ANGLES.astype(np.float64)),
                       np.sin(_ANGLES.astype(np.float64))],
                      axis=-1).astype(np.float32)            # [K, 2]


def _hull_vertex_mask(points: torch.Tensor, mask: torch.Tensor):
    """[I, P] mask of the extreme points of each instance's XY point set over
    N_HULL_DIRS support directions (argmax ties to the lower index)."""
    dirs = torch.as_tensor(_HULL_DIRS, device=points.device)
    x, y = points[:, None, :, 0], points[:, None, :, 1]      # [I, 1, P]
    proj = x * dirs[None, :, 0, None] + y * dirs[None, :, 1, None]
    proj = torch.where(mask[:, None, :], proj, -torch.inf)   # [I, K, P]
    arg = proj.argmax(dim=-1)                                 # [I, K]
    out = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    out.scatter_(1, arg, True)
    return out & mask


def fit_cuboids(points: torch.Tensor, mask: torch.Tensor,
                dim_lo: torch.Tensor, dim_hi: torch.Tensor,
                estimate_facing_dir: bool = False, use_convex: bool = True,
                minmax_extents: bool = False) -> CuboidFit:
    """points [I, P, 3] (world frame), mask [I, P]; dim_lo/hi [I, 3] per-
    instance (length, width, height) gates. With use_convex the PCA direction
    is fit on the hull outline; extents and centroid use all points."""
    pca_mask = _hull_vertex_mask(points, mask) if use_convex else mask
    cnt = pca_mask.sum(dim=-1).clamp(min=1).to(points.dtype)
    xy = points[..., :2]
    mean_xy = torch.where(pca_mask[..., None], xy, 0.0).sum(dim=1) \
        / cnt[:, None]
    d = torch.where(pca_mask[..., None], xy - mean_xy[:, None, :], 0.0)
    cxx = (d[..., 0] * d[..., 0]).sum(dim=1)
    cyy = (d[..., 1] * d[..., 1]).sum(dim=1)
    cxy = (d[..., 0] * d[..., 1]).sum(dim=1)
    raw_yaw = 0.5 * torch.atan2(2 * cxy, cxx - cyy)
    cw, sw = torch.cos(raw_yaw), torch.sin(raw_yaw)
    # x_axis = (cw, sw), y_axis = (-sw, cw)
    xp = xy[..., 0] * cw[:, None] + xy[..., 1] * sw[:, None]
    yp = xy[..., 0] * -sw[:, None] + xy[..., 1] * cw[:, None]
    zp = points[..., 2]

    q_hi, q_lo = (100.0, 0.0) if minmax_extents else (99.0, 1.0)
    x99, x01 = _masked_percentile(xp, mask, q_hi), _masked_percentile(
        xp, mask, q_lo)
    y99, y01 = _masked_percentile(yp, mask, q_hi), _masked_percentile(
        yp, mask, q_lo)
    z99, z01 = _masked_percentile(zp, mask, q_hi), _masked_percentile(
        zp, mask, q_lo)
    length, width, height = x99 - x01, y99 - y01, z99 - z01
    cx, cy, cz = 0.5 * (x99 + x01), 0.5 * (y99 + y01), 0.5 * (z99 + z01)
    # rotate the PCA-frame centroid back to world
    cen_world = torch.stack([cw * cx - sw * cy, sw * cx + cw * cy, cz], -1)

    yaw = torch.where(raw_yaw < 0, raw_yaw + np.pi, raw_yaw)
    yaw = torch.where(yaw >= np.pi, yaw - np.pi, yaw)
    if estimate_facing_dir:
        rear_cut = _masked_percentile(xp, mask, 5)
        front_cut = _masked_percentile(xp, mask, 95)
        front_h = _masked_percentile(
            torch.where(xp >= front_cut[:, None], zp, torch.nan), mask, 70)
        rear_h = _masked_percentile(
            torch.where(xp <= rear_cut[:, None], zp, torch.nan), mask, 70)
        yaw = torch.where(rear_h < front_h, yaw + np.pi, yaw)

    dims = torch.stack([length, width, height], dim=-1)
    ok = ((dims > dim_lo).all(dim=-1) & (dims < dim_hi).all(dim=-1)
          & (mask.sum(dim=-1) > 3))
    return CuboidFit(centroid=cen_world, dims=dims, yaw=yaw, valid=ok)


def _two_means_1d(x: np.ndarray):
    """Exact 2-means of 1-D values: the contiguous split of the sorted
    values with the least within-cluster sum of squares (the optimum that
    k-means with restarts finds on 1-D data). Returns (centers [2], labels
    [n]), center 0 the lower one."""
    order = np.argsort(x, kind="stable")
    s = x[order]
    n = len(s)
    csum = np.cumsum(s)
    csq = np.cumsum(s * s)
    k = np.arange(1, n)                       # left part s[:k]
    left = csq[k - 1] - csum[k - 1] ** 2 / k
    right = (csq[-1] - csq[k - 1]) - (csum[-1] - csum[k - 1]) ** 2 / (n - k)
    split = int(k[np.argmin(left + right)])
    centers = np.array([s[:split].mean(), s[split:].mean()])
    labels = np.empty(n, np.int64)
    labels[order] = (np.arange(n) >= split).astype(np.int64)
    return centers, labels


def cluster_cuboid_orientation(yaws) -> np.ndarray:
    """Snap cuboid yaws to the scene's two dominant orthogonal directions:
    2-means over yaws folded into [-pi/4, 3pi/4), centers merged if < 45 deg
    apart (size-weighted), the runner-up center forced orthogonal to the
    winner, then every yaw snapped to its nearest center under the
    180-deg-ambiguous angle metric. When the two clusters are equal in size
    the winner is the lower center (the JAX package takes the one sklearn
    labels 0, which depends on its initialisation)."""
    yaws = np.asarray(yaws, np.float64)
    if len(yaws) <= 2:
        return yaws
    folded = yaws.copy()
    folded[folded < -np.pi / 4] += np.pi
    folded[folded > 3 * np.pi / 4] -= np.pi
    centers, labels = _two_means_1d(folded)
    sizes = np.array([(labels == 0).sum(), (labels == 1).sum()])
    if abs(centers[0] - centers[1]) < np.pi / 4:
        main = (centers * sizes).sum() / sizes.sum()
    else:
        main = centers[int(np.argmax(sizes))]
    ortho = main + np.pi / 2
    if ortho > 3 * np.pi / 4:
        ortho -= np.pi
    cc = np.array([main, ortho])
    diff = np.abs(cc[None, :] - folded[:, None])
    diff = np.where(diff > np.pi / 2, np.pi - diff, diff)
    return cc[np.argmin(diff, axis=1)].astype(yaws.dtype)

"""Pairwise object distances (PyTorch twin of slide_slam_tpu/ops/distances.py).

Dense [N, M] distances used by data association:

* cylinders: min over sample heights {0, 3, 6} m of the distance between the
  two axes evaluated at that height, BIG where labels differ;
* cuboids: centroid L2, not label gated;
* ellipsoids: centroid L2, label gated;
* cuboids, the reference's other two forms: the label-gated blend of
  centroid L2 and scale difference, and the axis-aligned IoU.
"""
from __future__ import annotations

import torch

from ..objects import Cuboids, Cylinders, Ellipsoids

BIG = 1.0e3
SAMPLE_HEIGHTS = (0.0, 3.0, 6.0)


def _axis_point_at_height(root, ray, h):
    """Point on the (root, ray) line with z == h."""
    rz = ray[..., 2]
    denom = torch.where(torch.abs(rz) < 1e-6, torch.sign(rz) * 1e-6 + 1e-12,
                        rz)
    t = (h - root[..., 2]) / denom
    return root + t[..., None] * ray


def _pair_norm(pa, pb):
    return torch.linalg.norm(pa[:, None, :] - pb[None, :, :], dim=-1)


def cylinder_pairwise(a: Cylinders, b: Cylinders) -> torch.Tensor:
    """[Na, Nb] distances; BIG where labels differ or entries are invalid."""
    d = None
    for h in SAMPLE_HEIGHTS:
        dh = _pair_norm(_axis_point_at_height(a.root, a.ray, h),
                        _axis_point_at_height(b.root, b.ray, h))
        d = dh if d is None else torch.minimum(d, dh)
    ok = ((a.label[:, None] == b.label[None, :])
          & a.valid[:, None] & b.valid[None, :])
    return torch.where(ok, d, torch.full_like(d, BIG))


def centroid_pairwise(ca, cb, label_gate: bool) -> torch.Tensor:
    d = _pair_norm(ca.centroid(), cb.centroid())
    ok = ca.valid[:, None] & cb.valid[None, :]
    if label_gate:
        ok = ok & (ca.label[:, None] == cb.label[None, :])
    return torch.where(ok, d, torch.full_like(d, BIG))


def cuboid_pairwise(a: Cuboids, b: Cuboids) -> torch.Tensor:
    return centroid_pairwise(a, b, label_gate=False)


def cuboid_weighted_pairwise(a: Cuboids, b: Cuboids,
                             dim_weight: float = 0.5) -> torch.Tensor:
    """[Na, Nb] weightedDistance (cube.cpp:46-58): label-gated blend of
    centroid L2 and scale-difference norm / 3."""
    pos = _pair_norm(a.centroid(), b.centroid())
    sc = _pair_norm(a.scale, b.scale) / 3.0
    d = (1.0 - dim_weight) * pos + dim_weight * sc
    ok = (a.valid[:, None] & b.valid[None, :]
          & (a.label[:, None] == b.label[None, :]))
    return torch.where(ok, d, torch.full_like(d, BIG))


def cuboid_iou_pairwise(a: Cuboids, b: Cuboids) -> torch.Tensor:
    """[Na, Nb] axis-aligned IoU (cube.cpp:60-82): boxes are centroid +-
    scale/2, orientation ignored as in the reference; 0 where either entry
    is invalid."""
    lo_a, hi_a = a.centroid() - a.scale / 2.0, a.centroid() + a.scale / 2.0
    lo_b, hi_b = b.centroid() - b.scale / 2.0, b.centroid() + b.scale / 2.0
    overlap = torch.clamp(
        torch.minimum(hi_a[:, None, :], hi_b[None, :, :])
        - torch.maximum(lo_a[:, None, :], lo_b[None, :, :]), min=0.0)
    inter = torch.prod(overlap, dim=-1)
    union = (torch.prod(a.scale, dim=-1)[:, None]
             + torch.prod(b.scale, dim=-1)[None, :] - inter)
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    ok = a.valid[:, None] & b.valid[None, :]
    return torch.where(ok, iou, torch.zeros_like(iou))


def ellipsoid_pairwise(a: Ellipsoids, b: Ellipsoids) -> torch.Tensor:
    return centroid_pairwise(a, b, label_gate=True)

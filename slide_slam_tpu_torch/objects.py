"""Batched semantic object containers (PyTorch twin of slide_slam_tpu/objects.py).

Each object family is a struct-of-tensors with a validity mask, so whole
scans and whole maps are fixed-shape tensors:

* Cylinder: {root in R3, ray in R3, radius, semantic_label}
* Cuboid:   {pose in SE(3), scale in R3, semantic_label}
* Ellipsoid:{pose (centroid, upright), scale, semantic_label}
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry import se3


class Cylinders(NamedTuple):
    root: torch.Tensor    # [N, 3]
    ray: torch.Tensor     # [N, 3]
    radius: torch.Tensor  # [N]
    label: torch.Tensor   # [N] int32
    valid: torch.Tensor   # [N] bool

    @property
    def capacity(self) -> int:
        return self.root.shape[0]

    @staticmethod
    def empty(n: int, dtype=torch.float32, device="cuda") -> "Cylinders":
        return Cylinders(
            root=torch.zeros((n, 3), dtype=dtype, device=device),
            ray=torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype,
                             device=device).repeat(n, 1),
            radius=torch.zeros((n,), dtype=dtype, device=device),
            label=torch.zeros((n,), dtype=torch.int32, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device))

    def project(self, pose) -> "Cylinders":
        """World-frame version of body-frame cylinders; the ray transforms
        as a direction (rotation only)."""
        return self._replace(root=se3.apply(pose, self.root),
                             ray=se3.rotate(pose, self.ray))

    def centroid(self) -> torch.Tensor:
        return self.root


class Cuboids(NamedTuple):
    pose: torch.Tensor    # [N, 7]
    scale: torch.Tensor   # [N, 3]
    label: torch.Tensor   # [N] int32
    valid: torch.Tensor   # [N] bool

    @property
    def capacity(self) -> int:
        return self.pose.shape[0]

    @classmethod
    def empty(cls, n: int, dtype=torch.float32, device="cuda"):
        """n invalid slots: identity poses, zero scales and labels (an
        Ellipsoids batch from Ellipsoids.empty)."""
        return cls(
            pose=se3.identity((n,), dtype=dtype, device=device),
            scale=torch.zeros((n, 3), dtype=dtype, device=device),
            label=torch.zeros((n,), dtype=torch.int32, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device))

    def project(self, pose) -> "Cuboids":
        return self._replace(pose=se3.compose(pose, self.pose))

    def centroid(self) -> torch.Tensor:
        return se3.trans(self.pose)


class Ellipsoids(Cuboids):
    """Same layout and semantics as Cuboids (pose, scale, label, valid);
    capacity, empty, project and centroid are Cuboids' and return
    Ellipsoids."""


def pad_cylinders(root, ray, radius, label, n: int, device="cuda") -> Cylinders:
    """Padded Cylinders batch from variable-length host data (built in numpy,
    one transfer per field)."""
    k = min(len(radius), n)
    np_root = np.zeros((n, 3), np.float32)
    np_ray = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    np_rad = np.zeros((n,), np.float32)
    np_lab = np.zeros((n,), np.int32)
    np_val = np.zeros((n,), bool)
    if k:
        np_root[:k] = np.asarray(root[:k], np.float32)
        np_ray[:k] = np.asarray(ray[:k], np.float32)
        np_rad[:k] = np.asarray(radius[:k], np.float32)
        np_lab[:k] = np.asarray(label[:k], np.int32)
        np_val[:k] = True
    t = lambda a: torch.as_tensor(a, device=device)
    return Cylinders(t(np_root), t(np_ray), t(np_rad), t(np_lab), t(np_val))


def pad_boxlike(cls, pose, scale, label, n: int, device="cuda"):
    """Padded Cuboids/Ellipsoids from host data (pose as [k,7] wxyz+t)."""
    k = min(len(label), n)
    np_pose = np.zeros((n, 7), np.float32)
    np_pose[:, 0] = 1.0
    np_scale = np.zeros((n, 3), np.float32)
    np_lab = np.zeros((n,), np.int32)
    np_val = np.zeros((n,), bool)
    if k:
        np_pose[:k] = np.asarray(pose[:k], np.float32)
        np_scale[:k] = np.asarray(scale[:k], np.float32)
        np_lab[:k] = np.asarray(label[:k], np.int32)
        np_val[:k] = True
    t = lambda a: torch.as_tensor(a, device=device)
    return cls(t(np_pose), t(np_scale), t(np_lab), t(np_val))

"""Fixed-capacity factor-graph state (PyTorch twin of
slide_slam_tpu/factorgraph/graph.py).

Variables (pose chains for R robots, slot = robot * P + pose_idx; cylinder,
cuboid and point landmarks) and typed factor arrays with validity counts,
all as tensors of fixed capacity. Counts are 0-d int32 tensors, so a
keyframe step never has to read them back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3

OVERFLOW_FIELDS = ("poses", "cylinders", "cuboids", "points",
                   "cylinder_factors", "cuboid_factors", "point_factors",
                   "between_factors")


def _below(n: int, count, device) -> torch.Tensor:
    return torch.arange(n, device=device) < count


class GraphState(NamedTuple):
    poses: torch.Tensor        # [R*P, 7]
    pose_count: torch.Tensor   # [R] int32
    prior_pose: torch.Tensor   # [R, 7]
    prior_valid: torch.Tensor  # [R] bool

    cyl_ray: torch.Tensor      # [NC, 3]
    cyl_root: torch.Tensor     # [NC, 3]
    cyl_radius: torch.Tensor   # [NC]
    cyl_label: torch.Tensor    # [NC] int32
    cyl_hits: torch.Tensor     # [NC] int32
    cyl_count: torch.Tensor    # int32

    cub_pose: torch.Tensor     # [NK, 7]
    cub_scale: torch.Tensor    # [NK, 3]
    cub_label: torch.Tensor    # [NK] int32
    cub_hits: torch.Tensor     # [NK] int32
    cub_count: torch.Tensor    # int32

    pt_pos: torch.Tensor       # [NU, 3]
    pt_scale: torch.Tensor     # [NU, 3]
    pt_label: torch.Tensor     # [NU] int32
    pt_hits: torch.Tensor      # [NU] int32
    pt_count: torch.Tensor     # int32

    odom_rel: torch.Tensor     # [R*P, 7] measured motion (slot-1 -> slot)
    odom_sigma: torch.Tensor   # [R*P, 6]

    bf_i: torch.Tensor         # [NB] int32
    bf_j: torch.Tensor         # [NB] int32
    bf_rel: torch.Tensor       # [NB, 7]
    bf_sigma: torch.Tensor     # [NB, 6]
    bf_count: torch.Tensor     # int32

    cf_pose: torch.Tensor      # [F1] int32
    cf_lm: torch.Tensor        # [F1] int32
    cf_meas: torch.Tensor      # [F1, 7] [ray, root, radius] body frame
    cf_count: torch.Tensor     # int32

    kf_pose: torch.Tensor      # [F2] int32
    kf_lm: torch.Tensor        # [F2] int32
    kf_meas_pose: torch.Tensor   # [F2, 7]
    kf_meas_scale: torch.Tensor  # [F2, 3]
    kf_sigma: torch.Tensor     # [F2, 9]
    kf_count: torch.Tensor     # int32

    uf_pose: torch.Tensor      # [F3] int32
    uf_lm: torch.Tensor        # [F3] int32
    uf_bearing: torch.Tensor   # [F3, 3]
    uf_range: torch.Tensor     # [F3]
    uf_count: torch.Tensor     # int32

    keypose_xyz: torch.Tensor  # [R*P, 3]
    overflow: torch.Tensor     # [8] int32, indexed by OVERFLOW_FIELDS

    @property
    def num_robots(self) -> int:
        return self.prior_pose.shape[0]

    @property
    def poses_per_robot(self) -> int:
        return self.poses.shape[0] // self.prior_pose.shape[0]

    def pose_slot(self, robot, idx):
        """Slot of a robot's idx-th pose (slot = robot * P + idx)."""
        return robot * self.poses_per_robot + idx

    def _slot_parts(self):
        P = self.poses_per_robot
        ar = torch.arange(self.poses.shape[0], device=self.poses.device)
        return ar % P, ar // P

    def pose_valid(self) -> torch.Tensor:
        idx, rid = self._slot_parts()
        return idx < self.pose_count[rid]

    def odom_valid(self) -> torch.Tensor:
        idx, rid = self._slot_parts()
        return (idx >= 1) & (idx < self.pose_count[rid])

    def cyl_valid(self):
        return _below(self.cyl_ray.shape[0], self.cyl_count, self.poses.device)

    def cub_valid(self):
        return _below(self.cub_pose.shape[0], self.cub_count, self.poses.device)

    def pt_valid(self):
        return _below(self.pt_pos.shape[0], self.pt_count, self.poses.device)

    def bf_valid(self):
        return _below(self.bf_i.shape[0], self.bf_count, self.poses.device)

    def cf_valid(self):
        return _below(self.cf_pose.shape[0], self.cf_count, self.poses.device)

    def kf_valid(self):
        return _below(self.kf_pose.shape[0], self.kf_count, self.poses.device)

    def uf_valid(self):
        return _below(self.uf_pose.shape[0], self.uf_count, self.poses.device)

    def cyl_lm7(self) -> torch.Tensor:
        """Landmark cylinders as 7-vectors [ray, root, radius]."""
        return torch.cat([self.cyl_ray, self.cyl_root,
                          self.cyl_radius[:, None]], dim=-1)


def empty_state(cfg: SlamConfig, device="cuda",
                dtype=torch.float32) -> GraphState:
    R = cfg.number_of_robots
    c = cfg.capacity
    P, NC, NK, NU = (c.max_poses_per_robot, c.max_cylinders, c.max_cuboids,
                     c.max_points)
    NB, F1, F2, F3 = (c.max_between_factors, c.max_cylinder_factors,
                      c.max_cuboid_factors, c.max_point_factors)
    f = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)

    def tile(row, n):
        return torch.tensor([row], **f).repeat(n, 1)

    return GraphState(
        poses=se3.identity((R * P,), **f),
        pose_count=torch.zeros((R,), **i32),
        prior_pose=se3.identity((R,), **f),
        prior_valid=torch.zeros((R,), dtype=torch.bool, device=device),
        cyl_ray=tile([0.0, 0.0, 1.0], NC),
        cyl_root=torch.zeros((NC, 3), **f),
        cyl_radius=torch.zeros((NC,), **f),
        cyl_label=torch.zeros((NC,), **i32),
        cyl_hits=torch.zeros((NC,), **i32),
        cyl_count=torch.zeros((), **i32),
        cub_pose=se3.identity((NK,), **f),
        cub_scale=torch.zeros((NK, 3), **f),
        cub_label=torch.zeros((NK,), **i32),
        cub_hits=torch.zeros((NK,), **i32),
        cub_count=torch.zeros((), **i32),
        pt_pos=torch.zeros((NU, 3), **f),
        pt_scale=torch.zeros((NU, 3), **f),
        pt_label=torch.zeros((NU,), **i32),
        pt_hits=torch.zeros((NU,), **i32),
        pt_count=torch.zeros((), **i32),
        odom_rel=se3.identity((R * P,), **f),
        odom_sigma=torch.ones((R * P, 6), **f),
        bf_i=torch.zeros((NB,), **i32),
        bf_j=torch.zeros((NB,), **i32),
        bf_rel=se3.identity((NB,), **f),
        bf_sigma=torch.ones((NB, 6), **f),
        bf_count=torch.zeros((), **i32),
        cf_pose=torch.zeros((F1,), **i32),
        cf_lm=torch.zeros((F1,), **i32),
        cf_meas=torch.zeros((F1, 7), **f),
        cf_count=torch.zeros((), **i32),
        kf_pose=torch.zeros((F2,), **i32),
        kf_lm=torch.zeros((F2,), **i32),
        kf_meas_pose=se3.identity((F2,), **f),
        kf_meas_scale=torch.zeros((F2, 3), **f),
        kf_sigma=torch.ones((F2, 9), **f),
        kf_count=torch.zeros((), **i32),
        uf_pose=torch.zeros((F3,), **i32),
        uf_lm=torch.zeros((F3,), **i32),
        uf_bearing=tile([1.0, 0.0, 0.0], F3),
        uf_range=torch.zeros((F3,), **f),
        uf_count=torch.zeros((), **i32),
        keypose_xyz=torch.zeros((R * P, 3), **f),
        overflow=torch.zeros((8,), **i32),
    )


def noise_arrays(cfg: SlamConfig):
    """The noise config as arrays."""
    n = cfg.noise
    return {
        "odom": np.asarray(n.odom, np.float32),
        "closure": np.asarray(n.odom, np.float32) * n.closure_scale,
        "rel_meas": np.asarray(n.rel_meas, np.float32),
        "cube": np.asarray(n.cube, np.float32),
        "cylinder": np.float32(n.cylinder),
        "bearing": np.float32(n.bearing),
        "floor": np.float32(n.noise_floor),
    }

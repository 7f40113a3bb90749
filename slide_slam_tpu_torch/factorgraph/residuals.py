"""Factor residuals on object-landmark manifolds (PyTorch twin of
slide_slam_tpu/factorgraph/residuals.py).

Batched over leading dims: every argument carries the factor batch in front
of its manifold dims. Conventions: pose tangent [omega, v] with right
retraction; cylinder manifold dim 7 [ray, root, radius]; cuboid dim 9
[se3 log, scale]. Residuals are whitened by 1/sigma outside these functions.
"""
from __future__ import annotations

import torch

from ..geometry import se3


def prior_residual(pose, prior_pose):
    return se3.local(prior_pose, pose)


def between_residual(pose_i, pose_j, measured_rel):
    """Log(measured^-1 * (pose_i^-1 pose_j))."""
    return se3.local(measured_rel, se3.between(pose_i, pose_j))


def cylinder_project(root, ray, radius, pose):
    """Body-frame cylinder -> map frame (CylinderMeasurement::project,
    cylinderFactor.h:71-77): (root, ray, radius)."""
    return se3.apply(pose, root), se3.rotate(pose, ray), radius


def cylinder_residual(pose, lm, meas_local):
    """[lm.ray - R m.ray, lm.root - (R m.root + t), m.radius - lm.radius]."""
    p_root = se3.apply(pose, meas_local[..., 3:6])
    p_ray = se3.rotate(pose, meas_local[..., 0:3])
    return torch.cat([lm[..., 0:3] - p_ray, lm[..., 3:6] - p_root,
                      (meas_local[..., 6] - lm[..., 6])[..., None]], dim=-1)


def cylinder_to_local(lm_world, pose):
    """World-frame cylinder 7-vec -> body frame (graph.cpp:188-190 projects
    by pose^-1 before storing the factor)."""
    inv = se3.inverse(pose)
    return torch.cat([se3.rotate(inv, lm_world[..., 0:3]),
                      se3.apply(inv, lm_world[..., 3:6]),
                      lm_world[..., 6:7]], dim=-1)


def cylinder_retract(lm, delta):
    return lm + delta


def cuboid_residual(pose, lm_pose, lm_scale, meas_pose_local, meas_scale):
    """[Log(lm^-1 (pose m)), m.scale - lm.scale]."""
    proj = se3.compose(pose, meas_pose_local)
    err = se3.log(se3.compose(se3.inverse(lm_pose), proj))
    return torch.cat([err, meas_scale - lm_scale], dim=-1)


def cuboid_retract(lm_pose, lm_scale, delta):
    return se3.retract(lm_pose, delta[..., 0:6]), lm_scale + delta[..., 6:9]


def bearing_range_residual(pose, point, meas_bearing, meas_range):
    """[unit(p_body) - bearing, |p_body| - range]."""
    p_body = se3.apply(se3.inverse(pose), point)
    rng = torch.linalg.norm(p_body, dim=-1)
    direction = p_body / torch.clamp(rng, min=1e-9)[..., None]
    return torch.cat([direction - meas_bearing,
                      (rng - meas_range)[..., None]], dim=-1)

"""Linearization, cost, retraction and PCG (PyTorch twin of the parts of
slide_slam_tpu/factorgraph/solver.py that the Schur solve uses).

Every factor family is linearized as one batch with the analytic Jacobians
(tangent at zero, right retraction p <- p Exp([omega, v])). The anchor pose
of each robot chain is frozen (its tangent rows are projected out) instead
of carrying the reference's sigma=1e-6 prior.

`pcg` mirrors the JAX `lax.while_loop` without a host sync per iteration:
it runs blocks of PCG_BLOCK iterations with a device-side `active` flag
that freezes the carry once the loop would have stopped, and reads the flag
back once per block. The result is identical to the early-exit loop.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import jacobians, se3
from . import residuals as res
from .graph import GraphState

# PCG iterations run between two host reads of the stop flag. At 8 the
# warm-started keyframe solve (which usually stops within 8-16 iterations)
# wastes at most 7 masked iterations, and a 256-iteration thorough solve
# syncs 32 times instead of 256.
PCG_BLOCK = 8


class Tangent(NamedTuple):
    pose: torch.Tensor  # [RP, 6]
    cyl: torch.Tensor   # [NC, 7]
    cub: torch.Tensor   # [NK, 9]
    pt: torch.Tensor    # [NU, 3]


def tree_scale(alpha, x: Tangent) -> Tangent:
    return Tangent(*(alpha * u for u in x))


def _w(sigma):
    return 1.0 / sigma


def _between_lin(pose_i, pose_j, rel, sigma):
    """r = Log(rel^-1 (pi^-1 pj)); Jj = Jr^-1(r), Ji = -Jr^-1(r) Ad(pj^-1 pi)."""
    r_raw = se3.local(rel, se3.between(pose_i, pose_j))
    Jr_inv = jacobians.se3_right_jacobian_inv(r_raw)
    Ji = -Jr_inv @ jacobians.se3_adjoint(se3.between(pose_j, pose_i))
    w = _w(sigma)
    return r_raw * w, Ji * w[..., :, None], Jr_inv * w[..., :, None]


def _cyl_lin(pose, lm7, meas, sigma):
    """r = [lm_ray - R m_ray, lm_root - (R m_root + t), m_rad - lm_rad]."""
    R = se3.quat_to_matrix(se3.quat(pose))
    t = se3.trans(pose)
    m_ray, m_root, m_rad = meas[..., 0:3], meas[..., 3:6], meas[..., 6]
    Rm_ray = (R @ m_ray[..., None])[..., 0]
    Rm_root = (R @ m_root[..., None])[..., 0]
    r = torch.cat([lm7[..., 0:3] - Rm_ray, lm7[..., 3:6] - (Rm_root + t),
                   (m_rad - lm7[..., 6])[..., None]], dim=-1)
    F = pose.shape[0]
    z33 = torch.zeros_like(R)
    Jp = torch.cat([
        torch.cat([R @ se3.skew(m_ray), z33], dim=-1),
        torch.cat([R @ se3.skew(m_root), -R], dim=-1),
        torch.zeros((F, 1, 6), dtype=pose.dtype, device=pose.device),
    ], dim=-2)
    Jl = torch.diag(torch.tensor([1., 1., 1., 1., 1., 1., -1.],
                                 dtype=pose.dtype, device=pose.device))
    w = _w(sigma)
    return r * w, Jp * w, Jl.expand(F, 7, 7) * w


def _cub_lin(pose, lm_pose, lm_scale, m_pose, m_scale, sigma):
    """e = Log(lm^-1 p m): Jp = Jr^-1(e) Ad(m^-1), Jlm = -Jl^-1(e)."""
    T = se3.compose(se3.inverse(lm_pose), se3.compose(pose, m_pose))
    e = se3.log(T)
    r = torch.cat([e, m_scale - lm_scale], dim=-1)
    Jp6 = (jacobians.se3_right_jacobian_inv(e)
           @ jacobians.se3_adjoint(se3.inverse(m_pose)))
    Jl6 = -jacobians.se3_left_jacobian_inv(e)
    F = pose.shape[0]
    kw = dict(dtype=pose.dtype, device=pose.device)
    Jp = torch.cat([Jp6, torch.zeros((F, 3, 6), **kw)], dim=-2)
    z63 = torch.zeros((F, 6, 3), **kw)
    Jl = torch.cat([
        torch.cat([Jl6, z63], dim=-1),
        torch.cat([z63.transpose(1, 2),
                   -torch.eye(3, **kw).expand(F, 3, 3)], dim=-1),
    ], dim=-2)
    w = _w(sigma)
    return r * w, Jp * w[..., :, None], Jl * w[..., :, None]


def _pt_lin(pose, pt, bearing, rng, sigma):
    """p_b = R^T (pt - t); r = [p_b/|p_b| - bearing, |p_b| - rng]."""
    R = se3.quat_to_matrix(se3.quat(pose))
    RT = R.transpose(-1, -2)
    p_b = (RT @ (pt - se3.trans(pose))[..., None])[..., 0]
    n = torch.clamp(torch.linalg.norm(p_b, dim=-1), min=1e-9)
    d = p_b / n[..., None]
    r = torch.cat([d - bearing, (n - rng)[..., None]], dim=-1)
    F = pose.shape[0]
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(F, 3, 3)
    ddir = (eye - d[..., :, None] * d[..., None, :]) / n[..., None, None]
    dpb = torch.cat([se3.skew(p_b), -eye], dim=-1)            # [F, 3, 6]
    Jp = torch.cat([ddir @ dpb, (d[..., None, :] @ dpb)], dim=-2)
    Jl = torch.cat([ddir @ RT, (d[..., None, :] @ RT)], dim=-2)
    w = _w(sigma)
    return r * w, Jp * w, Jl * w


class Linearization(NamedTuple):
    od_r: torch.Tensor; od_Ji: torch.Tensor; od_Jj: torch.Tensor
    od_prev: torch.Tensor
    bf_r: torch.Tensor; bf_Ji: torch.Tensor; bf_Jj: torch.Tensor
    cf_r: torch.Tensor; cf_Jp: torch.Tensor; cf_Jl: torch.Tensor
    kf_r: torch.Tensor; kf_Jp: torch.Tensor; kf_Jl: torch.Tensor
    uf_r: torch.Tensor; uf_Jp: torch.Tensor; uf_Jl: torch.Tensor


def _masked(mask, *arrs):
    return [torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a,
                        torch.zeros((), dtype=a.dtype, device=a.device))
            for a in arrs]


def _prev_slot(s: GraphState):
    RP = s.poses.shape[0]
    return torch.clamp(torch.arange(RP, device=s.poses.device) - 1, min=0)


def _l(idx):
    return idx.long()


def linearize(s: GraphState, cyl_sigma, bearing_sigma) -> Linearization:
    prev = _prev_slot(s)
    od = _masked(s.odom_valid(), *_between_lin(
        s.poses[prev], s.poses, s.odom_rel, s.odom_sigma))
    bf = _masked(s.bf_valid(), *_between_lin(
        s.poses[_l(s.bf_i)], s.poses[_l(s.bf_j)], s.bf_rel, s.bf_sigma))
    cf = _masked(s.cf_valid(), *_cyl_lin(
        s.poses[_l(s.cf_pose)], s.cyl_lm7()[_l(s.cf_lm)], s.cf_meas,
        cyl_sigma))
    kf_lm = _l(s.kf_lm)
    kf = _masked(s.kf_valid(), *_cub_lin(
        s.poses[_l(s.kf_pose)], s.cub_pose[kf_lm], s.cub_scale[kf_lm],
        s.kf_meas_pose, s.kf_meas_scale, s.kf_sigma))
    uf = _masked(s.uf_valid(), *_pt_lin(
        s.poses[_l(s.uf_pose)], s.pt_pos[_l(s.uf_lm)], s.uf_bearing,
        s.uf_range, bearing_sigma))
    return Linearization(*od, prev, *bf, *cf, *kf, *uf)


def _frozen_pose_mask(s: GraphState) -> torch.Tensor:
    """[RP] True where the pose tangent must stay zero (chain anchors)."""
    P = s.poses_per_robot
    ar = torch.arange(s.poses.shape[0], device=s.poses.device)
    return (ar % P == 0) & s.prior_valid[ar // P]


def _project(s: GraphState, v: Tangent) -> Tangent:
    frozen = _frozen_pose_mask(s)
    return v._replace(pose=torch.where(frozen[:, None],
                                       torch.zeros_like(v.pose), v.pose))


def clamp_rows(x: torch.Tensor, max_norm: float = 10.0) -> torch.Tensor:
    """Per-variable trust region: rows above max_norm are scaled back."""
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def cost(s: GraphState, cyl_sigma, bearing_sigma) -> torch.Tensor:
    """Residual-only cost (0-d tensor), used by the line search."""
    prev = _prev_slot(s)
    od = res.between_residual(s.poses[prev], s.poses, s.odom_rel) / s.odom_sigma
    bf = res.between_residual(s.poses[_l(s.bf_i)], s.poses[_l(s.bf_j)],
                              s.bf_rel) / s.bf_sigma
    cf = res.cylinder_residual(s.poses[_l(s.cf_pose)],
                               s.cyl_lm7()[_l(s.cf_lm)], s.cf_meas) / cyl_sigma
    kf_lm = _l(s.kf_lm)
    kf = res.cuboid_residual(s.poses[_l(s.kf_pose)], s.cub_pose[kf_lm],
                             s.cub_scale[kf_lm], s.kf_meas_pose,
                             s.kf_meas_scale) / s.kf_sigma
    uf = res.bearing_range_residual(s.poses[_l(s.uf_pose)],
                                    s.pt_pos[_l(s.uf_lm)], s.uf_bearing,
                                    s.uf_range) / bearing_sigma
    od, bf, cf, kf, uf = (
        _masked(m, r)[0] for m, r in ((s.odom_valid(), od), (s.bf_valid(), bf),
                                      (s.cf_valid(), cf), (s.kf_valid(), kf),
                                      (s.uf_valid(), uf)))
    return 0.5 * (torch.sum(od ** 2) + torch.sum(bf ** 2) + torch.sum(cf ** 2)
                  + torch.sum(kf ** 2) + torch.sum(uf ** 2))


def retract_state(s: GraphState, dx: Tangent) -> GraphState:
    dx = _project(s, dx)
    pv = s.pose_valid()[:, None]
    poses = torch.where(pv, se3.retract(s.poses, dx.pose), s.poses)
    zero = torch.zeros((), dtype=s.poses.dtype, device=s.poses.device)
    cyl7 = s.cyl_lm7() + torch.where(s.cyl_valid()[:, None], dx.cyl, zero)
    cv = s.cub_valid()[:, None]
    cub_pose = torch.where(cv, se3.retract(s.cub_pose, dx.cub[:, :6]),
                           s.cub_pose)
    cub_scale = s.cub_scale + torch.where(cv, dx.cub[:, 6:9], zero)
    pt = s.pt_pos + torch.where(s.pt_valid()[:, None], dx.pt, zero)
    return s._replace(
        poses=poses,
        cyl_ray=cyl7[:, 0:3], cyl_root=cyl7[:, 3:6], cyl_radius=cyl7[:, 6],
        cub_pose=cub_pose, cub_scale=cub_scale, pt_pos=pt,
        keypose_xyz=torch.where(pv, se3.trans(poses), s.keypose_xyz))


def _vdot(a, b):
    return torch.sum(a * b)


def pcg(hv_fn, b: torch.Tensor, precond_apply, max_iters: int, tol: float,
        step_tol: float = 0.0) -> torch.Tensor:
    """Solve H x = b; `precond_apply(r) -> z` applies M^-1.

    Same iteration as the JAX `solver.pcg`: curvature guard, stop after
    three consecutive Krylov steps below `step_tol` (0 disables), relative
    residual stop `rz <= tol^2 rz0`, at most `max_iters` iterations. The
    stop test runs on the device; the host reads it once per PCG_BLOCK
    iterations."""
    x = torch.zeros_like(b)
    r = b
    z = precond_apply(r)
    p = z
    rz = _vdot(r, z)
    tol_t = torch.tensor(tol, dtype=b.dtype, device=b.device)
    thresh = tol_t * tol_t * torch.clamp(rz, min=1e-30)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    small = torch.zeros((), dtype=torch.int32, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    # squared in float32, as the JAX version squares its f32 step_tol
    step_tol_sq = float(np.float32(step_tol) * np.float32(step_tol))
    done_iters = 0
    while done_iters < max_iters:
        for _ in range(min(PCG_BLOCK, max_iters - done_iters)):
            active = (k < max_iters) & (rz > thresh)
            hp = hv_fn(p)
            php = _vdot(p, hp)
            pp = _vdot(p, p)
            curv_ok = php > 1e-12 * pp
            alpha = torch.where(curv_ok, rz / torch.clamp(php, min=1e-30), zero)
            step_sq = (alpha * alpha) * pp
            x_n = x + alpha * p
            r_n = r - alpha * hp
            z_n = precond_apply(r_n)
            rz_new = _vdot(r_n, z_n)
            beta = torch.where(curv_ok, rz_new / torch.clamp(rz, min=1e-30),
                               zero)
            p_n = z_n + beta * p
            step_small = (step_tol > 0.0) & (step_sq < step_tol_sq)
            small_n = torch.where(step_small, small + 1, 0)
            stop = (~curv_ok) | (small_n >= 3)
            rz_n = torch.where(stop, zero, rz_new)
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            z = torch.where(active, z_n, z)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            small = torch.where(active, small_n, small)
            k = k + active.to(torch.int32)
            done_iters += 1
        if not bool((k < max_iters) & (rz > thresh)):
            break
    return x

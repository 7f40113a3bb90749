"""Linearization, cost, retraction, PCG and the unified-variable solve
(PyTorch twin of slide_slam_tpu/factorgraph/solver.py).

Every factor family is linearized as one batch with the analytic Jacobians
(tangent at zero, right retraction p <- p Exp([omega, v])). The anchor pose
of each robot chain is frozen (its tangent rows are projected out) instead
of carrying the reference's sigma=1e-6 prior.

`pcg` mirrors the JAX `lax.while_loop` without a host sync per iteration:
it runs blocks of PCG_BLOCK iterations with a device-side `active` flag
that freezes the carry once the loop would have stopped, and reads the flag
back once per block. The result is identical to the early-exit loop.

`solve` is the unified-variable damped Gauss-Newton (SolverConfig.use_schur
= False): every variable is a row of one [NV, 9] tangent and every factor a
row of one [F, 2, 9, 9] Jacobian array. The JAX version sums factor rows
into variables with bf16x3 one-hot matmuls inside PCG (a TPU workaround);
here every such sum is an exact f32 `index_add_`. Its `axis_name` psum
becomes an explicit `reduce` callable (identity by default) that a sharded
solve passes in: the sum of a tensor over the shards, replicated on each.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import jacobians, se3
from ..runtime.profiling import annotate, host_read, phase
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


def tangent_zeros(s: GraphState) -> Tangent:
    """A zero tangent of the state's variable capacities."""
    z = lambda n, d: torch.zeros((n, d), dtype=s.poses.dtype,
                                 device=s.poses.device)
    return Tangent(pose=z(s.poses.shape[0], 6), cyl=z(s.cyl_ray.shape[0], 7),
                   cub=z(s.cub_pose.shape[0], 9), pt=z(s.pt_pos.shape[0], 3))


def tree_dot(a: Tangent, b: Tangent) -> torch.Tensor:
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


def tree_axpy(alpha, x: Tangent, y: Tangent) -> Tangent:
    return Tangent(*(alpha * u + v for u, v in zip(x, y)))


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


def _identity(x):
    return x


def cost(s: GraphState, cyl_sigma, bearing_sigma,
         reduce=_identity) -> torch.Tensor:
    """Residual-only cost (0-d tensor), used by the line search; `reduce`
    sums it over the shards of a sharded solve."""
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
    return reduce(0.5 * (torch.sum(od ** 2) + torch.sum(bf ** 2)
                         + torch.sum(cf ** 2) + torch.sum(kf ** 2)
                         + torch.sum(uf ** 2)))


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
    with phase("solve.pcg"):
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
            with phase("pcg.block"):
                for _ in range(min(PCG_BLOCK, max_iters - done_iters)):
                    active = (k < max_iters) & (rz > thresh)
                    hp = hv_fn(p)
                    php = _vdot(p, hp)
                    pp = _vdot(p, p)
                    curv_ok = php > 1e-12 * pp
                    alpha = torch.where(curv_ok,
                                        rz / torch.clamp(php, min=1e-30), zero)
                    step_sq = (alpha * alpha) * pp
                    x_n = x + alpha * p
                    r_n = r - alpha * hp
                    z_n = precond_apply(r_n)
                    rz_new = _vdot(r_n, z_n)
                    beta = torch.where(curv_ok,
                                       rz_new / torch.clamp(rz, min=1e-30),
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
                with host_read("pcg_stop"):
                    more = bool((k < max_iters) & (rz > thresh))
            if not more:
                break
        # the device counter itself: read back only when spans are exported
        annotate(pcg_iters=k)
    return x


# ---------------------------------------------------------------------------
# Packed normal equations: one unified variable space, one factor array.
# ---------------------------------------------------------------------------


class Packed(NamedTuple):
    r: torch.Tensor     # [F, 9]       whitened residuals, zero-padded
    J: torch.Tensor     # [F, 2, 9, 9] per-side whitened Jacobians
    idx: torch.Tensor   # [F, 2] int64 unified variable indices


def _var_offsets(s: GraphState):
    RP = s.poses.shape[0]
    NC = s.cyl_ray.shape[0]
    NK = s.cub_pose.shape[0]
    NU = s.pt_pos.shape[0]
    return RP, RP + NC, RP + NC + NK, RP + NC + NK + NU


def _pad_rj(r, J, rdim, vdim):
    return (torch.nn.functional.pad(r, (0, 9 - rdim)),
            torch.nn.functional.pad(J, (0, 9 - vdim, 0, 9 - rdim)))


def pack_indices(s: GraphState) -> torch.Tensor:
    """[F, 2] unified variable indices of every factor (odometry, between,
    cylinder, cuboid, bearing-range), constant over one solve."""
    RP, oc, ok, _ = _var_offsets(s)
    ar = torch.arange(RP, device=s.poses.device)
    return torch.cat([
        torch.stack([torch.clamp(ar - 1, min=0), ar], dim=1),
        torch.stack([s.bf_i.long(), s.bf_j.long()], dim=1),
        torch.stack([s.cf_pose.long(), RP + s.cf_lm.long()], dim=1),
        torch.stack([s.kf_pose.long(), oc + s.kf_lm.long()], dim=1),
        torch.stack([s.uf_pose.long(), ok + s.uf_lm.long()], dim=1),
    ], dim=0)


def pack_linearization(s: GraphState, lin: Linearization,
                       idx: torch.Tensor = None) -> Packed:
    """The typed per-family linearizations as one factor array."""
    od_r, od_J1 = _pad_rj(lin.od_r, lin.od_Ji, 6, 6)
    _, od_J2 = _pad_rj(lin.od_r, lin.od_Jj, 6, 6)
    bf_r, bf_J1 = _pad_rj(lin.bf_r, lin.bf_Ji, 6, 6)
    _, bf_J2 = _pad_rj(lin.bf_r, lin.bf_Jj, 6, 6)
    cf_r, cf_J1 = _pad_rj(lin.cf_r, lin.cf_Jp, 7, 6)
    _, cf_J2 = _pad_rj(lin.cf_r, lin.cf_Jl, 7, 7)
    kf_r, kf_J1 = _pad_rj(lin.kf_r, lin.kf_Jp, 9, 6)
    uf_r, uf_J1 = _pad_rj(lin.uf_r, lin.uf_Jp, 4, 6)
    _, uf_J2 = _pad_rj(lin.uf_r, lin.uf_Jl, 4, 3)
    r = torch.cat([od_r, bf_r, cf_r, kf_r, uf_r], dim=0)
    J = torch.cat([torch.stack([od_J1, od_J2], dim=1),
                   torch.stack([bf_J1, bf_J2], dim=1),
                   torch.stack([cf_J1, cf_J2], dim=1),
                   torch.stack([kf_J1, lin.kf_Jl], dim=1),
                   torch.stack([uf_J1, uf_J2], dim=1)], dim=0)
    return Packed(r, J, pack_indices(s) if idx is None else idx)


def _project_x(s: GraphState, x: torch.Tensor) -> torch.Tensor:
    """Zero the frozen-anchor rows of a unified tangent [NV, 9]."""
    frozen = torch.nn.functional.pad(_frozen_pose_mask(s),
                                     (0, x.shape[0] - s.poses.shape[0]))
    return torch.where(frozen[:, None], torch.zeros_like(x), x)


def x_to_tangent(s: GraphState, x: torch.Tensor) -> Tangent:
    RP, oc, ok, ou = _var_offsets(s)
    return Tangent(pose=x[:RP, :6], cyl=x[RP:oc, :7], cub=x[oc:ok, :9],
                   pt=x[ok:ou, :3])


def _reduce_to_vars(s: GraphState, idx, y):
    """Rows of y [F, 2, D...] summed into [NV, D...] (exact f32)."""
    NV = _var_offsets(s)[3]
    out = torch.zeros((NV,) + tuple(y.shape[2:]), dtype=y.dtype,
                      device=y.device)
    return out.index_add_(0, idx.reshape(-1), y.reshape((-1,) + out.shape[1:]))


def gradient_packed(s: GraphState, p: Packed, reduce=_identity):
    """g = J^T r on the unified space."""
    g = _reduce_to_vars(s, p.idx, torch.einsum("fsij,fi->fsj", p.J, p.r))
    return _project_x(s, reduce(g))


def diagonal_packed(s: GraphState, p: Packed, reduce=_identity):
    """diag(J^T J) per variable row."""
    return reduce(_reduce_to_vars(
        s, p.idx, torch.einsum("fsij,fsij->fsj", p.J, p.J)))


def hessian_vec_packed(s: GraphState, p: Packed, x: torch.Tensor, lam,
                       diag: torch.Tensor, reduce=_identity):
    """(J^T J + lam diag) x: one gather, two einsums, one segment sum; the
    damping uses the already reduced diagonal."""
    x = _project_x(s, x)
    Jv = torch.einsum("fsij,fsj->fi", p.J, x[p.idx])
    hv = reduce(_reduce_to_vars(s, p.idx,
                                torch.einsum("fsij,fi->fsj", p.J, Jv)))
    return _project_x(s, hv + lam * diag * x)


def block_diagonal_packed(s: GraphState, p: Packed, reduce=_identity):
    """Per-variable [9, 9] blocks of J^T J (block-Jacobi preconditioner)."""
    return reduce(_reduce_to_vars(
        s, p.idx, torch.einsum("fski,fskj->fsij", p.J, p.J)))


def _block_precond_inverse(b, lam):
    """Invert (B + lam diag(B) + 1e-6 I) per [9, 9] block."""
    eye = torch.eye(9, dtype=b.dtype, device=b.device)
    diag = torch.diagonal(b, dim1=-2, dim2=-1)
    return torch.linalg.inv(b + lam * diag[..., None] * eye + 1e-6 * eye)


def solve(s: GraphState, *, cyl_sigma: float, bearing_sigma: float,
          outer_iters: int, pcg_iters: int, pcg_tol: float = 1e-6,
          lam: float = 1e-6, rel_tol: float = 1e-6, reduce=_identity,
          block_precond: bool = False, line_search: bool = True,
          step_tol: float = 0.0) -> GraphState:
    """Unified-variable damped Gauss-Newton with the 3-scale backtracking
    line search (JAX solver.solve). The outer loop reads its stop flag on
    the host once per iteration. `reduce` sums over the shards of a
    factor-sharded solve (parallel/distributed_ba.py)."""
    idx = pack_indices(s)
    scales = torch.tensor([1.0, 0.5, 0.25], dtype=s.poses.dtype,
                          device=s.poses.device)
    with phase("solve"):
        for _ in range(int(outer_iters)):
            with phase("solve.build"):
                lin = linearize(s, cyl_sigma, bearing_sigma)
                packed = pack_linearization(s, lin, idx)
                g = gradient_packed(s, packed, reduce)
                diag = diagonal_packed(s, packed, reduce)
                if block_precond:
                    inv_b = _block_precond_inverse(
                        block_diagonal_packed(s, packed, reduce), lam)
                    precond = lambda r: torch.einsum("nij,nj->ni", inv_b, r)
                else:
                    scalar = 1.0 / (diag * (1.0 + lam) + 1e-8)
                    precond = lambda r: r * scalar
            dx = pcg(lambda x: hessian_vec_packed(s, packed, x, lam, diag,
                                                  reduce),
                     -g, precond, pcg_iters, pcg_tol, step_tol)
            dx = x_to_tangent(s, clamp_rows(torch.where(
                torch.isfinite(dx), dx, torch.zeros_like(dx))))
            if not line_search:
                s = retract_state(s, dx)
                continue
            with phase("solve.line_search"):
                c0 = reduce(0.5 * torch.sum(packed.r ** 2))
                costs = torch.stack([
                    cost(retract_state(s, tree_scale(a, dx)), cyl_sigma,
                         bearing_sigma, reduce) for a in scales])
                best = torch.argmin(costs)
                accept = costs[best] < c0
                alpha = torch.where(accept, scales[best], torch.zeros_like(c0))
                improved = (c0 - costs[best]) > rel_tol * (c0 + 1e-9)
                s = retract_state(s, tree_scale(alpha, dx))
                with host_read("accept"):
                    more = bool(accept & improved)
            if not more:
                break
    return s

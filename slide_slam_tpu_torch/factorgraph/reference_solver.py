"""Host-side gold-standard solver (numpy/scipy copy of
slide_slam_tpu/factorgraph/reference_solver.py): full-batch
Levenberg-Marquardt to convergence, float64, sparse normal equations,
NUMERICAL Jacobians.

This is the accuracy oracle the port's solves are held against, on the CPU
and on the machine with the card alike (it needs no JAX). It is
deliberately independent of the port's solvers:

* pure numpy float64 SE(3) (the torch path is f32),
* central-difference numerical Jacobians, the approach of the reference's
  GTSAM factors (gtsam::numericalDerivative21/22, step 1e-6,
  cylinderFactor.cpp:20-51, cubeFactor.cpp:41-51),
* scipy sparse direct solve of the damped normal equations (GTSAM iSAM2
  runs sparse Cholesky, graph.cpp:14-22): no PCG, no preconditioner,
* full-batch LM iterated to convergence, the fixed point iSAM2 tracks.

A GraphState on the card is copied to the host once (`host_state`) and
cast to f64 there; nothing of the oracle runs in f32 or on the card.
Residual definitions match factorgraph/residuals.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from .graph import GraphState

# ---------------------------------------------------------------------------
# float64 SE(3) (self-contained; pose layout [qw qx qy qz tx ty tz])
# ---------------------------------------------------------------------------


def _qmul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _qrot(q, v):
    qv = q[..., 1:4]
    uv = np.cross(qv, v)
    return v + 2.0 * (q[..., :1] * uv + np.cross(qv, uv))


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _compose(a, b):
    q = _qmul(a[..., :4], b[..., :4])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t = _qrot(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t], axis=-1)


def _inverse(p):
    qi = _qconj(p[..., :4])
    return np.concatenate([qi, -_qrot(qi, p[..., 4:7])], axis=-1)


def _skew_apply(w, v):
    return np.cross(w, v)


def _so3_log(q):
    """quat [..,4] -> rotvec [..,3]."""
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    qv = q[..., 1:4]
    n = np.linalg.norm(qv, axis=-1, keepdims=True)
    w = np.clip(q[..., :1], -1.0, 1.0)
    theta = 2.0 * np.arctan2(n, w)
    scale = np.where(n < 1e-12, 2.0 / np.maximum(w, 1e-12), theta / np.maximum(n, 1e-12))
    return scale * qv


def _se3_log(p):
    """pose -> tangent [omega(3), v(3)] with p = Exp([omega, v])."""
    omega = _so3_log(p[..., :4])
    t = p[..., 4:7]
    th2 = np.sum(omega * omega, axis=-1, keepdims=True)
    th = np.sqrt(th2)
    # V^-1 t  with  V = I + a W + b W^2  (left Jacobian of SO(3))
    half = 0.5 * th
    cot_term = np.where(
        th < 1e-6,
        1.0 / 12.0 + th2 / 720.0,
        (1.0 - half * np.cos(half) / np.maximum(np.sin(half), 1e-300))
        / np.maximum(th2, 1e-300))
    Wt = _skew_apply(omega, t)
    WWt = _skew_apply(omega, Wt)
    v = t - 0.5 * Wt + cot_term * WWt
    return np.concatenate([omega, v], axis=-1)


def _so3_exp_quat(omega):
    th = np.linalg.norm(omega, axis=-1, keepdims=True)
    half = 0.5 * th
    w = np.where(th < 1e-9, 1.0 - th * th / 8.0, np.cos(half))
    s = np.where(th < 1e-9, 0.5 - th * th / 48.0,
                 np.sin(half) / np.maximum(th, 1e-300))
    return np.concatenate([w, s * omega], axis=-1)


def _se3_exp(xi):
    omega, v = xi[..., :3], xi[..., 3:6]
    q = _so3_exp_quat(omega)
    th2 = np.sum(omega * omega, axis=-1, keepdims=True)
    th = np.sqrt(th2)
    a = np.where(th < 1e-6, 0.5 - th2 / 24.0,
                 (1.0 - np.cos(th)) / np.maximum(th2, 1e-300))
    b = np.where(th < 1e-6, 1.0 / 6.0 - th2 / 120.0,
                 (th - np.sin(th)) / np.maximum(th2 * th, 1e-300))
    Wv = _skew_apply(omega, v)
    WWv = _skew_apply(omega, Wv)
    t = v + a * Wv + b * WWv
    return np.concatenate([q, t], axis=-1)


def _retract(p, xi):
    return _compose(p, _se3_exp(xi))


# ---------------------------------------------------------------------------
# Batched residuals (definitions == factorgraph/residuals.py)
# ---------------------------------------------------------------------------


def _between_res(pi, pj, rel):
    return _se3_log(_compose(_inverse(rel), _compose(_inverse(pi), pj)))


def _cyl_res(pose, lm7, meas7):
    m_ray, m_root, m_rad = meas7[..., 0:3], meas7[..., 3:6], meas7[..., 6:7]
    p_ray = _qrot(pose[..., :4], m_ray)
    p_root = _qrot(pose[..., :4], m_root) + pose[..., 4:7]
    return np.concatenate([lm7[..., 0:3] - p_ray,
                           lm7[..., 3:6] - p_root,
                           m_rad - lm7[..., 6:7]], axis=-1)


def _cub_res(pose, lm_pose, lm_scale, m_pose, m_scale):
    proj = _compose(pose, m_pose)
    e = _se3_log(_compose(_inverse(lm_pose), proj))
    return np.concatenate([e, m_scale - lm_scale], axis=-1)


def _pt_res(pose, pt, bearing, rng):
    p_body = _qrot(_qconj(pose[..., :4]), pt - pose[..., 4:7])
    n = np.linalg.norm(p_body, axis=-1, keepdims=True)
    d = p_body / np.maximum(n, 1e-12)
    return np.concatenate([d - bearing, n - rng[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Problem extraction from a GraphState snapshot
# ---------------------------------------------------------------------------


@dataclass
class Problem:
    """Active variables + factors pulled off a GraphState (all numpy f64)."""
    poses: np.ndarray        # [Np, 7] active pose values
    pose_slot: np.ndarray    # [Np] original slot ids
    frozen: np.ndarray       # [Np] bool (gauge anchors)
    cyl: np.ndarray          # [Nc, 7] [ray, root, radius]
    cub_pose: np.ndarray     # [Nk, 7]
    cub_scale: np.ndarray    # [Nk, 3]
    pt: np.ndarray           # [Nu, 3]
    # factors (indices into the ACTIVE arrays above)
    od_i: np.ndarray; od_j: np.ndarray; od_rel: np.ndarray; od_sigma: np.ndarray
    bf_i: np.ndarray; bf_j: np.ndarray; bf_rel: np.ndarray; bf_sigma: np.ndarray
    cf_pose: np.ndarray; cf_lm: np.ndarray; cf_meas: np.ndarray
    kf_pose: np.ndarray; kf_lm: np.ndarray
    kf_meas_pose: np.ndarray; kf_meas_scale: np.ndarray; kf_sigma: np.ndarray
    uf_pose: np.ndarray; uf_lm: np.ndarray
    uf_bearing: np.ndarray; uf_range: np.ndarray
    cyl_sigma: float
    bearing_sigma: float


def host_state(state) -> SimpleNamespace:
    """Every GraphState field as a host numpy array, copied off the device
    once. Takes a GraphState of tensors (any device) or of arrays, or a
    dict of arrays (convert.state_to_numpy)."""
    get = state.get if isinstance(state, dict) else (
        lambda k: getattr(state, k))

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)
    return SimpleNamespace(**{k: host(get(k)) for k in GraphState._fields})


def extract_problem(state, cyl_sigma: float, bearing_sigma: float,
                    from_odometry: bool = False) -> Problem:
    """Pull the active sub-problem off a GraphState (moved to the host
    first, see host_state).

    from_odometry=True replaces the pose initial values with dead-reckoned
    odometry composition per robot chain — a solver-neutral init proving the
    reference optimum is not just a copy of the engine's estimate."""
    state = host_state(state)
    f64 = lambda a: np.asarray(a, np.float64)
    pose_count = np.asarray(state.pose_count)
    R = pose_count.shape[0]
    P = np.asarray(state.poses).shape[0] // R
    slots = []
    frozen = []
    for r in range(R):
        for i in range(int(pose_count[r])):
            slots.append(r * P + i)
            frozen.append(i == 0 and bool(np.asarray(state.prior_valid)[r]))
    slots = np.asarray(slots, np.int64)
    slot_to_active = -np.ones(R * P, np.int64)
    slot_to_active[slots] = np.arange(len(slots))
    poses = f64(np.asarray(state.poses))[slots]

    odom_rel = f64(np.asarray(state.odom_rel))
    if from_odometry:
        poses = poses.copy()
        for r in range(R):
            n = int(pose_count[r])
            for i in range(1, n):
                a = slot_to_active[r * P + i]
                prev = slot_to_active[r * P + i - 1]
                poses[a] = _compose(poses[prev], odom_rel[r * P + i])

    # odometry chain factors
    od_i, od_j = [], []
    for r in range(R):
        for i in range(1, int(pose_count[r])):
            od_i.append(slot_to_active[r * P + i - 1])
            od_j.append(slot_to_active[r * P + i])
    od_j_slots = [slots[j] for j in od_j]

    nb = int(state.bf_count)
    nc = int(state.cyl_count)
    nk = int(state.cub_count)
    nu = int(state.pt_count)
    ncf = int(state.cf_count)
    nkf = int(state.kf_count)
    nuf = int(state.uf_count)

    cyl7 = np.concatenate([
        f64(np.asarray(state.cyl_ray))[:nc],
        f64(np.asarray(state.cyl_root))[:nc],
        f64(np.asarray(state.cyl_radius))[:nc, None]], axis=-1)

    return Problem(
        poses=poses, pose_slot=slots, frozen=np.asarray(frozen, bool),
        cyl=cyl7,
        cub_pose=f64(np.asarray(state.cub_pose))[:nk],
        cub_scale=f64(np.asarray(state.cub_scale))[:nk],
        pt=f64(np.asarray(state.pt_pos))[:nu],
        od_i=np.asarray(od_i, np.int64), od_j=np.asarray(od_j, np.int64),
        od_rel=odom_rel[od_j_slots].reshape(-1, 7),
        od_sigma=f64(np.asarray(state.odom_sigma))[od_j_slots].reshape(-1, 6),
        bf_i=slot_to_active[np.asarray(state.bf_i)[:nb]],
        bf_j=slot_to_active[np.asarray(state.bf_j)[:nb]],
        bf_rel=f64(np.asarray(state.bf_rel))[:nb],
        bf_sigma=f64(np.asarray(state.bf_sigma))[:nb],
        cf_pose=slot_to_active[np.asarray(state.cf_pose)[:ncf]],
        cf_lm=np.asarray(state.cf_lm)[:ncf].astype(np.int64),
        cf_meas=f64(np.asarray(state.cf_meas))[:ncf],
        kf_pose=slot_to_active[np.asarray(state.kf_pose)[:nkf]],
        kf_lm=np.asarray(state.kf_lm)[:nkf].astype(np.int64),
        kf_meas_pose=f64(np.asarray(state.kf_meas_pose))[:nkf],
        kf_meas_scale=f64(np.asarray(state.kf_meas_scale))[:nkf],
        kf_sigma=f64(np.asarray(state.kf_sigma))[:nkf],
        uf_pose=slot_to_active[np.asarray(state.uf_pose)[:nuf]],
        uf_lm=np.asarray(state.uf_lm)[:nuf].astype(np.int64),
        uf_bearing=f64(np.asarray(state.uf_bearing))[:nuf],
        uf_range=f64(np.asarray(state.uf_range))[:nuf],
        cyl_sigma=float(cyl_sigma), bearing_sigma=float(bearing_sigma),
    )


# ---------------------------------------------------------------------------
# Whitened residual vector + numerical Jacobian assembly
# ---------------------------------------------------------------------------


class _Vars:
    """Flat tangent layout: poses (6 each) | cyl (7) | cub (9) | pt (3)."""

    def __init__(self, p: Problem):
        self.np_, self.nc = len(p.poses), len(p.cyl)
        self.nk, self.nu = len(p.cub_pose), len(p.pt)
        self.off_pose = 0
        self.off_cyl = self.off_pose + 6 * self.np_
        self.off_cub = self.off_cyl + 7 * self.nc
        self.off_pt = self.off_cub + 9 * self.nk
        self.dim = self.off_pt + 3 * self.nu

    def apply(self, p: Problem, dx: np.ndarray) -> Problem:
        dxp = dx[self.off_pose:self.off_cyl].reshape(-1, 6)
        dxc = dx[self.off_cyl:self.off_cub].reshape(-1, 7)
        dxk = dx[self.off_cub:self.off_pt].reshape(-1, 9)
        dxu = dx[self.off_pt:].reshape(-1, 3)
        dxp = np.where(p.frozen[:, None], 0.0, dxp)
        poses = _retract(p.poses, dxp) if self.np_ else p.poses
        return Problem(**{**p.__dict__,
                          "poses": poses,
                          "cyl": p.cyl + dxc,
                          "cub_pose": _retract(p.cub_pose, dxk[:, :6])
                          if self.nk else p.cub_pose,
                          "cub_scale": p.cub_scale + dxk[:, 6:9],
                          "pt": p.pt + dxu})


def _family_specs(p: Problem):
    """Per factor family: gathered per-factor argument arrays, a residual
    function of those arguments, and Jacobian block specs.

    Each factor row owns a PRIVATE COPY of its variables' values (gathered
    by fancy indexing), so a batched perturbation of one argument position
    never leaks into other rows through a shared variable — this is what
    makes the central differences vectorizable over the factor axis.

    Block spec: (var_kind, var_idx [F], arg_position, mode, col_off, tdim)
    where mode is 'retract' (SE(3) right-perturbation) or 'add'."""
    specs = []
    if len(p.od_i):
        specs.append((
            (p.poses[p.od_i], p.poses[p.od_j]),
            lambda ai, aj: _between_res(ai, aj, p.od_rel) / p.od_sigma,
            [("pose", p.od_i, 0, "retract", 0, 6),
             ("pose", p.od_j, 1, "retract", 0, 6)]))
    if len(p.bf_i):
        specs.append((
            (p.poses[p.bf_i], p.poses[p.bf_j]),
            lambda ai, aj: _between_res(ai, aj, p.bf_rel) / p.bf_sigma,
            [("pose", p.bf_i, 0, "retract", 0, 6),
             ("pose", p.bf_j, 1, "retract", 0, 6)]))
    if len(p.cf_pose):
        specs.append((
            (p.poses[p.cf_pose], p.cyl[p.cf_lm]),
            lambda a, l: _cyl_res(a, l, p.cf_meas) / p.cyl_sigma,
            [("pose", p.cf_pose, 0, "retract", 0, 6),
             ("cyl", p.cf_lm, 1, "add", 0, 7)]))
    if len(p.kf_pose):
        specs.append((
            (p.poses[p.kf_pose], p.cub_pose[p.kf_lm], p.cub_scale[p.kf_lm]),
            lambda a, lp, ls: _cub_res(a, lp, ls, p.kf_meas_pose,
                                       p.kf_meas_scale) / p.kf_sigma,
            [("pose", p.kf_pose, 0, "retract", 0, 6),
             ("cub", p.kf_lm, 1, "retract", 0, 6),
             ("cub", p.kf_lm, 2, "add", 6, 3)]))
    if len(p.uf_pose):
        specs.append((
            (p.poses[p.uf_pose], p.pt[p.uf_lm]),
            lambda a, l: _pt_res(a, l, p.uf_bearing, p.uf_range)
            / p.bearing_sigma,
            [("pose", p.uf_pose, 0, "retract", 0, 6),
             ("pt", p.uf_lm, 1, "add", 0, 3)]))
    return specs


def residual_vector(p: Problem) -> np.ndarray:
    parts = [fn(*args).ravel() for args, fn, _ in _family_specs(p)]
    return np.concatenate(parts) if parts else np.zeros(0)


def cost(p: Problem) -> float:
    r = residual_vector(p)
    return 0.5 * float(r @ r)


def _perturb_arg(arg: np.ndarray, k: int, h: float, mode: str) -> np.ndarray:
    if mode == "retract":
        delta = np.zeros((len(arg), 6))
        delta[:, k] = h
        return _retract(arg, delta)
    out = arg.copy()
    out[:, k] += h
    return out


def _numeric_jacobian(p: Problem, v: _Vars, h: float = 1e-6):
    """Sparse whitened J by central differences, batched over the factor
    axis (per-row private argument copies — see _family_specs)."""
    rows, cols, vals = [], [], []
    row_off = 0
    offs = {"pose": (v.off_pose, 6), "cyl": (v.off_cyl, 7),
            "cub": (v.off_cub, 9), "pt": (v.off_pt, 3)}
    for args, fn, blocks in _family_specs(p):
        F, rdim = fn(*args).shape
        for kind, idx, apos, mode, col_off, tdim in blocks:
            base, stride = offs[kind]
            for k in range(tdim):
                ap = list(args); am = list(args)
                ap[apos] = _perturb_arg(args[apos], k, +h, mode)
                am[apos] = _perturb_arg(args[apos], k, -h, mode)
                dr = (fn(*ap) - fn(*am)) / (2.0 * h)     # [F, rdim]
                rows.append((row_off + np.arange(F)[:, None] * rdim
                             + np.arange(rdim)[None, :]).ravel())
                cols.append(np.broadcast_to(
                    (base + idx * stride + col_off + k)[:, None],
                    (F, rdim)).ravel())
                vals.append(dr.ravel())
        row_off += F * rdim
    n_rows = row_off
    if not rows:
        return sp.csr_matrix((0, v.dim))
    J = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_rows, v.dim)).tocsr()
    return J


def solve_reference(state, *, cyl_sigma: float, bearing_sigma: float,
                    from_odometry: bool = False,
                    max_iters: int = 50, tol: float = 1e-12,
                    verbose: bool = False) -> Tuple[np.ndarray, Dict]:
    """Full-batch LM to convergence. Returns (poses [RP,7] f64 with solved
    values scattered back into slot layout, info dict)."""
    state = host_state(state)
    p = extract_problem(state, cyl_sigma, bearing_sigma,
                        from_odometry=from_odometry)
    v = _Vars(p)
    lam = 1e-6
    c = cost(p)
    info = {"initial_cost": c, "iters": 0}
    frozen_cols = np.zeros(v.dim, bool)
    fro = np.where(p.frozen)[0]
    for a in fro:
        frozen_cols[v.off_pose + 6 * a: v.off_pose + 6 * a + 6] = True

    rel = 0.0
    for it in range(max_iters):
        J = _numeric_jacobian(p, v)
        r = residual_vector(p)
        g = J.T @ r
        H = (J.T @ J).tocsc()
        dH = H.diagonal()
        # gauge fixing: freeze anchor columns via unit diagonal + zero grad
        g[frozen_cols] = 0.0
        accepted = False
        for _ in range(8):
            damp = sp.diags(lam * np.maximum(dH, 1e-12)
                            + frozen_cols * 1e6 + 1e-12)
            try:
                dx = spla.spsolve(H + damp, -g)
            except Exception:
                lam *= 10.0
                continue
            dx = np.nan_to_num(dx)
            trial = v.apply(p, dx)
            c_new = cost(trial)
            if c_new < c:
                rel = (c - c_new) / max(c, 1e-300)
                p, c = trial, c_new
                lam = max(lam * 0.3, 1e-12)
                accepted = True
                break
            lam *= 10.0
        info["iters"] = it + 1
        if verbose:
            print(f"  LM iter {it}: cost={c:.6e} lam={lam:.1e}")
        if not accepted or rel < tol:
            break

    info["final_cost"] = c
    out = np.asarray(state.poses, np.float64).copy()
    out[p.pose_slot] = p.poses
    info["landmarks"] = {"cyl": p.cyl, "cub_pose": p.cub_pose,
                         "cub_scale": p.cub_scale, "pt": p.pt}
    return out, info

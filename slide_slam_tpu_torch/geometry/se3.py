"""Batched SE(3) math on tensors (PyTorch twin of slide_slam_tpu/geometry/se3.py).

Pose layout ``[qw, qx, qy, qz, tx, ty, tz]`` over any batch shape ``[..., 7]``;
tangent vectors follow the GTSAM order ``xi = [omega(3), v(3)]``. Small-angle
branches are ``torch.where`` selections with Taylor fallbacks, so every
function is branch-free and works on any device.
"""
from __future__ import annotations

import torch

QUAT = slice(0, 4)
TRANS = slice(4, 7)

_EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def identity(shape=(), dtype=torch.float32, device="cpu"):
    p = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    p[..., 0] = 1.0
    return p


def from_quat_trans(quat_wxyz, trans_):
    return torch.cat([quat_wxyz, trans_], dim=-1)


def quat(pose):
    return pose[..., QUAT]


def trans(pose):
    return pose[..., TRANS]


def quat_mul(q1, q2):
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    w2, x2, y2, z2 = torch.movedim(q2, -1, 0)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q):
    # no sign vector made from host data: its host-to-device copy waits for
    # the card, and a CUDA graph cannot capture it (solver's line search)
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_normalize(q):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonical sign (w >= 0) so log is continuous
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q. Shapes broadcast."""
    qv = q[..., 1:4]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = torch.movedim(q, -1, 0)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_from_matrix(m):
    """Rotation matrix [..., 3, 3] -> quaternion (w,x,y,z). Branch-free."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    picked = torch.gather(cand, -2, idx)[..., 0, :]
    return quat_normalize(picked)


def skew(v):
    zeros = torch.zeros_like(v[..., 0])
    r = torch.stack([zeros, -v[..., 2], v[..., 1],
                     v[..., 2], zeros, -v[..., 0],
                     -v[..., 1], v[..., 0], zeros], dim=-1)
    return r.reshape(v.shape[:-1] + (3, 3))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp_quat(omega):
    """Axis-angle [...,3] -> quaternion."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    half = 0.5 * theta
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w, s * omega], dim=-1)


def so3_log(q):
    """Quaternion -> axis-angle [...,3]."""
    q = quat_normalize(q)
    w = q[..., :1]
    v = q[..., 1:4]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=_EPS * _EPS))
    small = vn2 < 1e-10
    angle = 2.0 * torch.atan2(vn, w)
    factor = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return factor * v


def _so3_left_jacobian(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = skew(omega)
    W2 = W @ W
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return _eye3(omega) + a * W + b * W2


def _so3_left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = skew(omega)
    W2 = W @ W
    small = theta2 < 1e-8
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta))
        / theta2)
    return _eye3(omega) - 0.5 * W + cot_term * W2


def compose(a, b):
    """a ∘ b."""
    qa, ta = quat(a), trans(a)
    qb, tb = quat(b), trans(b)
    return from_quat_trans(quat_normalize(quat_mul(qa, qb)),
                           quat_rotate(qa, tb) + ta)


def inverse(p):
    qi = quat_conj(quat(p))
    return from_quat_trans(qi, -quat_rotate(qi, trans(p)))


def apply(p, pts):
    """Transform point(s) [...,3] by pose(s) [...,7]; shapes broadcast."""
    return quat_rotate(quat(p), pts) + trans(p)


def rotate(p, vecs):
    return quat_rotate(quat(p), vecs)


def exp(xi):
    """xi = [omega, v] [...,6] -> pose [...,7]."""
    omega, v = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, v)
    return from_quat_trans(q, t)


def log(p):
    """pose [...,7] -> xi = [omega, v] [...,6]."""
    omega = so3_log(quat(p))
    Vinv = _so3_left_jacobian_inv(omega)
    v = torch.einsum("...ij,...j->...i", Vinv, trans(p))
    return torch.cat([omega, v], dim=-1)


def retract(p, xi):
    """Right retraction p ∘ Exp(xi) — GTSAM Pose3 convention."""
    return compose(p, exp(xi))


def local(p, q):
    """Log(p⁻¹ ∘ q)."""
    return log(compose(inverse(p), q))


def between(a, b):
    """a⁻¹ ∘ b."""
    return compose(inverse(a), b)


def matrix(p):
    """pose [...,7] -> homogeneous [...,4,4]."""
    R = quat_to_matrix(quat(p))
    t = trans(p)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m):
    return from_quat_trans(quat_from_matrix(m[..., :3, :3]), m[..., :3, 3])


def from_xyz_yaw(x, y, z, yaw, device=None):
    """SE(3) with a yaw-only rotation, f32 (numbers or tensors of one
    shape; `device` for numbers)."""
    x, y, z, yaw = (torch.as_tensor(v, dtype=torch.float32, device=device)
                    for v in (x, y, z, yaw))
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    q = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
    return from_quat_trans(q, torch.stack([x, y, z], dim=-1))


def yaw_of(p):
    """Yaw angle of the rotation (atan2 of rotation-matrix entries)."""
    R = quat_to_matrix(quat(p))
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])

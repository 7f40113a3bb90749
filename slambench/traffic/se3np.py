"""Frozen copy of slide_slam_tpu_torch/geometry/se3np.py (commit e8ab756):
pure-numpy SE(3) for the benchmark's traffic generators and references.

Pose layout [qw, qx, qy, qz, tx, ty, tz]; tangent [omega, v]. Kept here so
that the yardstick does not move when the program's copy changes.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def identity(shape=()):
    p = np.zeros(tuple(shape) + (7,), np.float32)
    p[..., 0] = 1.0
    return p


def quat(p):
    return p[..., 0:4]


def trans(p):
    return p[..., 4:7]


def quat_mul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_conj(q):
    return q * np.array([1.0, -1, -1, -1], q.dtype)


def quat_normalize(q):
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = q / np.maximum(n, _EPS)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def quat_rotate(q, v):
    qv = q[..., 1:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def compose(a, b):
    return np.concatenate([
        quat_normalize(quat_mul(quat(a), quat(b))),
        quat_rotate(quat(a), trans(b)) + trans(a)], axis=-1).astype(np.float32)


def inverse(p):
    qi = quat_conj(quat(p))
    return np.concatenate([qi, -quat_rotate(qi, trans(p))],
                          axis=-1).astype(np.float32)


def apply(p, pts):
    return quat_rotate(quat(p), pts) + trans(p)


def rotate(p, vecs):
    return quat_rotate(quat(p), vecs)


def between(a, b):
    return compose(inverse(a), b)


def from_xyz_yaw(x, y, z, yaw):
    half = 0.5 * np.asarray(yaw)
    q = np.stack([np.cos(half), np.zeros_like(half), np.zeros_like(half),
                  np.sin(half)], axis=-1)
    t = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64),
                  np.asarray(z, np.float64)], axis=-1)
    return np.concatenate([q, t], axis=-1).astype(np.float32)


def quat_to_matrix(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix(p):
    R = quat_to_matrix(quat(p))
    out = np.zeros(p.shape[:-1] + (4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = trans(p)
    out[..., 3, 3] = 1.0
    return out


def quat_from_matrix(m):
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        qw = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        qw = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        qw = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    return quat_normalize(np.array([qw, qx, qy, qz]))


def from_matrix(m):
    m = np.asarray(m)
    return np.concatenate([quat_from_matrix(m[:3, :3]),
                           m[:3, 3]]).astype(np.float32)


def so3_exp_quat(omega):
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    small = theta < 1e-6
    half = 0.5 * theta
    w = np.where(small, 1.0 - theta ** 2 / 8.0, np.cos(half))
    s = np.where(small, 0.5 - theta ** 2 / 48.0,
                 np.sin(half) / np.maximum(theta, _EPS))
    return np.concatenate([w, s * omega], axis=-1)


def _so3_left_jacobian(omega):
    theta2 = float(np.dot(omega, omega))
    W = np.array([[0, -omega[2], omega[1]],
                  [omega[2], 0, -omega[0]],
                  [-omega[1], omega[0], 0]])
    if theta2 < 1e-10:
        return np.eye(3) + 0.5 * W
    theta = np.sqrt(theta2)
    W2 = W @ W
    a = (1 - np.cos(theta)) / theta2
    b = (theta - np.sin(theta)) / (theta2 * theta)
    return np.eye(3) + a * W + b * W2


def exp(xi):
    xi = np.asarray(xi, np.float64)
    omega, v = xi[:3], xi[3:6]
    q = so3_exp_quat(omega)
    t = _so3_left_jacobian(omega) @ v
    return np.concatenate([q, t]).astype(np.float32)


def retract(p, xi):
    return compose(p, exp(xi))


def yaw_of(p):
    R = quat_to_matrix(quat(p))
    return np.arctan2(R[..., 1, 0], R[..., 0, 0])

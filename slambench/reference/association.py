"""Cylinder data association of one keyframe, written plainly.

The upstream map manager's greedy matcher (cylinderMapManager.cpp): the
keyframe's pose estimate is the previous optimised pose composed with the
odometry increment (the odometry pose itself at the first keyframe); the
scan's cylinders go to the world frame through it; the submap is the K
landmarks whose roots lie nearest the pose (ties to the lower index);
the distance of two cylinders is the least, over the heights 0, 3 and 6
m, of the distance between their axes at that height, and 1000 across
labels; each measurement takes its nearest submap landmark when that lies
under the match threshold, else none. Float64 on the host.
"""
from __future__ import annotations

import numpy as np

from .precision import exact

BIG = 1.0e3
HEIGHTS = (0.0, 3.0, 6.0)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _rot(q, v):
    qv = q[1:4]
    uv = np.cross(qv, v)
    return v + 2.0 * (q[0] * uv + np.cross(qv, uv))


def compose(a, b):
    q = _qmul(a[:4], b[:4])
    return np.concatenate([q / np.linalg.norm(q), _rot(a[:4], b[4:7]) + a[4:7]])


def inverse(p):
    qi = p[:4] * np.array([1.0, -1.0, -1.0, -1.0])
    return np.concatenate([qi, -_rot(qi, p[4:7])])


def _axis_at(root, ray, h):
    rz = ray[..., 2]
    den = np.where(np.abs(rz) < 1e-6, np.sign(rz) * 1e-6 + 1e-12, rz)
    return root + ((h - root[..., 2]) / den)[..., None] * ray


def distances(roots_a, rays_a, lab_a, roots_b, rays_b, lab_b, rnd=exact):
    d = None
    for h in HEIGHTS:
        pa = rnd(_axis_at(roots_a, rays_a, h))
        pb = rnd(_axis_at(roots_b, rays_b, h))
        diff = rnd(pa[:, None, :] - pb[None, :, :])
        dh = np.sqrt((diff * diff).sum(-1))
        d = dh if d is None else np.minimum(d, dh)
    return np.where(lab_a[:, None] == lab_b[None, :], d, BIG)


def associate(prev_pose, prev_odom, odom, meas, landmarks, k: int,
              thresh: float, rnd=exact):
    """Match decisions of one keyframe. prev_pose: the previous optimised
    pose (None at the first keyframe); prev_odom / odom: the odometry poses
    of the previous and this keyframe; meas: body-frame cyl_root, cyl_ray,
    cyl_label rows; landmarks: root, ray, label of the map's landmarks.
    Returns (match [S] global index or -1, best distance [S], runner-up
    distance [S])."""
    f = lambda a: np.asarray(a, np.float64)
    if prev_pose is None:
        pose = f(odom)
    else:
        pose = compose(f(prev_pose), compose(inverse(f(prev_odom)), f(odom)))
    pose = rnd(pose)
    q = pose[:4]
    roots = rnd(np.stack([_rot(q, r) for r in f(meas["cyl_root"])]) +
                pose[4:7]) if len(meas["cyl_root"]) else np.zeros((0, 3))
    rays = rnd(np.stack([_rot(q, r) for r in f(meas["cyl_ray"])])
               ) if len(meas["cyl_ray"]) else np.zeros((0, 3))
    lm_root, lm_ray = rnd(f(landmarks["root"])), rnd(f(landmarks["ray"]))
    S = len(roots)
    if len(lm_root) == 0 or S == 0:
        return (np.full(S, -1), np.full(S, BIG), np.full(S, BIG))
    dq = rnd(lm_root - pose[4:7])
    d2 = (dq[:, 0] * dq[:, 0] + dq[:, 1] * dq[:, 1]) + dq[:, 2] * dq[:, 2]
    sub = np.argsort(d2, kind="stable")[:k]
    d = distances(roots, rays, np.asarray(meas["cyl_label"]), lm_root[sub],
                  lm_ray[sub], np.asarray(landmarks["label"])[sub], rnd)
    order = np.argsort(d, axis=1, kind="stable")
    best = d[np.arange(S), order[:, 0]]
    second = (d[np.arange(S), order[:, 1]] if d.shape[1] > 1
              else np.full(S, BIG))
    match = np.where(best < thresh, sub[order[:, 0]], -1)
    return match, best, second

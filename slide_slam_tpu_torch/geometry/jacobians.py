"""Closed-form SE(3)/SO(3) Jacobians (tangent order [omega, v]).

PyTorch twin of slide_slam_tpu/geometry/jacobians.py: right retraction
X <- X * Exp(xi), Barfoot's Q matrix (eq. 7.86) adapted to [omega, v].
"""
from __future__ import annotations

import torch

from . import se3


def _theta2(omega):
    return torch.sum(omega * omega, dim=-1)[..., None, None]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_left_jacobian(omega):
    th2 = _theta2(omega)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    W = se3.skew(omega)
    W2 = W @ W
    small = th2 < 1e-8
    a = torch.where(small, 0.5 - th2 / 24.0, (1 - torch.cos(th)) / th2)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2 * th))
    return _eye(3, omega) + a * W + b * W2


def so3_left_jacobian_inv(omega):
    th2 = _theta2(omega)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    W = se3.skew(omega)
    W2 = W @ W
    small = th2 < 1e-8
    half = 0.5 * th
    cot_term = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / th2)
    return _eye(3, omega) - 0.5 * W + cot_term * W2


def se3_Q(omega, v):
    """Off-diagonal block of the SE(3) left Jacobian (Barfoot 7.86)."""
    th2 = _theta2(omega)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    small = th2 < 1e-8
    W = se3.skew(omega)
    V = se3.skew(v)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    th3 = th2 * th
    th4 = th2 * th2
    th5 = th4 * th
    c1 = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                     (th - torch.sin(th)) / th3)
    c2 = torch.where(small, 1.0 / 24.0 - th2 / 720.0,
                     (1.0 - 0.5 * th2 - torch.cos(th)) / th4)
    c3 = torch.where(small, -(1.0 / 120.0) + th2 / 2520.0,
                     (th - torch.sin(th) - th3 / 6.0) / th5)
    c4 = 0.5 * (c2 - 3.0 * c3)
    return (0.5 * V
            + c1 * (WV + VW + WVW)
            - c2 * (W @ W @ V + V @ W @ W - 3.0 * WVW)
            - c4 * (WVW @ W + W @ WVW))


def se3_left_jacobian_inv(xi):
    omega, v = xi[..., :3], xi[..., 3:6]
    Jinv = so3_left_jacobian_inv(omega)
    Q = se3_Q(omega, v)
    top = torch.cat([Jinv, torch.zeros_like(Jinv)], dim=-1)
    bottom = torch.cat([-Jinv @ Q @ Jinv, Jinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_right_jacobian_inv(xi):
    """Jr^{-1}(xi) = Jl^{-1}(-xi)."""
    return se3_left_jacobian_inv(-xi)


def se3_adjoint(pose):
    """Ad_T as a 6x6 on [omega, v]: [R 0; [t]x R  R]."""
    R = se3.quat_to_matrix(se3.quat(pose))
    tx = se3.skew(se3.trans(pose))
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([tx @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)

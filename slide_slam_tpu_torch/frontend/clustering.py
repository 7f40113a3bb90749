"""Euclidean clustering (DBSCAN): the CUDA kernel and its plain PyTorch version.

`dbscan` dispatches on the device of its input: a CPU tensor goes to
`dbscan_reference`, a CUDA tensor to the hand-written kernel
(csrc/dbscan.cu, replacing the Pallas kernel
slide_slam_tpu/frontend/clustering_pallas.py `_dbscan_kernel`). There is no
fallback: a CUDA tensor that the kernel cannot take raises.

Both compute slide_slam_tpu/frontend/clustering.dbscan exactly: dense
eps-adjacency from coordinate differences, core test degree >= min_samples,
synchronous min-label propagation over core-core edges with early exit and a
cap of `max_iters` sweeps, border points to their min core-neighbour label,
noise and invalid points -1; a cluster's id is its lowest member index.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

MAX_POINTS = 1024


def _eps2(eps: float) -> np.float32:
    # the JAX function squares eps in float32
    return np.float32(eps) * np.float32(eps)


def dbscan_reference(points: torch.Tensor, valid: torch.Tensor, eps: float,
                     min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """points [N, D], valid [N] -> labels [N] int32 (-1 noise/invalid)."""
    n = points.shape[0]
    d = points[:, None, :] - points[None, :, :]
    d2 = d[..., 0] * d[..., 0]
    for k in range(1, points.shape[1]):
        d2 = d2 + d[..., k] * d[..., k]
    ok = valid[:, None] & valid[None, :]
    nbr = ok & (d2 <= torch.as_tensor(_eps2(eps), device=points.device))
    core = valid & (nbr.sum(dim=1) >= min_samples)
    core_edge = nbr & core[:, None] & core[None, :]
    inf = n + 1
    ar = torch.arange(n, dtype=torch.int32, device=points.device)
    labels = torch.where(core, ar, inf)
    full_inf = torch.full((n, n), inf, dtype=torch.int32,
                          device=points.device)
    for _ in range(max_iters):
        neigh = torch.where(core_edge, labels[None, :], full_inf)
        new = torch.minimum(labels, neigh.min(dim=1).values)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    border = torch.where(nbr & core[None, :], labels[None, :],
                         full_inf).min(dim=1).values
    out = torch.where(core, labels, torch.where(border < inf, border, -1))
    return torch.where(valid, out, -1).to(torch.int32)


def dbscan_cuda(points: torch.Tensor, valid: torch.Tensor, eps: float,
                min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """The CUDA kernel on points [N, 3] (N <= 1024) lying on the card.

    Launches on the current stream without synchronising. Each launch adds
    one to `dbscan_cuda.launches`."""
    n, dim = points.shape
    if not points.is_cuda or not valid.is_cuda:
        raise ValueError("dbscan_cuda takes CUDA tensors")
    if dim != 3:
        raise ValueError(f"dbscan_cuda takes 3-D points, got D={dim}")
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"dbscan_cuda takes 1..{MAX_POINTS} points, got {n}")
    if tuple(valid.shape) != (n,) or valid.device != points.device:
        raise ValueError(f"valid must be [{n}] on {points.device}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    lib = kernels.load("dbscan")
    fn = lib.dbscan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pts = points.to(torch.float32).contiguous()
    vld = valid.to(torch.int32).contiguous()
    labels = torch.empty((n,), dtype=torch.int32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = fn(pts.data_ptr(), vld.data_ptr(), labels.data_ptr(), n,
             float(_eps2(eps)), int(min_samples), int(max_iters), stream)
    if err != 0:
        raise RuntimeError(f"dbscan kernel launch failed: CUDA error {err}")
    dbscan_cuda.launches += 1
    return labels


dbscan_cuda.launches = 0


def dbscan(points: torch.Tensor, valid: torch.Tensor, eps: float,
           min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """points [N, D], valid [N] -> labels [N] int32 (-1 noise/invalid).
    The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if points.is_cuda:
        return dbscan_cuda(points, valid, eps, min_samples, max_iters)
    return dbscan_reference(points, valid, eps, min_samples, max_iters)


def two_stage_cluster(points: torch.Tensor, valid: torch.Tensor,
                      eps_noise: float, min_samples_noise: int,
                      eps_cluster: float, min_samples_cluster: int):
    """The reference's two-layer DBSCAN: noise cull, then instance
    clustering."""
    lab1 = dbscan(points, valid, eps_noise, min_samples_noise)
    return dbscan(points, valid & (lab1 >= 0), eps_cluster,
                  min_samples_cluster)

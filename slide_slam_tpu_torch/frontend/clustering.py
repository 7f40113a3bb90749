"""Euclidean clustering (DBSCAN): the CUDA kernel and its plain PyTorch version.

The entry points dispatch on the device of their input: a CPU tensor goes to
the plain version, a CUDA tensor to the hand-written kernel (csrc/dbscan.cu,
replacing the Pallas kernel slide_slam_tpu/frontend/clustering_pallas.py
`_dbscan_kernel`). There is no fallback: a CUDA tensor that the kernel
cannot take raises, and so does a failed build or launch.

Both compute slide_slam_tpu/frontend/clustering.dbscan exactly: dense
eps-adjacency from coordinate differences, core test degree >= min_samples,
synchronous min-label propagation over core-core edges with early exit and a
cap of `max_iters` sweeps, border points to their min core-neighbour label,
noise and invalid points -1; a cluster's id is its lowest member index.
`two_stage_cluster_batch` runs the reference's two-layer DBSCAN
(clustering.two_stage_cluster) on a batch of point sets, on the card in one
launch.
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


def stage_params(eps_noise: float, min_samples_noise: int,
                 eps_cluster: float = 0.0, min_samples_cluster: int = 0
                 ) -> np.ndarray:
    """One point set's row of `params`: (eps_1^2, ms_1, eps_2^2, ms_2) f32."""
    return np.array([_eps2(eps_noise), min_samples_noise,
                     _eps2(eps_cluster), min_samples_cluster], np.float32)


def _dbscan_plain(points, valid, eps2, min_samples: int, max_iters: int):
    n = points.shape[0]
    d = points[:, None, :] - points[None, :, :]
    d2 = d[..., 0] * d[..., 0]
    for k in range(1, points.shape[1]):
        d2 = d2 + d[..., k] * d[..., k]
    ok = valid[:, None] & valid[None, :]
    nbr = ok & (d2 <= eps2)
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


def dbscan_reference(points: torch.Tensor, valid: torch.Tensor, eps: float,
                     min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """points [N, D], valid [N] -> labels [N] int32 (-1 noise/invalid)."""
    eps2 = torch.as_tensor(_eps2(eps), device=points.device)
    return _dbscan_plain(points, valid, eps2, min_samples, max_iters)


def two_stage_cluster_reference(points: torch.Tensor, valid: torch.Tensor,
                                params: torch.Tensor, max_iters: int = 64
                                ) -> torch.Tensor:
    """The plain version of the batched two-stage DBSCAN: points [C, N, 3],
    valid [C, N], params [C, 4] (eps_noise^2, ms_noise, eps_cluster^2,
    ms_cluster) -> labels [C, N] int32. The entry points give it CPU tensors
    only; chip_smoke.py runs it on the card as the kernel's yardstick."""
    out = []
    for p, v, (e1, m1, e2, m2) in zip(points, valid, params):
        lab1 = _dbscan_plain(p, v, e1, int(m1), max_iters)
        out.append(_dbscan_plain(p, v & (lab1 >= 0), e2, int(m2), max_iters))
    return torch.stack(out) if out else torch.empty(
        tuple(valid.shape), dtype=torch.int32)


_library = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, its argument types set once, when it loads."""
    global _library
    if _library is None:
        lib = kernels.load("dbscan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dbscan_two_stage_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.dbscan_empty_launch.argtypes = [i, i, p]
        lib.dbscan_auto_cluster.argtypes = []
        for fn in (lib.dbscan_two_stage_launch, lib.dbscan_empty_launch,
                   lib.dbscan_auto_cluster):
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def _check(points, valid, params, stages: int):
    if not (points.is_cuda and valid.is_cuda and params.is_cuda):
        raise ValueError("the DBSCAN kernel takes CUDA tensors")
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be [C, N, 3], got {tuple(points.shape)}")
    C, n, _ = points.shape
    if C < 1 or not 1 <= n <= MAX_POINTS:
        raise ValueError(f"the kernel takes C >= 1 sets of 1..{MAX_POINTS} "
                         f"points, got C={C}, N={n}")
    if tuple(valid.shape) != (C, n) or tuple(params.shape) != (C, 4):
        raise ValueError(f"valid must be [{C}, {n}] and params [{C}, 4], got "
                         f"{tuple(valid.shape)} and {tuple(params.shape)}")
    if points.dtype != torch.float32 or params.dtype != torch.float32:
        raise ValueError("points and params must be float32")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be bool or uint8, got {valid.dtype}")
    if len({points.device, valid.device, params.device}) != 1:
        raise ValueError("points, valid and params must be on one card")
    if not (points.is_contiguous() and valid.is_contiguous()
            and params.is_contiguous()):
        raise ValueError("points, valid and params must be contiguous")
    if stages not in (1, 2):
        raise ValueError(f"stages must be 1 or 2, got {stages}")


def launch_dbscan(points: torch.Tensor, valid: torch.Tensor,
                  params: torch.Tensor, stages: int = 2, max_iters: int = 64,
                  cluster: int = 0) -> torch.Tensor:
    """The kernel on C point sets lying on the card: points [C, N, 3] f32,
    valid [C, N] bool, params [C, 4] f32 -> labels [C, N] int32, one launch
    for every set and stage, `cluster` CTAs of a thread-block cluster per set
    (0: 16 where the card can place a cluster that large, else 8).
    Launches on the current stream without synchronising; each launch adds
    one to `launch_dbscan.launches`."""
    _check(points, valid, params, stages)
    C, n, _ = points.shape
    labels = torch.empty((C, n), dtype=torch.int32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = _lib().dbscan_two_stage_launch(
        points.data_ptr(), valid.view(torch.uint8).data_ptr(),
        params.data_ptr(), labels.data_ptr(), C, n, stages, int(max_iters),
        int(cluster), stream)
    if err != 0:
        raise RuntimeError(f"dbscan kernel launch failed: CUDA error {err}")
    launch_dbscan.launches += 1
    return labels


launch_dbscan.launches = 0


def launch_empty(sets: int, cluster: int = 0) -> None:
    """An empty kernel of the DBSCAN kernel's launch shape (sets clusters of
    `cluster` CTAs, its shared memory): the launch floor."""
    err = _lib().dbscan_empty_launch(sets, int(cluster),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def auto_cluster_size() -> int:
    """The CTAs per set that `cluster=0` launches with on this card."""
    return _lib().dbscan_auto_cluster()


def dbscan_cuda(points: torch.Tensor, valid: torch.Tensor, eps: float,
                min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """The kernel on one point set [N, 3] (N <= 1024), one stage."""
    if not (points.is_cuda and valid.is_cuda):
        raise ValueError("dbscan_cuda takes CUDA tensors")
    params = torch.as_tensor(stage_params(eps, min_samples),
                             device=points.device)
    return launch_dbscan(points[None], valid[None], params[None], stages=1,
                         max_iters=max_iters)[0]


def dbscan(points: torch.Tensor, valid: torch.Tensor, eps: float,
           min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """points [N, D], valid [N] -> labels [N] int32 (-1 noise/invalid).
    The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if points.is_cuda:
        return dbscan_cuda(points, valid, eps, min_samples, max_iters)
    return dbscan_reference(points, valid, eps, min_samples, max_iters)


def two_stage_cluster_batch(points: torch.Tensor, valid: torch.Tensor,
                            params: torch.Tensor) -> torch.Tensor:
    """points [C, N, 3], valid [C, N], params [C, 4] -> labels [C, N]: the
    reference's two-layer DBSCAN (noise cull, then instance clustering) per
    set; the kernel, in one launch, for CUDA tensors."""
    if points.is_cuda:
        return launch_dbscan(points, valid, params, stages=2)
    return two_stage_cluster_reference(points, valid, params)


def two_stage_cluster(points: torch.Tensor, valid: torch.Tensor,
                      eps_noise: float, min_samples_noise: int,
                      eps_cluster: float, min_samples_cluster: int):
    """The two-layer DBSCAN on one point set [N, 3]."""
    params = torch.as_tensor(
        stage_params(eps_noise, min_samples_noise, eps_cluster,
                     min_samples_cluster), device=points.device)
    return two_stage_cluster_batch(points[None], valid[None], params[None])[0]

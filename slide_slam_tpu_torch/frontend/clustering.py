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
launch. The kernel takes up to MAX_POINTS = 65536 points per set (a whole
64 x 1024 range image): up to 1024 with the adjacency in shared memory,
above that with the points in Morton order and the live 32 x 32 tile pairs
in a scratch buffer in global memory that grows with the live pairs
(bounded by all of them: 512 MiB a set at 65536), the labels in the CTAs'
shared memory, ROWS_PER_CTA a CTA. Above MAX_POINTS a CUDA tensor raises.
The plain version works in row blocks, so it runs at 65536 points too.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

MAX_POINTS = 65536     # csrc/dbscan.cu kBigMaxPoints
ROWS_PER_CTA = 8192    # csrc/dbscan.cu kRowsPerCta: labels a CTA holds


def _eps2(eps: float) -> np.float32:
    # the JAX function squares eps in float32
    return np.float32(eps) * np.float32(eps)


def stage_params(eps_noise: float, min_samples_noise: int,
                 eps_cluster: float = 0.0, min_samples_cluster: int = 0
                 ) -> np.ndarray:
    """One point set's row of `params`: (eps_1^2, ms_1, eps_2^2, ms_2) f32."""
    return np.array([_eps2(eps_noise), min_samples_noise,
                     _eps2(eps_cluster), min_samples_cluster], np.float32)


# elements of one [rows, N] block of the plain version (its [rows, N, 3]
# differences are 3x that many floats): 400 MB of differences per block
PLAIN_BLOCK_ELEMENTS = 1 << 25


def _rows(n: int) -> int:
    """Rows of one block of the plain version at n points a set."""
    return max(1, min(n, PLAIN_BLOCK_ELEMENTS // max(n, 1)))


def neighbour_graph(points, valid, eps2):
    """The eps-adjacency nbr [N, N] bool (self included, valid pairs only),
    built from [rows, N] blocks: d2 from differences, in the JAX order."""
    n = points.shape[0]
    nbr = torch.empty((n, n), dtype=torch.bool, device=points.device)
    step = _rows(n)
    for r0 in range(0, n, step):
        d = points[r0:r0 + step, None, :] - points[None, :, :]
        d2 = d[..., 0] * d[..., 0]
        for k in range(1, points.shape[1]):
            d2 = d2 + d[..., k] * d[..., k]
        nbr[r0:r0 + step] = (valid[r0:r0 + step, None] & valid[None, :]
                             & (d2 <= eps2))
    return nbr


def _block_min(mask, labels, inf):
    """min over the columns j with mask[i, j] of labels[j], per row i of the
    block (inf where none)."""
    return torch.where(mask, labels[None, :], inf).min(dim=1).values


def _dbscan_plain(points, valid, eps2, min_samples: int, max_iters: int):
    n = points.shape[0]
    nbr = neighbour_graph(points, valid, eps2)
    core = valid & (nbr.sum(dim=1) >= min_samples)
    inf = n + 1
    ar = torch.arange(n, dtype=torch.int32, device=points.device)
    labels = torch.where(core, ar, inf)
    step = _rows(n)
    blocks = [slice(r0, r0 + step) for r0 in range(0, n, step)]
    core_edge = torch.empty_like(nbr)
    for b in blocks:
        core_edge[b] = nbr[b] & core[b, None] & core[None, :]
    for _ in range(max_iters):
        new = torch.cat([torch.minimum(labels[b],
                                       _block_min(core_edge[b], labels, inf))
                         for b in blocks]) if n else labels
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    del core_edge
    border = torch.cat([_block_min(nbr[b] & core[None, :], labels, inf)
                        for b in blocks]) if n else labels
    out = torch.where(core, labels, torch.where(border < inf, border, -1))
    return torch.where(valid, out, -1).to(torch.int32)


def dbscan_reference(points: torch.Tensor, valid: torch.Tensor, eps: float,
                     min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """points [N, D], valid [N] -> labels [N] int32 (-1 noise/invalid).
    Works in blocks of PLAIN_BLOCK_ELEMENTS elements; the labels do not
    depend on the block size."""
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
        lib.dbscan_two_stage_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                i, p]
        lib.dbscan_empty_launch.argtypes = [i, i, i, p]
        lib.dbscan_auto_cluster.argtypes = [i]
        lib.dbscan_scratch_words.argtypes = [i]
        lib.dbscan_scratch_words.restype = ctypes.c_longlong
        lib.dbscan_max_points.argtypes = []
        lib.dbscan_rows_per_cta.argtypes = []
        for fn in (lib.dbscan_two_stage_launch, lib.dbscan_empty_launch,
                   lib.dbscan_auto_cluster, lib.dbscan_max_points,
                   lib.dbscan_rows_per_cta):
            fn.restype = ctypes.c_int
        if (lib.dbscan_max_points(), lib.dbscan_rows_per_cta()) != (
                MAX_POINTS, ROWS_PER_CTA):
            raise RuntimeError("csrc/dbscan.cu and clustering.py disagree on "
                               "the largest set or the rows of a CTA")
        _library = lib
    return _library


def _check(points, valid, params, stages: int, cluster: int = 0):
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
    if n > 1024 and cluster > 0 and n > cluster * ROWS_PER_CTA:
        raise ValueError(f"N={n} points a set need at least "
                         f"{-(-n // ROWS_PER_CTA)} CTAs ({ROWS_PER_CTA} "
                         f"labels each), got cluster={cluster}")


def launch_dbscan(points: torch.Tensor, valid: torch.Tensor,
                  params: torch.Tensor, stages: int = 2, max_iters: int = 64,
                  cluster: int = 0) -> torch.Tensor:
    """The kernel on C point sets lying on the card: points [C, N, 3] f32,
    valid [C, N] bool, params [C, 4] f32 -> labels [C, N] int32, one launch
    for every set and stage, `cluster` CTAs of a thread-block cluster per set
    (0: 16 where the card can place a cluster that large, else 8; above 1024
    points at least N / ROWS_PER_CTA). Above 1024 points per set the kernel
    works in a scratch buffer allocated here. Launches on the current stream
    without synchronising; each launch adds one to
    `launch_dbscan.launches`."""
    _check(points, valid, params, stages, int(cluster))
    C, n, _ = points.shape
    lib = _lib()
    labels = torch.empty((C, n), dtype=torch.int32, device=points.device)
    words = lib.dbscan_scratch_words(n)
    scratch = (torch.empty(C * words, dtype=torch.int32, device=points.device)
               if words else None)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.dbscan_two_stage_launch(
        points.data_ptr(), valid.view(torch.uint8).data_ptr(),
        params.data_ptr(), labels.data_ptr(),
        None if scratch is None else scratch.data_ptr(), C, n, stages,
        int(max_iters), int(cluster), stream)
    if err != 0:
        raise RuntimeError(f"dbscan kernel launch failed: CUDA error {err}")
    launch_dbscan.launches += 1
    return labels


launch_dbscan.launches = 0


def launch_empty(sets: int, cluster: int = 0, n: int = 1024) -> None:
    """An empty kernel of the DBSCAN kernel's launch shape at n points per
    set (sets clusters of `cluster` CTAs, its shared memory): the launch
    floor."""
    err = _lib().dbscan_empty_launch(sets, int(n), int(cluster),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def auto_cluster_size(n: int = 1024) -> int:
    """The CTAs per set that `cluster=0` launches with on this card at n
    points per set."""
    return _lib().dbscan_auto_cluster(int(n))


def dbscan_cuda(points: torch.Tensor, valid: torch.Tensor, eps: float,
                min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """The kernel on one point set [N, 3] (N <= MAX_POINTS), one stage."""
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

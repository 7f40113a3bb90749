"""DBSCAN as the upstream frontend runs it, written plainly.

Two layers per class cloud (process_cloud_node's noise cull, then instance
clustering over the points the first layer kept). One layer: points i and
j are neighbours when both are valid and their squared distance, summed
from f32 coordinate differences in x, y, z order, is at most eps^2 (eps
squared in f32), self included; core points have at least min_samples
neighbours; a cluster is a connected component of the core points under
the neighbour relation, named by its lowest index; a border point takes
the lowest name among its core neighbours; every other point is -1.

Components are found to the end (min-label propagation with pointer
jumping until nothing changes), with no cap on the sweeps.
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import exact

BLOCK_ELEMENTS = 1 << 26


def _rows(n: int) -> int:
    return max(1, min(n, BLOCK_ELEMENTS // max(n, 1)))


def neighbours(points: torch.Tensor, valid: torch.Tensor, eps2,
               rnd=exact) -> torch.Tensor:
    """[N, N] bool eps-adjacency of the valid points (self included)."""
    n = points.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=points.device)
    step = _rows(n)
    for r0 in range(0, n, step):
        d = rnd(points[r0:r0 + step, None, :] - points[None, :, :])
        d2 = rnd(d[..., 0] * d[..., 0])
        d2 = rnd(d2 + rnd(d[..., 1] * d[..., 1]))
        d2 = rnd(d2 + rnd(d[..., 2] * d[..., 2]))
        out[r0:r0 + step] = (valid[r0:r0 + step, None] & valid[None, :]
                             & (d2 <= eps2))
    return out


def _row_min(mask: torch.Tensor, labels: torch.Tensor, inf: int):
    step = _rows(mask.shape[1])
    return torch.cat([torch.where(mask[r:r + step], labels[None, :], inf)
                      .amin(dim=1) for r in range(0, mask.shape[0], step)])


def layer(points: torch.Tensor, valid: torch.Tensor, eps: float,
          min_samples: int, rnd=exact) -> torch.Tensor:
    """One DBSCAN layer: labels [N] int64 (-1 noise or invalid)."""
    n = points.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=points.device)
    eps2 = torch.tensor(np.float32(eps) * np.float32(eps),
                        device=points.device)
    nbr = neighbours(points, valid, rnd(eps2), rnd)
    core = valid & (nbr.sum(dim=1) >= min_samples)
    inf = n + 1
    ar = torch.arange(n, device=points.device)
    lab = torch.where(core, ar, inf)
    core_edge = nbr & core[:, None] & core[None, :]
    while True:
        new = torch.minimum(lab, _row_min(core_edge, lab, inf))
        new = torch.where(core, new[torch.clamp(new, max=n - 1)], inf)
        new = torch.minimum(new, lab)
        if bool((new == lab).all()):
            break
        lab = new
    del core_edge
    border = _row_min(nbr & core[None, :], lab, inf)
    out = torch.where(core, lab, torch.where(border < inf, border, -1))
    return torch.where(valid, out, -1)


def two_layer(points: torch.Tensor, valid: torch.Tensor, params,
              rnd=exact) -> torch.Tensor:
    """params = (eps_noise, min_samples_noise, eps_cluster,
    min_samples_cluster) -> labels [N] int64."""
    e1, m1, e2, m2 = params
    lab1 = layer(points, valid, e1, int(m1), rnd)
    return layer(points, valid & (lab1 >= 0), e2, int(m2), rnd)

"""Submap selection: exact top-K nearest landmarks (PyTorch twin of
slide_slam_tpu/ops/submap.py).

The JAX version takes `lax.top_k(-d2, k)`, which orders ties by lower index.
`torch.topk` promises no tie order on CUDA, so this takes the first k of a
STABLE ascending sort of d2: the same indices, ties included.
"""
from __future__ import annotations

import torch

INF = 1.0e30


def topk_nearest(centroids: torch.Tensor, valid: torch.Tensor,
                 query: torch.Tensor, k: int):
    """Return (indices [k] int32, mask [k] bool) of the k nearest valid rows.

    centroids [N, 3], valid [N] bool, query [3]. If fewer than k valid rows
    exist, the mask marks the tail invalid."""
    n = centroids.shape[0]
    k_eff = min(k, n)
    d = centroids - query[None, :]
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    d2 = torch.where(valid, d2, torch.full_like(d2, INF))
    vals, idx = torch.sort(d2, stable=True)
    vals, idx = vals[:k_eff], idx[:k_eff]
    mask = vals < INF * 0.5
    if k_eff < k:
        idx = torch.cat([idx, idx.new_zeros(k - k_eff)])
        mask = torch.cat([mask, mask.new_zeros(k - k_eff)])
    return idx.to(torch.int32), mask


def radius_mask(centroids: torch.Tensor, valid: torch.Tensor,
                query: torch.Tensor, radius: float,
                z_gate: float | None = None) -> torch.Tensor:
    """Landmarks within `radius` of query (3D distance), with the reference's
    |z - query_z| < z_gate gate when z_gate is given (getkeyPoseSubmap,
    cylinderMapManager.cpp:186-211)."""
    d = torch.linalg.norm(centroids - query[None, :], dim=-1)
    m = valid & (d <= radius)
    if z_gate is not None:
        m = m & (torch.abs(centroids[:, 2] - query[2]) < z_gate)
    return m

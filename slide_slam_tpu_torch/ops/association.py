"""Semantic nearest-neighbour data association (PyTorch twin of
slide_slam_tpu/ops/association.py).

Each scan object independently takes the argmin distance over the submap and
keeps it iff the distance beats the per-class threshold (no mutual
exclusion, as in the reference's greedy matchers).
"""
from __future__ import annotations

import torch


def match_nearest(dist: torch.Tensor, thresh: float,
                  margin: float = 0.0) -> torch.Tensor:
    """dist [N_scan, M_submap] -> match indices [N_scan] int32, -1 = none.

    `margin` > 0 also requires the winner to beat the runner-up by that
    much; the keyframe path keeps it at 0, as the JAX engine does."""
    best_d, best = torch.min(dist, dim=1)
    ok = best_d < thresh
    if margin > 0.0:
        cols = torch.arange(dist.shape[1], device=dist.device)
        second = torch.where(cols[None, :] == best[:, None],
                             torch.full_like(dist, float("inf")), dist
                             ).min(dim=1).values
        ok = ok & (second - best_d > margin)
    return torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32)


def to_global_indices(matches: torch.Tensor,
                      submap_indices: torch.Tensor) -> torch.Tensor:
    """Submap-local match indices -> global map rows (-1 stays -1)."""
    g = submap_indices[torch.clamp(matches.long(), 0,
                                   submap_indices.shape[0] - 1)]
    return torch.where(matches >= 0, g.to(torch.int32),
                       torch.full_like(matches, -1))

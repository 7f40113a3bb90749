"""Frozen copy of chip_smoke.py's DBSCAN work arithmetic and H100 peaks
(commit e8ab756: `dbscan_work`, `two_stage_work`, `dbscan_bound`,
`F32_PEAK_FLOPS`, `HBM_BYTES_PER_S`; the plain neighbour graph of
slide_slam_tpu_torch/frontend/clustering.py with it).

The work a DBSCAN launch needs on its inputs, counted from the plain
algorithm's run on them: the valid points' spatial order (nv log2 nv
compares), per neighbour pair its d2 and compare (9), one add per
neighbour to the degrees, per sweep one min per core-core edge out of a
row that changed in the sweep before (every edge in the first), and one
min per border-core edge. One change from the source: the padding rows are
dropped before counting (`valid` selects the rows), which leaves every
count as it was and keeps the neighbour graph at the valid points' size.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
PLAIN_BLOCK_ELEMENTS = 1 << 25


def _rows(n: int) -> int:
    return max(1, min(n, PLAIN_BLOCK_ELEMENTS // max(n, 1)))


def neighbour_graph(points, valid, eps2):
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


def dbscan_work(points, valid, eps2, min_samples, max_iters=64):
    """(operations, labels) of one layer on the valid rows."""
    nbr = neighbour_graph(points, valid, eps2)
    deg = nbr.sum(1)
    core = valid & (deg >= min_samples)
    n, nv = points.shape[0], int(valid.sum())
    step = _rows(n)
    blocks = [slice(r, r + step) for r in range(0, n, step)]
    edge = lambda b: nbr[b] & core[b, None] & core[None, :]
    core_nbrs = torch.cat([(nbr[b] & core[None, :]).sum(1) for b in blocks])
    out_edges = torch.where(core, core_nbrs, 0)
    lab = torch.where(core, torch.arange(n, device=points.device), n + 1)
    changed, relaxed = core, 0
    for _ in range(max_iters):
        relaxed += int(out_edges[changed].sum())
        new = torch.cat([torch.minimum(lab[b], torch.where(
            edge(b), lab[None, :], n + 1).min(1).values) for b in blocks])
        changed = new != lab
        if not bool(changed.any()):
            break
        lab = new
    border = torch.cat([torch.where(nbr[b] & core[None, :], lab[None, :],
                                    n + 1).min(1).values for b in blocks])
    labels = torch.where(core, lab, torch.where(border <= n, border, -1))
    labels = torch.where(valid, labels, -1)
    pairs = (int(deg.sum()) - nv) // 2
    order = nv * math.ceil(math.log2(max(nv, 2)))
    return (order + 9 * pairs + int(deg.sum()) + relaxed
            + int(core_nbrs[valid & ~core].sum())), labels


def two_stage_work(points, valid, params):
    """dbscan_work of both layers of one set (params: eps_1^2, ms_1,
    eps_2^2, ms_2), the second over the first one's non-noise points."""
    keep = valid.nonzero().squeeze(1)
    points, valid = points[keep], valid[keep]
    ops1, lab1 = dbscan_work(points, valid, params[0], int(params[1]))
    ops2, _ = dbscan_work(points, valid & (lab1 >= 0), params[2],
                          int(params[3]))
    return ops1 + ops2


def launch_bytes(points, valid, params) -> int:
    """Bytes a launch reads and writes once: points, valid flags and
    params in, int32 labels out."""
    C, n = valid.shape
    return C * n * (12 + 1 + 4) + C * 16


def dbscan_bound(ops, nbytes):
    """(least milliseconds, what bounds it)."""
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def launch_bound_ms(points, valid, params) -> float:
    """The least time one launch of C sets could take on the card."""
    ops = sum(two_stage_work(points[c], valid[c], params[c])
              for c in range(points.shape[0]))
    return dbscan_bound(ops, launch_bytes(points, valid, params))[0]

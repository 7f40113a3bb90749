"""Cylinder measurements of one segmented scan, written plainly.

The upstream forest frontend per scan (process_cloud_node, the outdoor
class table): the points of each cylinder class in range, two-layer
DBSCAN, one instance per cluster (its first `max_points_per_instance`
points), and per instance:

* a ground plane from the ground points within half a patch (XY) of the
  instance's median: RANSAC over 64 hypotheses (point triples drawn from
  the valid patch points with the draws given), the first best inlier
  count (distance < 0.1 m), then a least-squares refit of its inliers
  (smallest eigenvector of their covariance, turned upward); with fewer
  than 5 patch points, the flat plane through the instance's lowest point;
* the axis: the instance's principal direction, turned along the normal;
* the radius: half the largest distance between two points of the band
  within 0.3 m of breast height (1.37 m above the plane), the default
  0.2 m where that lies outside twice the radius cut-off;
* the root: the band's centroid moved along the axis onto the plane;
* kept when the instance has 10 points and the band 3.

Measurements are turned into the body frame with the odometry pose. All
of it in float64 on the device given; `rnd` rounds the operands.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List

import numpy as np
import torch

from . import dbscan
from .precision import exact

INT32_MAX = 2 ** 31 - 1


def ransac_draws(n_rows: int, n_hypotheses: int = 64, seed: int = 0):
    """The RANSAC draws the configuration fixes: uniform ints in
    [0, 2^31 - 1) from a CPU torch.Generator seeded with 0 per fit."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, INT32_MAX, (n_rows, n_hypotheses, 3), generator=g)


def _pad(pts: torch.Tensor, n: int):
    out = torch.zeros((n, 3), dtype=pts.dtype, device=pts.device)
    k = min(len(pts), n)
    out[:k] = pts[:k]
    mask = torch.zeros(n, dtype=torch.bool, device=pts.device)
    mask[:k] = True
    return out, mask


def _mean_cov(points, mask, rnd):
    c = torch.clamp(mask.sum(-1), min=1).to(points.dtype)
    mu = torch.where(mask[..., None], points, 0.0).sum(-2) / c[:, None]
    d = rnd(torch.where(mask[..., None], points - mu[:, None, :], 0.0))
    return mu, rnd(torch.einsum("igj,igk->ijk", d, d) / c[:, None, None])


def _lsq_plane(points, mask, rnd):
    mu, cov = _mean_cov(points, mask, rnd)
    nrm = torch.linalg.eigh(cov)[1][..., :, 0]
    nrm = torch.where(nrm[:, 2:3] < 0, -nrm, nrm)
    return nrm, -(nrm * mu).sum(-1)


def _ransac(points, mask, draws, rnd, thresh=0.1):
    I = points.shape[0]
    dev = points.device
    r = draws.to(dev).long()
    order = torch.sort((~mask).to(torch.int32), dim=-1, stable=True).indices
    n_valid = mask.sum(-1)
    cnt = torch.clamp(n_valid, min=1)[:, None]
    j0 = r[..., 0] % cnt
    j1 = (r[..., 1] % cnt + 1 + j0) % cnt
    j2 = (r[..., 2] % cnt + 7 + j1) % cnt
    j = torch.stack([j0, j1, j2], -1)
    idx = torch.gather(order, 1, j.reshape(I, -1)).reshape(j.shape)
    tri = torch.gather(points, 1, idx.reshape(I, -1, 1).expand(-1, -1, 3)
                       ).reshape(I, -1, 3, 3)
    tri_ok = torch.gather(mask, 1, idx.reshape(I, -1)).reshape(j.shape).all(-1)
    tri_ok = tri_ok & (n_valid >= 3)[:, None]
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    n = torch.linalg.cross(rnd(p1 - p0), rnd(p2 - p0), dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    degenerate = nn[..., 0] < 1e-9
    n = n / torch.clamp(nn, min=1e-9)
    n = n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)
    d = -(rnd(n) * rnd(p0)).sum(-1)
    dist = torch.abs(torch.einsum("ihd,igd->ihg", rnd(n), rnd(points))
                     + d[..., None])
    inl = (dist < thresh) & mask[:, None, :]
    counts = torch.where(tri_ok & ~degenerate, inl.sum(-1), -1)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(I, device=dev)
    best_inl, best_cnt = inl[ar, best], counts[ar, best]
    n0, d0 = _lsq_plane(points, mask, rnd)
    fb_inl = mask & (torch.abs(torch.einsum("igd,id->ig", rnd(points),
                                            rnd(n0)) + d0[:, None]) < thresh)
    fb = torch.where((fb_inl.sum(-1) >= 3)[:, None], fb_inl, mask)
    refit = torch.where((best_cnt >= 3)[:, None], best_inl, fb)
    return _lsq_plane(points, refit, rnd)


def _fit(points, mask, normal, d, pipe, rnd):
    cnt = mask.sum(-1)
    _, cov = _mean_cov(points, mask, rnd)
    axis = torch.linalg.eigh(cov)[1][..., :, -1]
    axis = axis * torch.where((axis * normal).sum(-1) < 0, -1.0, 1.0)[:, None]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-9)
    h = torch.einsum("ipd,id->ip", rnd(points), rnd(normal)) + d[:, None]
    band = mask & (torch.abs(h - pipe["breast_height"]) < 0.3)
    band_cnt = band.sum(-1)
    dd = rnd(points[:, :, None, :] - points[:, None, :, :])
    d2 = (dd * dd).sum(-1)
    d2 = torch.where(band[:, :, None] & band[:, None, :], d2, 0.0)
    diameter = torch.sqrt(d2.amax(dim=(1, 2)))
    lo, hi = 2 * pipe["radius_cutoff"][0], 2 * pipe["radius_cutoff"][1]
    radius = torch.where((diameter < lo) | (diameter > hi),
                         torch.full_like(diameter, pipe["default_radius"]),
                         0.5 * diameter)
    bc = torch.clamp(band_cnt, min=1).to(points.dtype)[:, None]
    rep = torch.where(band[..., None], points, 0.0).sum(1) / bc
    denom = (normal * axis).sum(-1)
    t = -((normal * rep).sum(-1) + d) / torch.where(
        torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
    root = rep + t[:, None] * axis
    ok = (cnt >= 10) & (band_cnt >= 3)
    return root, axis, radius, ok


def _quat_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def world_points(body: np.ndarray, pose7: np.ndarray) -> np.ndarray:
    """Body-frame points through the odometry pose, in float64."""
    pose = np.asarray(pose7, np.float64)
    R = _quat_matrix(pose[:4] / np.linalg.norm(pose[:4]))
    return np.asarray(body, np.float64) @ R.T + pose[4:7]


def class_points(world: np.ndarray, labels: np.ndarray, pose7, pipe,
                 label: int) -> np.ndarray:
    """Indices of the scan's points of one class within max_range."""
    rng = np.linalg.norm(world - np.asarray(pose7, np.float64)[4:7], axis=1)
    return np.nonzero((rng < pipe["max_range"]) & (labels == label))[0]


RANGE_SLACK_M = 1e-3
MAX_DROPS = 64


def class_candidates(world: np.ndarray, labels: np.ndarray, pose7, pipe,
                     label: int):
    """(indices, sure): the scan's points of one class within max_range +
    RANGE_SLACK_M, and which of them lie within max_range - RANGE_SLACK_M.
    A point in between may fall on either side of an f32 range test."""
    rng = np.linalg.norm(world - np.asarray(pose7, np.float64)[4:7], axis=1)
    idx = np.nonzero((rng < pipe["max_range"] + RANGE_SLACK_M)
                     & (labels == label))[0]
    return idx, rng[idx] < pipe["max_range"] - RANGE_SLACK_M


def align(got: np.ndarray, world: np.ndarray, idx: np.ndarray,
          sure: np.ndarray):
    """(indices, gap): the candidates `idx` (scan order) whose points `got`
    holds, in order, with every sure candidate among them and the others
    left out as needed, and the largest coordinate gap between the two;
    (None, inf) when no such subset exists."""
    got = np.asarray(got, np.float64)
    drop = len(idx) - len(got)
    amb = np.nonzero(~sure)[0]
    if drop < 0 or drop > len(amb) or math.comb(len(amb), drop) > MAX_DROPS:
        return None, math.inf
    best, best_gap = None, math.inf
    for out in itertools.combinations(amb, drop):
        keep = np.delete(idx, list(out))
        gap = float(np.abs(got - world[keep]).max(initial=0.0))
        if gap < best_gap:
            best, best_gap = keep, gap
    return best, best_gap


def measurements(world: np.ndarray, labels: np.ndarray, pose7,
                 cluster_labels: Dict[int, np.ndarray], pipe, classes,
                 device, rnd=exact, idx_of=None) -> Dict[str, np.ndarray]:
    """Body-frame cylinder measurements (cyl_root, cyl_ray, cyl_radius,
    cyl_label) of one scan. `world` [N, 3] f64 points, `labels` their
    classes, `cluster_labels[label]` the DBSCAN labels of that class's
    points (class_points order, or the indices `idx_of[label]`)."""
    dev = torch.device(device)
    f64 = torch.float64
    gi = class_points(world, labels, pose7, pipe, classes["ground"])
    ground = torch.as_tensor(world[gi], dtype=f64, device=dev)
    gp, gm = _pad(ground, pipe["max_points_per_class"])
    out = {"cyl_root": [], "cyl_ray": [], "cyl_radius": [], "cyl_label": []}
    for spec in classes["cylinders"]:
        lab = spec["label"]
        if lab not in cluster_labels:
            continue
        idx = (idx_of[lab] if idx_of is not None
               else class_points(world, labels, pose7, pipe, lab))
        pts = torch.as_tensor(world[idx], dtype=f64, device=dev)
        cl = torch.as_tensor(cluster_labels[lab], device=dev)
        names = torch.unique(cl)
        names = names[names >= 0]
        if len(names) == 0:
            continue
        inst = [pts[cl == c] for c in names]
        padded = [_pad(p, pipe["max_points_per_instance"]) for p in inst]
        P = torch.stack([p for p, _ in padded])
        M = torch.stack([m for _, m in padded])
        cens = torch.stack([torch.as_tensor(
            np.median(p.cpu().numpy(), axis=0), device=dev) for p in inst])
        dxy = torch.linalg.norm(gp[None, :, :2] - cens[:, None, :2], dim=-1)
        patch = gm[None, :] & (dxy < pipe["ground_patch_size"] / 2)
        normal, d = _ransac(gp.expand((len(inst),) + gp.shape), patch,
                            ransac_draws(len(inst)), rnd)
        have = patch.sum(1) >= 5
        z0 = torch.where(M, P[..., 2], 1e9).amin(1)
        up = torch.tensor([0.0, 0.0, 1.0], dtype=f64, device=dev)
        normal = torch.where(have[:, None], normal, up)
        d = torch.where(have, d, -z0)
        root, ray, radius, ok = _fit(P, M, normal, d, pipe, rnd)
        for i in torch.nonzero(ok).squeeze(1).tolist():
            out["cyl_root"].append(root[i].cpu().numpy())
            out["cyl_ray"].append(ray[i].cpu().numpy())
            out["cyl_radius"].append(float(radius[i]))
            out["cyl_label"].append(lab)
    pose = np.asarray(pose7, np.float64)
    R = _quat_matrix(pose[:4] / np.linalg.norm(pose[:4]))
    root = np.asarray(out["cyl_root"]).reshape(-1, 3)
    ray = np.asarray(out["cyl_ray"]).reshape(-1, 3)
    return {"cyl_root": (root - pose[4:7]) @ R,
            "cyl_ray": ray @ R,
            "cyl_radius": np.asarray(out["cyl_radius"], np.float64),
            "cyl_label": np.asarray(out["cyl_label"], np.int64)}


def cluster_scan(world: np.ndarray, labels: np.ndarray, pose7, pipe, classes,
                 device, rnd=exact, points32=None,
                 idx_of=None) -> Dict[int, np.ndarray]:
    """Two-layer DBSCAN labels of every cylinder class with at least
    min_samples_cluster points in range (class_points, or the indices
    `idx_of[label]`). `points32[label]`, when given, holds the f32 points
    to cluster (the program's input, judged apart); otherwise the f64
    world points are rounded to f32."""
    out = {}
    for spec in classes["cylinders"]:
        lab = spec["label"]
        idx = (idx_of.get(lab, np.zeros(0, np.int64)) if idx_of is not None
               else class_points(world, labels, pose7, pipe, lab))
        if len(idx) < spec["min_samples_cluster"]:
            continue
        pts = (points32[lab] if points32 is not None
               else world[idx].astype(np.float32))
        p = torch.as_tensor(np.asarray(pts, np.float32), device=device)
        v = torch.ones(len(p), dtype=torch.bool, device=device)
        out[lab] = dbscan.two_layer(
            p, v, (spec["eps_noise"], spec["min_samples_noise"],
                   spec["eps_cluster"], spec["min_samples_cluster"]),
            rnd).cpu().numpy()
    return out

"""SlideGraph's decisions, worked out again in f64: triangle descriptors,
their votes, CLIPPER's dense clique and the 2D fit.

Upstream (semantic_clipper.cpp, run_semantic_clipper :140-274, called by
findInterLoopClosureWithClipper, place_recognition.cpp:541-629):

1. Objects at x = y = 0 are dropped; a map with fewer than
   `min_num_map_objects_to_start` objects is not searched.
2. Each map's x/y positions are triangulated (Delaunay, here scipy's), and
   each triangle described by its vertices' distances to its centroid,
   sorted (:49-108).
3. Every pair of a map triangle and a query triangle whose descriptors lie
   less than `descriptor_matching_threshold` apart (L2) pairs their
   vertices in that sorted order. The port's documented deviation: each
   such triangle pair votes for its three (map object, query object)
   pairs, each pair is kept once, ranked by votes (most first), then by
   the closest descriptor that voted for it, then by (map, query) index,
   and at most `max_associations` are kept.
4. CLIPPER (clipper.cpp:21-65, :172-310): the affinity of two
   associations is exp(-c^2 / (2 sigma^2)) where c = | |a_i - a_j| -
   |b_i - b_j| | < epsilon (0 otherwise, and 0 at or below `affinity_eps`),
   no self affinity; the dense clique is the projected gradient ascent with
   homotopy on it, from the start vector that
   numpy.random.default_rng(seed).uniform draws, and the inliers are the
   round(F) associations of largest weight (DSD_HEU).
5. Fewer inliers than `num_inliers_threshold`: not found. Otherwise the 2D
   rigid fit of the inliers, map -> query (estimate_tf :122-138), becomes
   a yaw and x/y transform, and the caller inverts it (:621-624).

Every function takes `rnd`, the rounding of the control, applied to the
object positions it is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .precision import exact


@dataclass
class Clique:
    """The ascent's outcome: the weights u, F, the inliers (indices into
    the associations), and how clearly they were chosen: the gap of F to
    the nearest half (where round(F) would change) and the gap between
    the last weight kept and the first left out, over the largest weight."""
    u: np.ndarray
    F: float
    inliers: np.ndarray
    f_edge: float
    u_edge: float
    ticks: int


@dataclass
class Search:
    """One findInterLoopClosureWithClipper: `searched` is False where the
    maps were too small to search."""
    found: bool
    searched: bool = False
    pairs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2),
                                                                np.int64))
    clique: Optional[Clique] = None
    vote_edge: float = np.inf
    tf: Optional[np.ndarray] = None


def drop_origin(rows) -> np.ndarray:
    rows = np.asarray(rows, np.float64).reshape(-1, 7)
    return rows[~((rows[:, 1] == 0) & (rows[:, 2] == 0))]


def triangles(xy: np.ndarray):
    """[T, 3] point indices of the Delaunay triangles of xy [N, 2]; none
    where fewer than 3 points or all on a line."""
    from scipy.spatial import Delaunay, QhullError
    if len(xy) < 3:
        return np.zeros((0, 3), np.int64)
    try:
        return Delaunay(xy).simplices.astype(np.int64)
    except QhullError:
        return np.zeros((0, 3), np.int64)


def descriptors(xy: np.ndarray, tri: np.ndarray):
    """(sorted centroid distances [T, 3], the vertices in that order)."""
    if len(tri) == 0:
        return np.zeros((0, 3)), tri
    v = xy[tri]                                            # [T, 3, 2]
    d = np.sqrt(((v - v.mean(1, keepdims=True)) ** 2).sum(-1))
    order = np.argsort(d, axis=1, kind="stable")
    return np.take_along_axis(d, order, 1), np.take_along_axis(tri, order, 1)


def associations(ref_xy, qry_xy, threshold: float, cap: int):
    """(pairs [A, 2] of (map index, query index) in rank order, the
    smallest distance of any descriptor pair to the threshold)."""
    dm, vm = descriptors(ref_xy, triangles(ref_xy))
    dq, vq = descriptors(qry_xy, triangles(qry_xy))
    if len(dm) == 0 or len(dq) == 0:
        return np.zeros((0, 2), np.int64), np.inf
    votes, best, edge = {}, {}, np.inf
    for lo in range(0, len(dm), 512):
        diff = np.sqrt(((dm[lo:lo + 512, None, :] - dq[None, :, :]) ** 2)
                       .sum(-1))
        edge = min(edge, float(np.abs(diff - threshold).min()))
        ti, tj = np.nonzero(diff < threshold)
        for a, b, dd in zip(ti + lo, tj, diff[ti, tj]):
            for k in range(3):
                key = (int(vm[a, k]), int(vq[b, k]))
                votes[key] = votes.get(key, 0) + 1
                best[key] = min(best.get(key, np.inf), float(dd))
    keys = sorted(votes, key=lambda k: (-votes[k], best[k], k))[:cap]
    return np.asarray(keys, np.int64).reshape(-1, 2), edge


def affinity(a: np.ndarray, b: np.ndarray, cp: dict) -> np.ndarray:
    la = np.sqrt(((a[:, None] - a[None]) ** 2).sum(-1))
    lb = np.sqrt(((b[:, None] - b[None]) ** 2).sum(-1))
    c = np.abs(la - lb)
    m = np.where(c < cp["epsilon"], np.exp(-0.5 * c * c / cp["sigma"] ** 2),
                 0.0)
    if cp["mindist"] > 0:
        m[(la < cp["mindist"]) | (lb < cp["mindist"])] = 0.0
    m[m <= cp["affinity_eps"]] = 0.0
    np.fill_diagonal(m, 0.0)
    return m


def dense_clique(M: np.ndarray, u0: np.ndarray, cp: dict) -> Clique:
    """CLIPPER's projected gradient ascent with homotopy on affinity M
    (no diagonal), from u0. The complement's product N u = (1 - C - I) u
    is formed from N itself, so that on a clique it is a sum of zeros."""
    n = len(M)
    C = (M > 0).astype(np.float64)
    N = 1.0 - C - np.eye(n)
    eps = cp["eps"]

    def grad(u, d):
        return u + M @ u - d * (N @ u)

    def homotopy_step(u, absolute):
        Mu, Nu = M @ u, N @ u
        idx = (Nu > eps) & (u > eps)
        if not idx.any():
            return None
        r = (Mu[idx] + u[idx]) / Nu[idx]
        return float(np.mean(np.abs(r) if absolute else r))

    u = M @ u0 + u0
    u = u / max(np.linalg.norm(u), 1e-30)
    d = homotopy_step(u, False) or 0.0
    ticks = 0
    F = 0.0
    for _ in range(cp["maxoliters"]):
        g = grad(u, d)
        F = float(u @ g)
        for _ in range(cp["maxiniters"]):
            alpha = 1.0
            unew, gnew, Fnew = u, g, F
            for _ in range(cp["maxlsiters"]):
                ticks += 1
                cand = np.maximum(u + alpha * g, 0.0)
                cand = cand / max(np.linalg.norm(cand), 1e-30)
                gc = grad(cand, d)
                Fc = float(cand @ gc)
                if Fc - F < -eps:
                    alpha *= cp["beta"]
                    continue
                unew, gnew, Fnew = cand, gc, Fc
                break
            deltau = np.linalg.norm(unew - u)
            deltaF = Fnew - F
            u, g, F = unew, gnew, Fnew
            if deltau < cp["tol_u"] or abs(deltaF) < cp["tol_F"]:
                break
        dd = homotopy_step(u, True)
        if dd is None:
            break
        d += dd
    omega = int(np.rint(F))
    omega = max(0, min(omega, int((u > 0).sum())))
    order = np.argsort(-u, kind="stable")
    inliers = np.sort(order[:omega])
    top = max(float(u.max(initial=0.0)), 1e-30)
    kept = u[order[omega - 1]] if omega else np.inf
    left = u[order[omega]] if omega < n else 0.0
    return Clique(u=u, F=F, inliers=inliers,
                  f_edge=abs(abs(F - np.floor(F)) - 0.5),
                  u_edge=float((kept - left) / top), ticks=ticks)


def estimate_tf_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The rigid 2D transform [3, 3] that carries a onto b in least
    squares."""
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R[:, 1] *= -1
    tf = np.eye(3)
    tf[:2, :2] = R
    tf[:2, 2] = cb - R @ ca
    return tf


def inter_closure(reference_map, query_map, sg: dict, cp: dict,
                  cap: int, seed: int = 0, rnd=exact) -> Search:
    """findInterLoopClosureWithClipper: the search, with `tf` the query ->
    map transform [4, 4] where found; `pairs` index the maps after the
    objects at the origin are dropped."""
    ref = drop_origin(reference_map)
    qry = drop_origin(query_map)
    least = sg["min_num_map_objects_to_start"]
    if len(ref) < least or len(qry) < least:
        return Search(False)
    rxy, qxy = rnd(ref[:, 1:3]), rnd(qry[:, 1:3])
    pairs, vote_edge = associations(rxy, qxy,
                                    sg["descriptor_matching_threshold"], cap)
    out = Search(False, True, pairs, vote_edge=vote_edge)
    if len(pairs) == 0:
        return out
    a, b = rxy[pairs[:, 0]], qxy[pairs[:, 1]]
    u0 = np.random.default_rng(seed).uniform(size=len(pairs))
    out.clique = dense_clique(affinity(a, b, cp), u0, cp)
    inl = out.clique.inliers
    if len(inl) < sg["num_inliers_threshold"]:
        return out
    out.found = True
    tf2 = estimate_tf_2d(a[inl], b[inl])
    yaw = np.arctan2(tf2[1, 0], tf2[0, 0])
    tf = np.eye(4)
    tf[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    tf[:2, 3] = tf2[:2, 2]
    out.tf = np.linalg.inv(tf)
    return out

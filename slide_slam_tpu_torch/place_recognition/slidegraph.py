"""SlideGraph place recognition: Delaunay triangle descriptors + CLIPPER
(twin of slide_slam_tpu/place_recognition/slidegraph.py: the host parts are
the same numpy, the CLIPPER ascent runs in PyTorch on the node's device).

Re-implementation of run_semantic_clipper
(clipper_semantic_object/src/semantic_clipper.cpp:140-274):

1. 2D Delaunay triangulation of each object map (scipy.spatial.Delaunay on
   host replaces the vendored qhull C++ wrapper — same algorithm family).
2. Triangle descriptor: the sorted vertex-to-centroid distances
   (semantic_clipper.cpp:49-108). All triangle pairs whose descriptors differ
   by < threshold contribute their 3 sorted vertex pairs as candidate
   associations — vectorized here as a dense [Tm, Td] descriptor-distance
   matrix instead of the reference's double loop.
3. CLIPPER pairwise-consistency + dense-clique relaxation (clipper.py, on
   the device) selects the geometrically consistent subset.
4. 2D SVD rigid fit (estimate_tf, semantic_clipper.cpp:122-138) -> yaw+xy 4x4.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlideGraphConfig
from .clipper import ClipperParams, dense_clique_inliers


def _triangulate(points_2d: np.ndarray):
    """(vertices [T, 3, 2], simplices [T, 3] point indices) from Delaunay;
    empty if degenerate."""
    from scipy.spatial import Delaunay, QhullError

    pts = np.asarray(points_2d, np.float64)
    if len(pts) < 3:
        return np.zeros((0, 3, 2)), np.zeros((0, 3), np.int64)
    try:
        tri = Delaunay(pts)
    except QhullError:
        return np.zeros((0, 3, 2)), np.zeros((0, 3), np.int64)
    return pts[tri.simplices], tri.simplices.astype(np.int64)


def _triangles(points_2d: np.ndarray) -> np.ndarray:
    """[T, 3, 2] triangle vertices from Delaunay; empty if degenerate."""
    return _triangulate(points_2d)[0]


def _sorted_descriptors(tris: np.ndarray, simplices: np.ndarray = None):
    """(descriptors [T,3], vertices sorted by centroid distance [T,3,2],
    point indices in the same order [T,3] or None)."""
    if len(tris) == 0:
        return np.zeros((0, 3)), tris, simplices
    cen = tris.mean(axis=1, keepdims=True)          # [T,1,2]
    d = np.linalg.norm(tris - cen, axis=2)          # [T,3]
    order = np.argsort(d, axis=1, kind="stable")
    desc = np.take_along_axis(d, order, axis=1)
    verts = np.take_along_axis(tris, order[:, :, None], axis=1)
    idx = (None if simplices is None
           else np.take_along_axis(simplices, order, axis=1))
    return desc, verts, idx


def match_triangles(tri_model: np.ndarray, tri_data: np.ndarray,
                    threshold: float):
    """All triangle pairs with descriptor L2 diff < threshold ->
    (matched model points [3k, 2], matched data points [3k, 2])."""
    dm, vm, _ = _sorted_descriptors(tri_model)
    dd, vd, _ = _sorted_descriptors(tri_data)
    if len(dm) == 0 or len(dd) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    diff = np.linalg.norm(dm[:, None, :] - dd[None, :, :], axis=2)
    mi, di = np.nonzero(diff < threshold)
    pts_m = vm[mi].reshape(-1, 2)
    pts_d = vd[di].reshape(-1, 2)
    return pts_m, pts_d


def _match_chunked(dm: np.ndarray, dd: np.ndarray, threshold: float,
                   chunk: int = 1024):
    """(mi, di, diff) of all descriptor pairs under threshold, computed in
    row chunks so dense maps (>10k triangles each) never materialize the
    full [Tm, Td] distance matrix."""
    mis, dis, dfs = [], [], []
    for lo in range(0, len(dm), chunk):
        diff = np.linalg.norm(dm[lo:lo + chunk, None, :] - dd[None, :, :],
                              axis=2)
        mi, di = np.nonzero(diff < threshold)
        mis.append(mi + lo)
        dis.append(di)
        dfs.append(diff[mi, di])
    if not mis:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    return np.concatenate(mis), np.concatenate(dis), np.concatenate(dfs)


def vote_associations(tri_m, simp_m, tri_d, simp_d, threshold: float,
                      max_associations: int):
    """Unique point-level associations from triangle-descriptor matching,
    vote-ranked.

    The reference feeds EVERY matched triangle pair's 3 vertex pairs into
    CLIPPER verbatim, duplicates included (semantic_clipper.cpp:49-118,
    :204-236) — on dense maps that is O(Tm*Td) associations (282k on the
    792-object forest map) and the affinity matrix is O(A^2). Here each
    triangle match VOTES for its 3 (model point, data point) pairs;
    associations are deduplicated and, when over the CLIPPER cap, kept by
    (most votes, then best descriptor distance). A correct correspondence
    is a vertex of many congruent triangles, so its vote count scales with
    its Delaunay degree squared while spurious pairs stay near 1 — the cap
    then keeps the signal, where a random subsample would keep 0.7 % of
    it. Returns (pairs [A, 2] int64 (model_idx, data_idx),
    votes [A], best_diff [A]) sorted by rank."""
    dm, _, im = _sorted_descriptors(tri_m, simp_m)
    dd, _, idd = _sorted_descriptors(tri_d, simp_d)
    if len(dm) == 0 or len(dd) == 0:
        z = np.zeros((0, 2), np.int64)
        return z, np.zeros(0, np.int64), np.zeros(0)
    mi, di, diff = _match_chunked(dm, dd, threshold)
    if len(mi) == 0:
        z = np.zeros((0, 2), np.int64)
        return z, np.zeros(0, np.int64), np.zeros(0)
    # 3 sorted-vertex-rank pairs per triangle match
    pair_m = im[mi].reshape(-1)                      # [3k]
    pair_d = idd[di].reshape(-1)
    pair_diff = np.repeat(diff, 3)
    n_d = int(idd.max()) + 1
    key = pair_m * n_d + pair_d
    uniq, inv = np.unique(key, return_inverse=True)
    votes = np.bincount(inv)
    best = np.full(len(uniq), np.inf)
    np.minimum.at(best, inv, pair_diff)
    order = np.lexsort((best, -votes))[:max_associations]
    pairs = np.stack([uniq[order] // n_d, uniq[order] % n_d], axis=1)
    return pairs, votes[order], best[order]


def estimate_tf_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """2D rigid fit b ~= R a + t (semantic_clipper.cpp:122-138) -> 3x3."""
    mu_a, mu_b = a.mean(0), b.mean(0)
    H = (a - mu_a).T @ (b - mu_b)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R[:, 1] *= -1
    t = mu_b - R @ mu_a
    tf = np.eye(3)
    tf[:2, :2] = R
    tf[:2, 2] = t
    return tf


def run_semantic_clipper(reference_map: np.ndarray, query_map: np.ndarray,
                         sigma: float, epsilon: float, min_num_pairs: int,
                         matching_threshold: float,
                         max_associations: int = 2048,
                         seed: int = 0, device="cuda"):
    """(found, tfFromQuery2Ref-as-the-reference-returns-it [4,4]).

    NOTE the reference quirk: run_semantic_clipper's output maps MODEL(ref)
    -> DATA(query); the caller inverts it (place_recognition.cpp:621-624).
    We return the same un-inverted convention here."""
    ref = np.asarray(reference_map, np.float64).reshape(-1, 7)
    qry = np.asarray(query_map, np.float64).reshape(-1, 7)
    # drop objects with zero XY (place_recognition.cpp:584-603)
    ref = ref[~((ref[:, 1] == 0) & (ref[:, 2] == 0))]
    qry = qry[~((qry[:, 1] == 0) & (qry[:, 2] == 0))]

    tri_m, simp_m = _triangulate(ref[:, 1:3])
    tri_d, simp_d = _triangulate(qry[:, 1:3])
    pairs, votes, _ = vote_associations(tri_m, simp_m, tri_d, simp_d,
                                        matching_threshold, max_associations)
    if len(pairs) == 0:
        return False, None
    pts_m = ref[pairs[:, 0], 1:3]
    pts_d = qry[pairs[:, 1], 1:3]

    params = ClipperParams(sigma=sigma, epsilon=epsilon)
    inliers = dense_clique_inliers(pts_m, pts_d, params, seed=seed,
                                   device=device)
    if len(inliers) < min_num_pairs:
        return False, None

    tf2 = estimate_tf_2d(pts_m[inliers], pts_d[inliers])
    yaw = np.arctan2(tf2[1, 0], tf2[0, 0])
    tf = np.eye(4)
    tf[0, 0], tf[0, 1] = np.cos(yaw), -np.sin(yaw)
    tf[1, 0], tf[1, 1] = np.sin(yaw), np.cos(yaw)
    tf[0, 3], tf[1, 3] = tf2[0, 2], tf2[1, 2]
    return True, tf


class SlideGraph:
    """findInterLoopClosureWithClipper (place_recognition.cpp:541-629)."""

    def __init__(self, cfg: SlideGraphConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def find_inter_loop_closure(self, reference_map: np.ndarray,
                                query_map: np.ndarray,
                                seed: int = 0):
        ref = np.asarray(reference_map, np.float32).reshape(-1, 7)
        qry = np.asarray(query_map, np.float32).reshape(-1, 7)
        ref = ref[~((ref[:, 1] == 0) & (ref[:, 2] == 0))]
        qry = qry[~((qry[:, 1] == 0) & (qry[:, 2] == 0))]
        if (len(ref) < self.cfg.min_num_map_objects_to_start
                or len(qry) < self.cfg.min_num_map_objects_to_start):
            return False, None
        found, tf = run_semantic_clipper(
            ref, qry, self.cfg.sigma, self.cfg.epsilon,
            self.cfg.num_inliers_threshold,
            self.cfg.descriptor_matching_threshold, seed=seed,
            device=self.device)
        if not found:
            return False, None
        # the caller-side inversion (place_recognition.cpp:624)
        return True, np.linalg.inv(tf)

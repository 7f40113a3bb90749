"""SlideMatch's decisions, worked out again in f64 by exhaustive search.

Upstream (place_recognition.cpp): findTransformation (:736-944) searches
yaw candidates and an x/y grid of translations for the one that puts the
most query objects within `match_threshold_position` of a map object of
the same label (:98-387, the exact matching of :281-357); below the inlier
gate nothing is found; above it the matched pairs are fitted by least
squares (solveLSQ, :632-695). The intra entry point (:389-496) projects a
keyframe's body-frame measurements into the map by the query pose and
composes the closure; the inter one (:498-538) centres both maps on their
centroids and sizes the search to them.

The program searches the same candidates by a raster correlation and an
exact rescore of its best raster cells; this module scores every candidate
exactly. Its search is the one the program documents: yaw candidates from
`-half` in steps of `search_yaw_step_size_degrees` with 0 always among
them, coarsened evenly to `n_yaw` where there are more; translations at
the multiples of one step within +-half on each axis, the step being
2 * extent / `fine_grid` but never under thresh / (`disk_radius_cells` -
0.5), where the extent is the larger of (the query's largest |x|, |y| +
half + thresh + 1) and (the map's largest |x|, |y| + thresh + 1). After
the fit, a few rounds of re-matching (each query object to the nearest
map object of its label within the threshold) and re-fitting keep the
round with the most pairs, then the lowest RMS; the closure is the
left-composed map-frame correction `inv(C) @ lc @ Q` with z set to 0. Both
are the documented deviations of the port from upstream (PARITY.md 1-3).

Rows are [label, x, y, z, d1, d2, d3]; poses are [qw, qx, qy, qz, tx, ty,
tz]. Every function takes `rnd`, the rounding of the control, applied to
the object positions it is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .precision import exact

# translation cells scored per block of (pair, offset) entries
_BLOCK = 1 << 21


@dataclass
class Search:
    """One findTransformation. `n_grid` is the winning candidate's inlier
    count, `pairs` maps each of its inlier query rows to the first map row
    (lowest index) within the threshold, `runner_up` is the best count of
    a candidate whose pairs differ, `xyyaw` the winner in the searched
    (centred) frame; `n_inliers` is the count the search returns (the
    larger of `n_grid` and the re-fit's pairs)."""
    found: bool
    n_grid: int
    n_inliers: int = 0
    pairs: Dict[int, int] = field(default_factory=dict)
    runner_up: int = 0
    xyyaw: Optional[Tuple[float, float, float]] = None
    tf: Optional[np.ndarray] = None
    fit: Tuple[int, float] = (0, np.inf)
    icp_edge: float = np.inf
    # the searched rows (centred for an inter search) and [Q, M] pairs of
    # the same label
    frame: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def yaw_candidates(half_deg: float, step_deg: float, disable: bool,
                   n_max: int) -> np.ndarray:
    """The searched yaws, in radians, each once."""
    if disable:
        return np.zeros(1)
    n = int(np.ceil((2 * half_deg - 1e-9) / step_deg))
    ys = [-half_deg + i * step_deg for i in range(max(n, 0))]
    ys = [y for y in ys if y < half_deg - 1e-9]
    if not any(abs(y) < 1e-12 for y in ys):
        ys.append(0.0)
    ys = np.sort(np.asarray(ys, np.float64))
    if len(ys) > n_max:
        ys = -half_deg + np.arange(n_max) * (2.0 * half_deg / n_max)
    return np.deg2rad(ys)


def grid_step(ref_xy, qry_xy, half: float, thresh: float, grid: dict):
    ext = max(np.abs(qry_xy).max(initial=0.0) + half + thresh + 1.0,
              np.abs(ref_xy).max(initial=0.0) + thresh + 1.0)
    return max(2.0 * ext / grid["fine_grid"],
               thresh / (grid["disk_radius_cells"] - 0.5))


def pair_ok(ref, qry, pr: dict) -> np.ndarray:
    """[Q, M]: same label, and (unless ignored) dimensions within
    `match_threshold_dimension` (a cylinder, d2 = d3 = 0, compares d1)."""
    ok = ref[None, :, 0] == qry[:, None, 0]
    if not pr["ignore_dimension"]:
        cyl = (ref[:, 5] == 0) & (ref[:, 6] == 0)
        dd = np.abs(ref[None, :, 4:7] - qry[:, None, 4:7])
        avg = np.where(cyl[None, :], dd[:, :, 0], dd.mean(-1))
        ok &= avg < pr["match_threshold_dimension"]
    return ok


def rot2(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


def _grid_scores(ref, qry, ok, yaws, kx_max, ky_max, step, thresh):
    """Every candidate that matches at least one object: (flat index over
    (yaw, kx, ky), inlier count, two set signatures, and for the winner
    the pairs). Candidates that match nothing count 0."""
    nx, ny = 2 * kx_max + 1, 2 * ky_max + 1
    qi, mi = np.nonzero(ok)
    if len(qi) == 0:
        return None
    Q, M = ok.shape
    rng = np.random.default_rng(12345)
    w1 = rng.integers(1, 1 << 40, size=(Q, M))
    w2 = rng.integers(1, 1 << 40, size=(Q, M))
    r = int(np.ceil(thresh / step)) + 1
    off = np.arange(-r, r + 1)
    ox, oy = [a.reshape(-1) for a in np.meshgrid(off, off, indexing="ij")]
    per = max(1, _BLOCK // len(ox))
    cells, qs, ms = [], [], []
    for y, yaw in enumerate(yaws):
        p = qry[:, 1:3] @ rot2(yaw).T                       # [Q, 2]
        for lo in range(0, len(qi), per):
            q, m = qi[lo:lo + per], mi[lo:lo + per]
            c = ref[m, 1:3] - p[q]                         # [P, 2]
            kx = np.rint(c[:, 0] / step).astype(np.int64)[:, None] + ox
            ky = np.rint(c[:, 1] / step).astype(np.int64)[:, None] + oy
            dx = p[q, 0][:, None] + kx * step - ref[m, 1][:, None]
            dy = p[q, 1][:, None] + ky * step - ref[m, 2][:, None]
            hit = ((np.sqrt(dx * dx + dy * dy) < thresh)
                   & (np.abs(kx) <= kx_max) & (np.abs(ky) <= ky_max))
            pi, oi = np.nonzero(hit)
            cells.append((y * nx + kx[pi, oi] + kx_max) * ny
                         + ky[pi, oi] + ky_max)
            qs.append(q[pi])
            ms.append(m[pi])
    cell = np.concatenate(cells)
    q = np.concatenate(qs)
    m = np.concatenate(ms)
    if len(cell) == 0:
        return None
    # the first map row of each (candidate, query): sort by all three
    order = np.lexsort((m, q, cell))
    cell, q, m = cell[order], q[order], m[order]
    first = np.ones(len(cell), bool)
    first[1:] = (cell[1:] != cell[:-1]) | (q[1:] != q[:-1])
    cell, q, m = cell[first], q[first], m[first]
    starts = np.flatnonzero(np.r_[True, cell[1:] != cell[:-1]])
    ucell = cell[starts]
    count = np.diff(np.r_[starts, len(cell)])
    sig1 = np.add.reduceat(w1[q, m], starts)
    sig2 = np.add.reduceat(w2[q, m], starts)
    return ucell, count, sig1, sig2, (cell, q, m), (nx, ny)


def grid_search(ref, qry, yaws, half_x, half_y, thresh, step, ok):
    """The winner of the exhaustive search: (count, pairs {q: m}, the
    best count of a candidate with other pairs, (x, y, yaw)). Among equal
    counts the first candidate in (yaw, x, y) order wins."""
    kx_max = int(np.floor((half_x + 1e-6) / step))
    ky_max = int(np.floor((half_y + 1e-6) / step))
    res = _grid_scores(ref, qry, ok, yaws, kx_max, ky_max, step, thresh)
    if res is None:
        return 0, {}, 0, (0.0, 0.0, float(yaws[0]))
    ucell, count, sig1, sig2, (cell, q, m), (nx, ny) = res
    best = int(count.max())
    w = int(np.flatnonzero(count == best)[0])
    other = (sig1 != sig1[w]) | (sig2 != sig2[w])
    # a candidate that matches nothing has no pairs and counts 0
    runner = int(count[other].max()) if other.any() else 0
    sel = cell == ucell[w]
    pairs = dict(zip(q[sel].tolist(), m[sel].tolist()))
    y, rest = divmod(int(ucell[w]), nx * ny)
    kx, ky = divmod(rest, ny)
    return best, pairs, runner, ((kx - kx_max) * step, (ky - ky_max) * step,
                                 float(yaws[y]))


def solve_lsq(ref_pts, det_pts) -> np.ndarray:
    """The rigid transform [4, 4] that carries det_pts onto ref_pts in
    least squares (the SVD of their cross-covariance, a reflection turned
    into a rotation)."""
    a = np.asarray(det_pts, np.float64)
    b = np.asarray(ref_pts, np.float64)
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T)) or 1.0
    R = Vt.T @ D @ U.T
    tf = np.eye(4)
    tf[:3, :3] = R
    tf[:3, 3] = cb - R @ ca
    return tf


def icp_refine(tf, ref, qry, pr: dict, iters: int):
    """Rounds of re-matching and re-fitting from `tf` (query -> map): each
    query object to the nearest map object of its label (first on ties)
    within the threshold; stops when fewer than 3 match. Returns (tf,
    pairs, rms) of the round with the most pairs, then the lowest rms,
    and the smallest margin of any round's matching to its threshold or
    to a second map object (a round decided by less is on a knife edge)."""
    thresh = pr["match_threshold_position"]
    if len(ref) == 0 or len(qry) == 0:
        return tf, 0, np.inf, np.inf
    ok = pair_ok(ref, qry, pr)
    best = (0, np.inf, tf)
    edge = np.inf
    for _ in range(iters):
        q = qry[:, 1:4] @ tf[:3, :3].T + tf[:3, 3]
        d = np.sqrt(((q[:, None, :2] - ref[None, :, 1:3]) ** 2).sum(-1))
        d = np.where(ok, d, np.inf)
        j = np.argmin(d, axis=1)
        dj = d[np.arange(len(qry)), j]
        inside = dj < thresh
        fin = np.isfinite(dj)
        edge = min(edge, float(np.abs(dj[fin] - thresh).min(initial=np.inf)))
        if ok.shape[1] > 1:
            two = np.sort(d[inside], axis=1)[:, :2]
            edge = min(edge, float((two[:, 1] - two[:, 0]).min(
                initial=np.inf)))
        n = int(inside.sum())
        if n < 3:
            break
        tf = solve_lsq(ref[j[inside], 1:4], qry[inside, 1:4])
        res = qry[inside, 1:4] @ tf[:3, :3].T + tf[:3, 3] - ref[j[inside], 1:4]
        rms = float(np.sqrt(np.mean((res ** 2).sum(1))))
        if n > best[0] or (n == best[0] and rms < best[1]):
            best = (n, rms, tf)
    return best[2], best[0], best[1], edge


def tf_from_xyyaw(x, y, yaw, z=0.0) -> np.ndarray:
    tf = np.eye(4)
    tf[:2, :2] = rot2(yaw)
    tf[:3, 3] = x, y, z
    return tf


def pose_matrix(p) -> np.ndarray:
    """[qw, qx, qy, qz, tx, ty, tz] -> [4, 4] (the quaternion normalised)."""
    p = np.asarray(p, np.float64)
    w, x, y, z = p[:4] / np.linalg.norm(p[:4])
    tf = np.eye(4)
    tf[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]]
    tf[:3, 3] = p[4:7]
    return tf


def _rows(a, rnd):
    a = np.asarray(a, np.float64).reshape(-1, 7).copy()
    a[:, 1:4] = rnd(a[:, 1:4])
    return a


def find_transformation(ref, qry, intra: bool, pr: dict, grid: dict,
                        rnd=exact) -> Search:
    """findTransformation on rows [label, x, y, z, d1, d2, d3]; the
    transform carries query positions onto map positions."""
    ref, qry = _rows(ref, rnd), _rows(qry, rnd)
    if len(ref) == 0 or len(qry) == 0:
        return Search(False, 0)
    thresh = pr["match_threshold_position"]
    cen_ref, cen_qry = np.zeros(2), np.zeros(2)
    r, q = ref, qry
    if not intra:
        cen_ref, cen_qry = ref[:, 1:3].mean(0), qry[:, 1:3].mean(0)
        r, q = ref.copy(), qry.copy()
        r[:, 1:3] -= cen_ref
        q[:, 1:3] -= cen_qry
        b = np.maximum(np.abs(r[:, 1:3]).max(0), np.abs(q[:, 1:3]).max(0))
        half_x, half_y = b
        if not pr["disable_yaw_search"]:
            half_x = half_y = max(half_x, half_y)
        half_x *= pr["dilation_factor"]
        half_y *= pr["dilation_factor"]
        yaw_half = pr["match_yaw_half_range"]
    else:
        half_x = pr["match_x_half_range_intra"]
        half_y = pr["match_y_half_range_intra"]
        yaw_half = pr["match_yaw_half_range_intra"]
    yaws = yaw_candidates(yaw_half, pr["search_yaw_step_size_degrees"],
                          pr["disable_yaw_search"], grid["n_yaw"])
    step = grid_step(r[:, 1:3], q[:, 1:3], max(half_x, half_y), thresh, grid)
    ok = pair_ok(ref, qry, pr)
    n, pairs, runner, xyyaw = grid_search(r, q, yaws, half_x, half_y,
                                          thresh, step, ok)
    out = Search(False, n, n, pairs, runner, xyyaw, frame=(r, q, ok))
    gate = pr["min_num_inliers"]
    if intra and pr["min_num_inliers_intra"]:
        gate = pr["min_num_inliers_intra"]
    if n < gate:
        return out
    out.found = True
    if pr["use_nonlinear_least_squares"] and len(pairs) >= 3:
        qs = np.fromiter(pairs.keys(), np.int64)
        ms = np.fromiter(pairs.values(), np.int64)
        tf = solve_lsq(ref[ms, 1:4], qry[qs, 1:4])
        tf, n_fit, rms, out.icp_edge = icp_refine(tf, ref, qry, pr, 3)
        out.n_inliers = max(n, n_fit)
        out.fit = (n_fit, rms)
    else:
        out.fit = (n, float(thresh))
        tf = tf_from_xyyaw(xyyaw[0], xyyaw[1], xyyaw[2])
        if not intra:
            tf = (tf_from_xyyaw(cen_ref[0], cen_ref[1], 0.0) @ tf
                  @ tf_from_xyyaw(-cen_qry[0], -cen_qry[1], 0.0))
    out.tf = tf
    return out


def intra_closure(measurements, submap, query_pose, candidate_pose,
                  pr: dict, grid: dict, rnd=exact):
    """findIntraLoopClosure: (found, closure [4, 4] query -> candidate,
    the search or None). Fewer than 4 measurements or an empty submap:
    no search; a found transform whose re-fit kept no pair: not found."""
    meas = np.asarray(measurements, np.float64).reshape(-1, 7)
    submap = np.asarray(submap, np.float64).reshape(-1, 7)
    if len(meas) < 4 or len(submap) == 0:
        return False, None, None
    Q = pose_matrix(query_pose)
    Q[:3, 3] = rnd(Q[:3, 3])
    C = pose_matrix(candidate_pose)
    C[:3, 3] = rnd(C[:3, 3])
    in_map = meas.copy()
    in_map[:, 1:4] = rnd(meas[:, 1:4]) @ Q[:3, :3].T + Q[:3, 3]
    s = find_transformation(submap, in_map, True, pr, grid, rnd)
    if not s.found or s.fit[0] == 0:
        return False, None, s
    yaw = np.arctan2(s.tf[1, 0], s.tf[0, 0])
    lc = tf_from_xyyaw(s.tf[0, 3], s.tf[1, 3], yaw, 0.0)
    return True, np.linalg.inv(C) @ lc @ Q, s


def inter_closure(reference_map, query_map, pr: dict, grid: dict,
                  rnd=exact):
    """findInterLoopClosure: (found, query -> map [4, 4], the search or
    None). A map with fewer than `min_num_map_objects_to_start` objects:
    no search."""
    ref = np.asarray(reference_map, np.float64).reshape(-1, 7)
    qry = np.asarray(query_map, np.float64).reshape(-1, 7)
    least = pr["min_num_map_objects_to_start"]
    if len(ref) < least or len(qry) < least:
        return False, None, None
    s = find_transformation(ref, qry, False, pr, grid, rnd)
    if not s.found:
        return False, None, s
    yaw = np.arctan2(s.tf[1, 0], s.tf[0, 0])
    return True, tf_from_xyyaw(s.tf[0, 3], s.tf[1, 3], yaw, s.tf[2, 3]), s


def distances_at(ref, qry, ok, x, y, yaw):
    """[Q, M] distances of the label-compatible pairs at one candidate
    (inf elsewhere), in the searched frame."""
    p = np.asarray(qry, np.float64)[:, 1:3] @ rot2(yaw).T + [x, y]
    d = np.sqrt(((p[:, None, :] - np.asarray(ref, np.float64)[None, :, 1:3])
                 ** 2).sum(-1))
    return np.where(ok, d, np.inf)

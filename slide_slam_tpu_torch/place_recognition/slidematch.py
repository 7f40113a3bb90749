"""SlideMatch place recognition (PyTorch twin of
slide_slam_tpu/place_recognition/slidematch.py).

The reference runs an anytime CPU grid search over SE(2) x yaw
(place_recognition.cpp:98-387). Here the whole grid is scored at once:

1. **Label rasters** (exact disk splats): per semantic-label bin, a fine
   occupancy grid R[l, i, j] = "some map object with label l lies within
   match_threshold of this cell centre", built by a masked `scatter_reduce`
   (amax) of a DS x DS disk stencil around every map object.
2. **Dense scoring**: per yaw candidate, the rotated query objects are
   counted into a raster (masked `index_add_`) and the inlier counts for
   every translation are the per-label cross-correlation with R:
   counts = sum_l irfft2(conj(rfft2(Q_l)) * rfft2(R_l)), rounded.
3. **Exact rescore** of the top-K raster candidates with the reference's
   exact criteria (label equality, exact XY distance, optional dimension
   check, first-map-match pairing, place_recognition.cpp:281-357).

Differences of form from the JAX version, not of result:
* out-of-range raster cells are masked (they add 0 / take the max with 0)
  instead of being sent to a dropped sentinel index, which is a device
  assert on CUDA;
* the top-K keeps `lax.top_k`'s tie order (equal counts: lower flat index
  first) through one int64 key per cell, (count, -index), as
  ops/submap.py does; `torch.topk` alone orders ties arbitrarily;
* the K exact rescores run as one batch instead of `lax.map`.

The host protocol matches findTransformation (:736-944): min-inlier gate,
then Umeyama LSQ refinement (solveLSQ :632-695) and ICP polish, or the raw
grid transform.
"""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import PlaceRecognitionConfig
from ..geometry import se3np

N_LABEL_BINS = 16


@dataclass(frozen=True)
class SlideMatchDims:
    """Static raster shapes (independent of the data)."""
    fine_grid: int = 512       # label-raster resolution per axis
    disk_radius_cells: int = 8
    max_objects: int = 384     # padded map/query object count
    n_yaw: int = 24
    rescore_topk: int = 64


def _pad_objects(objs: np.ndarray, n: int, device):
    objs = np.asarray(objs, np.float32).reshape(-1, 7)
    if len(objs) > n:
        raise ValueError(
            f"map has {len(objs)} objects but kernel capacity is {n}; "
            "use _bucket_capacity to auto-size (silent truncation forbidden)")
    k = len(objs)
    out = np.zeros((n, 7), np.float32)
    out[:k] = objs[:k]
    mask = np.zeros((n,), bool)
    mask[:k] = True
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(mask, device=device))


def _bucket_capacity(n: int, base: int) -> int:
    """Smallest multiple of 128 >= max(n, base): a map is never truncated
    (that would change the answer); the padded capacity grows instead."""
    need = max(n, base)
    return ((need + 127) // 128) * 128


_label_bin_wraps = 0   # diagnostic counter (see _compact_label_bins)


def _compact_label_bins(ref_labels: np.ndarray, qry_labels: np.ndarray):
    """Map raw label values to compact raster bins, shared by both maps:
    distinct labels stay in distinct planes while <= N_LABEL_BINS occur;
    beyond that bins wrap modulo, which only blurs the candidate ranking
    (the exact rescore compares raw label values)."""
    uniq = np.unique(np.concatenate([ref_labels, qry_labels]))
    if len(uniq) > N_LABEL_BINS:
        global _label_bin_wraps
        _label_bin_wraps += 1
        logging.getLogger(__name__).debug(
            "slidematch: %d distinct labels > %d raster bins; candidate "
            "ranking blurred (wrap #%d)", len(uniq), N_LABEL_BINS,
            _label_bin_wraps)
    lut = {v: i % N_LABEL_BINS for i, v in enumerate(uniq.tolist())}
    rb = np.asarray([lut[v] for v in ref_labels.tolist()], np.int32)
    qb = np.asarray([lut[v] for v in qry_labels.tolist()], np.int32)
    return rb, qb


def _topk_first_index(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of int tensor x (1-D), ordered as
    `lax.top_k` orders them: descending value, equal values lower index
    first. One unique int64 key per entry, value major, -index minor."""
    n = x.shape[0]
    ar = torch.arange(n, device=x.device, dtype=torch.int64)
    key = x.to(torch.int64) * n + (n - 1 - ar)
    top = torch.topk(key, k, sorted=True).indices
    return top


def raster_counts(dims: SlideMatchDims, ref, ref_mask, qry, qry_mask,
                  ref_bin, qry_bin, yaws, half_x, half_y, thresh):
    """Steps 1-2: the unrounded correlation counts [Y, F, F] and the
    translation of each shift index (tvals [F]). Scalars are 0-d f32
    tensors on the device."""
    F = dims.fine_grid
    DR = dims.disk_radius_cells
    dev = ref.device
    L = N_LABEL_BINS
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    ref_xy = ref[:, 1:3]
    qry_xy = qry[:, 1:3]
    ref_ext = torch.max(torch.where(ref_mask[:, None], torch.abs(ref_xy),
                                    zero))
    qry_ext = torch.max(torch.where(qry_mask[:, None], torch.abs(qry_xy),
                                    zero))
    half = torch.maximum(half_x, half_y)
    ext = qry_ext + half + thresh + 1.0
    ext = torch.maximum(ext, ref_ext + thresh + 1.0)
    # the raster must cover +-ext and fit the match disk in the stencil
    fine_step = torch.maximum(2.0 * ext / F, thresh / (DR - 0.5))

    # ---- 1. label rasters by exact disk splatting ----------------------
    label_bin = torch.clamp(ref_bin, 0, L - 1).long()
    base = torch.floor((ref_xy + ext) / fine_step).to(torch.int64)  # [M,2]
    offs = torch.arange(-DR, DR + 1, device=dev)
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")              # [D,D]
    cell_x = base[:, 0, None, None] + ox[None]                      # [M,D,D]
    cell_y = base[:, 1, None, None] + oy[None]
    cx = (cell_x.to(torch.float32) + 0.5) * fine_step - ext
    cy = (cell_y.to(torch.float32) + 0.5) * fine_step - ext
    inside = ((cx - ref_xy[:, 0, None, None]) ** 2
              + (cy - ref_xy[:, 1, None, None]) ** 2) < thresh ** 2
    inside = inside & ref_mask[:, None, None]
    ok = ((cell_x >= 0) & (cell_x < F) & (cell_y >= 0) & (cell_y < F)
          & inside)
    flat = label_bin[:, None, None] * F * F + cell_x * F + cell_y
    flat = torch.where(ok, flat, torch.zeros_like(flat)).reshape(-1)
    raster = torch.zeros((L * F * F,), dtype=torch.float32, device=dev)
    raster.scatter_reduce_(0, flat, ok.reshape(-1).to(torch.float32),
                           reduce="amax")
    R_fft = torch.fft.rfft2(raster.reshape(L, F, F))

    # ---- 2. dense scoring over (yaw, tx, ty) by FFT --------------------
    q_bin = torch.clamp(qry_bin, 0, L - 1).long()
    counts = []
    for y in range(yaws.shape[0]):
        c, s_ = torch.cos(yaws[y]), torch.sin(yaws[y])
        qr_x = c * qry_xy[:, 0] - s_ * qry_xy[:, 1]
        qr_y = s_ * qry_xy[:, 0] + c * qry_xy[:, 1]
        cxq = torch.floor((qr_x + ext) / fine_step).to(torch.int64)
        cyq = torch.floor((qr_y + ext) / fine_step).to(torch.int64)
        inb = (cxq >= 0) & (cxq < F) & (cyq >= 0) & (cyq < F) & qry_mask
        flat_q = torch.where(inb, q_bin * F * F + cxq * F + cyq,
                             torch.zeros_like(cxq))
        qcnt = torch.zeros((L * F * F,), dtype=torch.float32, device=dev)
        qcnt.index_add_(0, flat_q, inb.to(torch.float32))
        Q_fft = torch.fft.rfft2(qcnt.reshape(L, F, F))
        corr = torch.fft.irfft2(torch.conj(Q_fft) * R_fft, s=(F, F))
        counts.append(torch.sum(corr, dim=0))
    k = torch.arange(F, device=dev)
    k_signed = torch.where(k > F // 2, k - F, k).to(torch.float32)
    return torch.stack(counts), k_signed * fine_step


def _slidematch_kernel(dims: SlideMatchDims, ref, ref_mask, qry, qry_mask,
                       ref_bin, qry_bin, yaws, half_x, half_y, thresh,
                       dim_thresh, ignore_dimension: bool) -> torch.Tensor:
    """Raster scoring + exact rescore. Returns one packed [1 + Q, 9] f32
    tensor: head [x, y, yaw, n_inliers, 0...], then per query object
    [has_match, ref label xyz, query label xyz]."""
    F = dims.fine_grid
    counts, tvals = raster_counts(dims, ref, ref_mask, qry, qry_mask,
                                  ref_bin, qry_bin, yaws, half_x, half_y,
                                  thresh)
    counts = torch.round(counts).to(torch.int32)
    t_mask = ((torch.abs(tvals)[:, None] <= half_x + 1e-6)
              & (torch.abs(tvals)[None, :] <= half_y + 1e-6))          # [F,F]
    counts = torch.where(t_mask[None], counts, torch.full_like(counts, -1))

    # ---- 3. exact rescore of the top-K raster candidates ---------------
    top_idx = _topk_first_index(counts.reshape(-1), dims.rescore_topk)
    yaw_i = top_idx // (F * F)
    tx_i = (top_idx // F) % F
    ty_i = top_idx % F
    cand = torch.stack([tvals[tx_i], tvals[ty_i], yaws[yaw_i]], dim=1)  # [K,3]

    ref_xy = ref[:, 1:3]
    qry_xy = qry[:, 1:3]
    ref_dims = ref[:, 4:7]
    qry_dims = qry[:, 4:7]
    # avg dim diff with the cylinder special case (only dim1 nonzero,
    # place_recognition.cpp:315-330)
    cyl_like = (ref_dims[:, 1] == 0) & (ref_dims[:, 2] == 0)          # [M]
    dd = torch.abs(ref_dims[None, :, :] - qry_dims[:, None, :])       # [Q,M,3]
    avg_dd = torch.where(cyl_like[None, :], dd[:, :, 0], torch.mean(dd, -1))
    label_eq = ref[None, :, 0] == qry[:, None, 0]                     # [Q,M]
    dim_ok = (torch.ones_like(label_eq) if ignore_dimension
              else avg_dd < dim_thresh)
    pair_ok = label_eq & dim_ok & ref_mask[None, :] & qry_mask[:, None]

    def exact_match(c3):                                              # [K,3]
        cth, sth = torch.cos(c3[:, 2:3]), torch.sin(c3[:, 2:3])
        qx = cth * qry_xy[None, :, 0] - sth * qry_xy[None, :, 1] + c3[:, 0:1]
        qy = sth * qry_xy[None, :, 0] + cth * qry_xy[None, :, 1] + c3[:, 1:2]
        d2 = ((qx[:, :, None] - ref_xy[None, None, :, 0]) ** 2
              + (qy[:, :, None] - ref_xy[None, None, :, 1]) ** 2)     # [K,Q,M]
        return pair_ok[None] & (torch.sqrt(d2) < thresh)

    exact_counts = exact_match(cand).any(dim=2).sum(dim=1)            # [K]
    best = torch.argmax(exact_counts)
    best_c = cand[best]
    best_match = exact_match(best_c[None])[0]                         # [Q,M]
    has_match = best_match.any(dim=1)
    first_m = torch.argmax(best_match.to(torch.uint8), dim=1)
    ref_rows = ref[first_m]
    ref_pairs = torch.cat([ref_rows[:, 0:1], ref_rows[:, 1:4]], dim=1)
    det_pairs = torch.cat([qry[:, 0:1], qry[:, 1:4]], dim=1)
    head = torch.zeros((1, 9), dtype=torch.float32, device=ref.device)
    head[0, :3] = best_c
    head[0, 3] = exact_counts[best].to(torch.float32)
    body = torch.cat([has_match[:, None].to(torch.float32), ref_pairs,
                      det_pairs], dim=1)
    return torch.cat([head, body], dim=0)


# ---------------------------------------------------------------------------
# Host-level protocol (findTransformation / findIntra / findInter)
# ---------------------------------------------------------------------------


def _yaw_candidates(half_deg: float, step_deg: float, disable: bool,
                    n_max: int) -> np.ndarray:
    if disable:
        return np.zeros((1,), np.float32)
    ys = np.arange(-half_deg, half_deg - 1e-9, step_deg, dtype=np.float32)
    if 0.0 not in ys:
        # always test the identity yaw: arange(-10, 10, 15) = [-10, 5]
        # misses 0, and an intra query is usually near identity
        ys = np.sort(np.concatenate([ys, np.zeros((1,), np.float32)]))
    if len(ys) == 0:
        ys = np.zeros((1,), np.float32)
    if len(ys) > n_max:
        # coarsen uniformly to the static budget
        ys = np.linspace(-half_deg, half_deg, n_max, endpoint=False,
                         dtype=np.float32)
    out = np.zeros((n_max,), np.float32)
    out[:len(ys)] = np.deg2rad(ys)
    out[len(ys):] = np.deg2rad(ys[-1])  # repeat last (harmless duplicates)
    return out


def solve_lsq(ref_pts: np.ndarray, det_pts: np.ndarray):
    """Umeyama rigid fit det -> ref (place_recognition.cpp:632-695)."""
    src = np.asarray(det_pts, np.float64)
    tgt = np.asarray(ref_pts, np.float64)
    mu_s, mu_t = src.mean(0), tgt.mean(0)
    H = (src - mu_s).T @ (tgt - mu_t)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        V2 = Vt.T.copy()
        V2[:, 2] *= -1
        R = V2 @ U.T
    t = mu_t - R @ mu_s
    tf = np.eye(4)
    tf[:3, :3] = R
    tf[:3, 3] = t
    return tf


def _icp_refine(tf: np.ndarray, ref: np.ndarray, qry: np.ndarray, cfg,
                iters: int = 3):
    """Re-match object pairs at the current TF and re-fit, a few rounds.

    ref/qry: [*, 7] rows [label, x, y, z, d1, d2, d3] in the original
    frame; tf maps query positions onto reference positions. Matching uses
    the exact-rescore gates. Returns (tf, n_pairs, rms) of the best
    iterate (most pairs, then lowest rms)."""
    if len(ref) == 0 or len(qry) == 0:
        return tf, 0, np.inf
    label_eq = ref[None, :, 0] == qry[:, None, 0]
    if not cfg.ignore_dimension:
        cyl_like = (ref[:, 5] == 0) & (ref[:, 6] == 0)
        dd = np.abs(ref[None, :, 4:7] - qry[:, None, 4:7])
        avg_dd = np.where(cyl_like[None, :], dd[:, :, 0], dd.mean(-1))
        label_eq = label_eq & (avg_dd < cfg.match_threshold_dimension)
    best = (0, np.inf, tf)
    for _ in range(iters):
        q = qry[:, 1:4] @ tf[:3, :3].T + tf[:3, 3]
        d = np.linalg.norm(q[:, None, :2] - ref[None, :, 1:3], axis=-1)
        d = np.where(label_eq, d, np.inf)
        j = np.argmin(d, axis=1)
        ok = d[np.arange(len(qry)), j] < cfg.match_threshold_position
        if int(ok.sum()) < 3:
            break
        n_ok = int(ok.sum())
        tf = solve_lsq(ref[j[ok], 1:4], qry[ok, 1:4])
        q2 = qry[ok, 1:4] @ tf[:3, :3].T + tf[:3, 3]
        rms = float(np.sqrt(np.mean(
            np.sum((q2 - ref[j[ok], 1:4]) ** 2, axis=1))))
        if n_ok > best[0] or (n_ok == best[0] and rms < best[1]):
            best = (n_ok, rms, tf)
    return best[2], best[0], best[1]


def _tf_from_xyyaw(x, y, yaw, z=0.0):
    tf = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    tf[0, 0], tf[0, 1], tf[1, 0], tf[1, 1] = c, -s, s, c
    tf[0, 3], tf[1, 3], tf[2, 3] = x, y, z
    return tf


class PlaceRecognition:
    """SlideMatch searcher (one per node). Its raster work runs on
    `device`; everything else is host numpy."""

    def __init__(self, cfg: PlaceRecognitionConfig,
                 dims: Optional[SlideMatchDims] = None, device="cuda"):
        self.cfg = cfg
        self.dims = dims or SlideMatchDims()
        self.device = torch.device(device)

    # -- core --------------------------------------------------------------
    def find_transformation(self, reference_objects: np.ndarray,
                            query_objects: np.ndarray, intra: bool):
        """Returns (found, xyzyaw [4], tf [4,4], n_inliers, fit).

        fit = (n_pairs, rms) of the accepted LSQ/ICP fit (the closure
        noise proxy); on the raster-only path the rms is proxied by
        match_threshold_position. Rows: [label, x, y, z, d1, d2, d3]."""
        cfg = self.cfg
        reference_objects = np.asarray(reference_objects,
                                       np.float32).reshape(-1, 7)
        query_objects = np.asarray(query_objects, np.float32).reshape(-1, 7)
        if len(reference_objects) == 0 or len(query_objects) == 0:
            return False, None, None, 0, (0, np.inf)
        orig_ref = reference_objects
        orig_qry = query_objects

        cen_ref = np.zeros(2)
        cen_qry = np.zeros(2)
        if not intra:
            # centroid shift + auto search range (place_recognition.cpp:745-798)
            cen_ref = reference_objects[:, 1:3].mean(0)
            cen_qry = query_objects[:, 1:3].mean(0)
            reference_objects = reference_objects.copy()
            query_objects = query_objects.copy()
            reference_objects[:, 1:3] -= cen_ref
            query_objects[:, 1:3] -= cen_qry
            b_ref = np.abs(reference_objects[:, 1:3]).max(0)
            b_qry = np.abs(query_objects[:, 1:3]).max(0)
            half_x = max(b_ref[0], b_qry[0])
            half_y = max(b_ref[1], b_qry[1])
            if not cfg.disable_yaw_search:
                half_x = half_y = max(half_x, half_y)
            half_x *= cfg.dilation_factor
            half_y *= cfg.dilation_factor
            yaw_half = cfg.match_yaw_half_range
        else:
            half_x = cfg.match_x_half_range_intra
            half_y = cfg.match_y_half_range_intra
            yaw_half = cfg.match_yaw_half_range_intra

        yaws = _yaw_candidates(yaw_half, cfg.search_yaw_step_size_degrees,
                               cfg.disable_yaw_search, self.dims.n_yaw)
        cap = _bucket_capacity(max(len(reference_objects),
                                   len(query_objects)), self.dims.max_objects)
        dims = (self.dims if cap == self.dims.max_objects
                else dataclasses.replace(self.dims, max_objects=cap))
        dev = self.device
        ref_p, ref_m = _pad_objects(reference_objects, dims.max_objects, dev)
        qry_p, qry_m = _pad_objects(query_objects, dims.max_objects, dev)
        rb, qb = _compact_label_bins(reference_objects[:, 0],
                                     query_objects[:, 0])
        rb_p = np.zeros((dims.max_objects,), np.int32)
        rb_p[:len(rb)] = rb
        qb_p = np.zeros((dims.max_objects,), np.int32)
        qb_p[:len(qb)] = qb

        def f32(x):
            return torch.tensor(np.float32(x), device=dev)

        packed = _slidematch_kernel(
            dims, ref_p, ref_m, qry_p, qry_m,
            torch.as_tensor(rb_p, device=dev),
            torch.as_tensor(qb_p, device=dev),
            torch.as_tensor(yaws, device=dev), f32(half_x), f32(half_y),
            f32(cfg.match_threshold_position),
            f32(cfg.match_threshold_dimension),
            cfg.ignore_dimension).cpu().numpy()    # one device->host copy
        res_x, res_y, res_yaw, n_inliers = packed[0, :4]
        n_inliers = int(n_inliers)
        gate = (cfg.min_num_inliers_intra
                if (intra and cfg.min_num_inliers_intra)
                else cfg.min_num_inliers)
        if n_inliers < gate:
            return False, None, None, n_inliers, (0, np.inf)

        pair_mask = packed[1:, 0] > 0.5
        ref_pts = packed[1:, 1:5][pair_mask][:, 1:4]
        det_pts = packed[1:, 5:9][pair_mask][:, 1:4]
        if not intra:
            ref_pts = ref_pts.copy()
            det_pts = det_pts.copy()
            ref_pts[:, :2] += cen_ref
            det_pts[:, :2] += cen_qry

        if cfg.use_nonlinear_least_squares and len(ref_pts) >= 3:
            # LSQ fit, then ICP re-match + re-fit on the exact positions
            # (the JAX package's documented deviation, PARITY.md)
            tf = solve_lsq(ref_pts, det_pts)
            tf, n_ref, fit_rms = _icp_refine(tf, orig_ref, orig_qry, cfg)
            n_inliers = max(n_inliers, n_ref)
            fit = (n_ref, fit_rms)
        else:
            fit = (n_inliers, float(cfg.match_threshold_position))
            tf_raw = _tf_from_xyyaw(float(res_x), float(res_y), float(res_yaw))
            if not intra:
                # revertCentroidShift (place_recognition.cpp:947-967)
                h1 = np.eye(4)
                h1[0, 3], h1[1, 3] = cen_ref
                h2 = np.eye(4)
                h2[0, 3], h2[1, 3] = -cen_qry
                tf = h1 @ tf_raw @ h2
            else:
                tf = tf_raw
        yaw = float(np.arctan2(tf[1, 0], tf[0, 0]))
        xyzyaw = [float(tf[0, 3]), float(tf[1, 3]), float(tf[2, 3]), yaw]
        return True, xyzyaw, tf, n_inliers, fit

    # -- entry points ------------------------------------------------------
    def find_intra_loop_closure(self, measurements: np.ndarray,
                                submap: np.ndarray, query_pose: np.ndarray,
                                candidate_pose: np.ndarray):
        """place_recognition.cpp:389-496. measurements are body-frame rows;
        returns (found, tfFromQuery2Candidate [4,4], fit=(n_pairs, rms))."""
        measurements = np.asarray(measurements, np.float32).reshape(-1, 7)
        if len(measurements) < 4 or len(submap) == 0:
            return False, None, (0, np.inf)
        # project measurements into map frame by the (drifted) query pose
        qmat = se3np.matrix(np.asarray(query_pose, np.float32))
        meas_map = measurements.copy()
        pos_h = np.concatenate(
            [measurements[:, 1:4], np.ones((len(measurements), 1), np.float32)],
            axis=1)
        meas_map[:, 1:4] = (qmat @ pos_h.T).T[:, :3].astype(np.float32)

        found, xyzyaw, _, _, fit = self.find_transformation(submap, meas_map,
                                                            intra=True)
        if not found:
            return False, None, (0, np.inf)
        if fit[0] == 0:
            # the exact re-fit found no supporting pairs: reject rather than
            # add a zero-information closure factor
            return False, None, fit
        x, y, _, yaw = xyzyaw
        # drift correction compose; z forced 0 (place_recognition.cpp:470)
        lc_tf = _tf_from_xyyaw(x, y, yaw, z=0.0)
        q = se3np.matrix(np.asarray(query_pose, np.float32))
        c = se3np.matrix(np.asarray(candidate_pose, np.float32))
        # the JAX package's documented deviation from
        # place_recognition.cpp:480-495: lc_tf is a LEFT map-frame
        # correction, so the closure relative is c^-1 o lc_tf o q
        tf_q2c = np.linalg.inv(c) @ lc_tf @ q
        return True, tf_q2c, fit

    def find_inter_loop_closure(self, reference_map: np.ndarray,
                                query_map: np.ndarray):
        """place_recognition.cpp:498-538: (found, tfFromQueryToRef [4,4])."""
        if (len(reference_map) < self.cfg.min_num_map_objects_to_start
                or len(query_map) < self.cfg.min_num_map_objects_to_start):
            return False, None
        found, xyzyaw, _, _, _ = self.find_transformation(reference_map,
                                                          query_map,
                                                          intra=False)
        if not found:
            return False, None
        x, y, z, yaw = xyzyaw
        return True, _tf_from_xyyaw(x, y, yaw, z)

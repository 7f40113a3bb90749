"""Whether a team run's closure and merge decisions are correct: each one
the program made, held against the plain reference in f64
(slambench/reference/slidematch.py, slidegraph.py, merges.py).

A run keeps (drivers/team_capture.py) each search's host inputs and what
the program made of them, each merge-acceptance call of each node with the
transforms its searches found, and each merge polish. The reference works
every decision out again from those inputs alone:

* decision_mismatch: SlideMatch and SlideGraph searches whose decision
  differs. A SlideMatch decision is whether the search ran (the entry
  point's gates), the grid winner's inlier count and its pairs (each
  inlier query object with the first map object within the threshold),
  whether a transform was found, the inlier count the search returns and
  the pairs of its re-fit. A SlideGraph decision is whether the search ran,
  the ranked associations of the triangle votes, CLIPPER's inlier set and
  whether a transform was found. Left out and counted apart: a SlideMatch
  search whose best count the reference finds tied by a candidate with
  other pairs, or where a pair at the program's own winning candidate or
  in a re-fit lies within `AMBIGUOUS_M` of its threshold (or of a second
  map object); a SlideGraph search where a descriptor pair lies within
  `AMBIGUOUS_DESC` of the threshold, round(F) within `AMBIGUOUS_F` of
  changing, or the last weight kept within `AMBIGUOUS_U` (over the
  largest) of the first left out.
* closure_tf_gap_m, closure_yaw_gap_rad: over the decisions that agree
  and found a transform, and over every merge polish, the largest gap in
  translation between the program's transform and the reference's, and
  the largest angle of the rotation between them (a yaw for every closure
  but the polish, whose 3D fit may tilt).
* merge_mismatch: merges a node's call accepted on one side and not on
  the other, the reference applying its rule to the transforms the
  program's searches found, in their order, node instance by node
  instance (a node that starts again starts with nothing pending). A node
  whose consistency tests come within `AMBIGUOUS_M` of a tolerance is left
  out and counted apart.

The margins follow from f32 against f64 and from CLIPPER's rounding, not
from a deployment, so they are this module's; `cfg["closures"]` states
the settings (drivers/team_capture.settings), and a team cell's workload
states `LIMITS` as its `limits`.
"""
from __future__ import annotations

import time

import numpy as np

from ..reference import merges, slidegraph, slidematch
from ..reference.precision import exact

# Left out and counted apart: a SlideMatch best count that a candidate
# with other pairs ties, and a decision within one of these margins.
# f32 positions at map extents of 40-64 m are 4-8 um apart: a pair or a
# consistency test decided by less than this may fall either way.
AMBIGUOUS_M = 1e-4
# descriptors are f64 on both sides, from the same f32 maps
AMBIGUOUS_DESC = 1e-9
# CLIPPER's F and weights ascend in f32 on the program's side
AMBIGUOUS_F = 1e-3
AMBIGUOUS_U = 1e-3

# What a team cell's workload states as its `limits` (the readings behind
# each limit: PERF.md section 2).
LIMITS = {
    "decision_mismatch": 0,
    "merge_mismatch": 0,
    # f32 against f64 at map extents of 40-64 m: a position's ulp is
    # 3.8-7.6 um and a fit over many pairs averages it (readings
    # 3e-7-1.2e-6 m); 3e-4 m is ~40 ulps at 64 m. bf16's 0.25 m steps
    # there move a closure by 1.8-3.1 cm
    "closure_tf_gap_m": 3e-4,
    # the same ulps over the pairs' 10-40 m lever arms (readings
    # 1e-9-8e-8 rad); bf16 reads 4.5e-4-1.1e-3 rad
    "closure_yaw_gap_rad": 1e-5,
}


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _kernel_side(kernel: dict, n_qry: int):
    """(count, pairs {q: m}, (x, y, yaw)) from the raster's packed result:
    a head [x, y, yaw, count] and per query row [has match, map row's
    label x y z, query row's]; the map row is found in the searched rows."""
    packed = _host(kernel["packed"]).astype(np.float64)
    ref = _host(kernel["ref"])
    pairs = {}
    for i in range(n_qry):
        if packed[1 + i, 0] > 0.5:
            row = packed[1 + i, 1:5].astype(ref.dtype)
            j = np.flatnonzero((ref[:, 0:4] == row).all(1))
            pairs[i] = int(j[0]) if len(j) else -1
    x, y, yaw, n = packed[0, :4]
    return int(n), pairs, (float(x), float(y), float(yaw))


def program_side(rec) -> dict:
    """The program's decisions kept by the run (`rec["closures"]`, the
    capture's record), moved to the host; the record lets go of it."""
    cap, rec["closures"] = rec["closures"], None
    searches = []
    for s in cap["searches"]:
        out = s.get("out")
        if out is None:
            continue
        d = dict(kind=s["kind"], inputs=s["inputs"], found=bool(out[0]),
                 tf=None if out[1] is None else np.asarray(out[1],
                                                           np.float64))
        if s["kind"] == "slidegraph":
            d.update(searched=s["votes"] is not None,
                     votes=s["votes"], inliers=s["inliers"])
        else:
            d["searched"] = bool(s["kernels"])
            if s["kernels"]:
                n_qry = len(s["inputs"]["measurements"]
                            if s["kind"] == "slidematch_intra"
                            else s["inputs"]["query_map"])
                d["n_grid"], d["pairs"], d["xyyaw"] = _kernel_side(
                    s["kernels"][-1], n_qry)
                t = s["transform"]
                d.update(n_inliers=t["n_inliers"], fit_n=t["fit"][0],
                         search_found=t["found"])
        searches.append(d)
    return dict(searches=searches, merges=list(cap["merges"]),
                refines=[dict(r, tf_out=slidematch.pose_matrix(r["tf_out"]))
                         for r in cap["refines"]])


def _reference_slidematch(s: dict, c: dict, rnd):
    pr, grid = c["place_recognition"], c["grid"]
    i = s["inputs"]
    if s["kind"] == "slidematch_intra":
        return slidematch.intra_closure(i["measurements"], i["submap"],
                                        i["query_pose"], i["candidate_pose"],
                                        pr, grid, rnd)
    return slidematch.inter_closure(i["reference_map"], i["query_map"], pr,
                                    grid, rnd)


def _reference_slidegraph(s: dict, c: dict, rnd):
    i = s["inputs"]
    return slidegraph.inter_closure(i["reference_map"], i["query_map"],
                                    c["slidegraph"], c["clipper"],
                                    c["max_associations"], i["seed"], rnd)


def polish(r: dict, c: dict, rnd=exact) -> np.ndarray:
    """A merge polish worked out again: the found transform, re-matched
    and re-fitted on both whole maps, kept where enough pairs support it."""
    m = c["merge"]
    tf = slidematch.pose_matrix(r["tf_in"])
    tf[:3, 3] = rnd(tf[:3, 3])
    own = np.asarray(r["own"], np.float64).reshape(-1, 7)
    peer = np.asarray(r["peer_map"], np.float64).reshape(-1, 7)
    if len(own) < m["polish_min_objects"] or \
            len(peer) < m["polish_min_objects"]:
        return tf
    own, peer = own.copy(), peer.copy()
    own[:, 1:4], peer[:, 1:4] = rnd(own[:, 1:4]), rnd(peer[:, 1:4])
    out, n, _, _ = slidematch.icp_refine(tf, own, peer,
                                         c["place_recognition"],
                                         m["polish_iters"])
    return out if n >= m["polish_min_pairs"] else tf


def _by_node(calls):
    """A run's merge calls, each node instance's in their order."""
    out = {}
    for m in calls:
        out.setdefault(m["instance"], []).append(m)
    return list(out.values())


def control_side(cfg, work, traffic, program: dict, rnd) -> dict:
    """The reference in the program's place, its object positions (and
    the transforms a node confirms) rounded by `rnd`, in the program's
    form."""
    c = cfg["closures"]
    searches = []
    for s in program["searches"]:
        d = dict(kind=s["kind"], inputs=s["inputs"])
        if s["kind"] == "slidegraph":
            r = _reference_slidegraph(s, c, rnd)
            d.update(searched=r.searched, found=r.found, tf=r.tf,
                     votes=r.pairs if r.searched else None,
                     inliers=None if r.clique is None else r.clique.inliers)
        else:
            found, tf, r = _reference_slidematch(s, c, rnd)
            d.update(searched=r is not None, found=found, tf=tf)
            if r is not None:
                d.update(n_grid=r.n_grid, pairs=r.pairs, xyyaw=r.xyyaw,
                         n_inliers=r.n_inliers, fit_n=r.fit[0],
                         search_found=r.found)
        searches.append(d)
    mrg = []
    for calls in _by_node(program["merges"]):
        got, _ = merges.accepted_merges(calls, c["merge"], rnd)
        mrg += [dict(m, accepted=a) for m, a in zip(calls, got)]
    refines = [dict(r, tf_out=polish(r, c, rnd)) for r in program["refines"]]
    return dict(searches=searches, merges=mrg, refines=refines)


def tf_gap(a: np.ndarray, b: np.ndarray):
    """(translation gap, angle of the rotation between a and b)."""
    D = a[:3, :3].T @ b[:3, :3]
    s = np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                        D[1, 0] - D[0, 1]]) / 2
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.arctan2(s, (np.trace(D) - 1) / 2)))


def _slidematch_verdict(d: dict, r, thresh: float):
    """(agrees, left out) of one SlideMatch decision against the search
    `r` (None: not searched); `thresh` is the match threshold."""
    if r is None or not d["searched"]:
        return (r is None) == (not d["searched"]) and not d["found"], False
    ref, qry, ok = r.frame
    x, y, yaw = d["xyyaw"]
    dist = slidematch.distances_at(ref, qry, ok, x, y, yaw)
    edge = np.abs(dist[np.isfinite(dist)] - thresh).min(initial=np.inf)
    if (r.n_grid <= r.runner_up or edge < AMBIGUOUS_M
            or r.icp_edge < AMBIGUOUS_M):
        return None, True
    same = (d["n_grid"] == r.n_grid and d["pairs"] == r.pairs
            and d["search_found"] == r.found)
    if r.found:
        same = same and (d["n_inliers"], d["fit_n"]) == (r.n_inliers,
                                                          r.fit[0])
    return same, False


def _slidegraph_verdict(d: dict, r):
    if not r.searched or d["votes"] is None:
        return r.searched == (d["votes"] is not None) and not d["found"], \
            False
    if r.vote_edge < AMBIGUOUS_DESC or (r.clique is not None and (
            r.clique.f_edge < AMBIGUOUS_F or r.clique.u_edge < AMBIGUOUS_U)):
        return None, True
    votes = np.asarray(d["votes"]).reshape(-1, 2)
    if votes.shape != r.pairs.shape or not np.array_equal(votes, r.pairs):
        return False, False
    got = set() if d["inliers"] is None else {
        tuple(votes[i]) for i in np.asarray(d["inliers"]).tolist()}
    want = set() if r.clique is None else {
        tuple(r.pairs[i]) for i in r.clique.inliers.tolist()}
    return got == want, False


def readings(cfg, work, traffic, side: dict, device=None) -> dict:
    """Each compared number of `side` against the exact reference, and
    uncompared counts (keys starting with `_`)."""
    t0 = time.perf_counter()
    c = cfg["closures"]
    thresh = c["place_recognition"]["match_threshold_position"]
    mismatch, gap_m, gap_rad = 0, 0.0, 0.0
    counts = {}
    for d in side["searches"]:
        kind = d["kind"]
        n = counts.setdefault(kind, [0, 0, 0])     # decided, agree, left out
        if kind == "slidegraph":
            r = _reference_slidegraph(d, c, exact)
            same, left = _slidegraph_verdict(d, r)
            rtf = r.tf
        else:
            _, rtf, r = _reference_slidematch(d, c, exact)
            same, left = _slidematch_verdict(d, r, thresh)
        if left:
            n[2] += 1
            continue
        n[0] += 1
        # the entry point's own gates after the search (a re-fit without
        # pairs) decide what it returns
        if not same or d["found"] != (rtf is not None):
            mismatch += 1
            continue
        n[1] += 1
        if rtf is not None:
            g, a = tf_gap(np.asarray(d["tf"], np.float64), rtf)
            gap_m, gap_rad = max(gap_m, g), max(gap_rad, a)
    for r in side["refines"]:
        g, a = tf_gap(np.asarray(r["tf_out"], np.float64), polish(r, c))
        gap_m, gap_rad = max(gap_m, g), max(gap_rad, a)
    merge_bad, merge_left, merge_calls, accepted = 0, 0, 0, 0
    for calls in _by_node(side["merges"]):
        want, edge = merges.accepted_merges(calls, c["merge"])
        if edge < AMBIGUOUS_M:
            merge_left += len(calls)
            continue
        for m, w in zip(calls, want):
            merge_calls += 1
            accepted += len(w)
            merge_bad += len(set(m["accepted"]) ^ set(w))
    out = dict(decision_mismatch=mismatch, closure_tf_gap_m=gap_m,
               closure_yaw_gap_rad=gap_rad, merge_mismatch=merge_bad)
    for kind, (dec, agree, left) in counts.items():
        out[f"_{kind}_decided"] = dec
        out[f"_{kind}_agree"] = agree
        out[f"_{kind}_left_out"] = left
    out.update(_polishes=len(side["refines"]), _merge_calls=merge_calls,
               _merges_accepted=accepted, _merge_calls_left_out=merge_left,
               _judge_s=time.perf_counter() - t0)
    return out

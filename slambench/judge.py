"""Whether the timed path's outputs are correct: each stage of what the
window produced, held against the plain reference (slambench/reference).

A run keeps, on keyframes drawn from the seed, what the program made
(see drivers/solo.py). Stage by stage, the reference works out again
from the traffic's inputs and from the stage before's output what that
stage should give, and the gap is read:

* input_gap_m: the points each DBSCAN launch clustered, against the
  scan's class points in range through the odometry pose (f64; a point
  within 1 mm of the range cut may lie on either side of it); a set of
  other points reads 1e9, and so do the two numbers after it;
* label_mismatch: points whose DBSCAN label differs from the reference's
  two-layer DBSCAN on the points the launch clustered;
* cylinder_gap_m: the largest gap (root, axis, radius) between the
  frontend's body-frame cylinder measurements and the reference's fits of
  the clusters the launch found, from the reference's f64 points; another
  number of measurements reads 1e9;
* match_mismatch: association decisions that differ from the reference's
  on the map, pose and measurements the step took (decisions whose best
  distance lies within `ambiguous_m` of the threshold or of the runner-up
  are left out and counted apart);
* solve_cost_excess: how far the first mission's last full solve stops
  above the f64 Levenberg-Marquardt optimum of the factors it was given, as
  (cost(solved) - cost(optimum)) / cost(optimum), in the whitened cost of
  those factors (the RMS distance of its poses to the optimum's is
  reported beside it, uncompared: the forest graph is flat along some
  directions, and f32 solves wander along them without cost). The factors
  are first held to the traffic: a graph that holds another number of
  poses than the keyframes its mission had integrated, an odometry factor
  that is not the relative motion of the two odometry poses handed over,
  or, on the keyframes whose inputs are known (every keyframe's
  measurements in a measurement stream; the judged scans' frontend
  measurements in a scan stream), a set of cylinder factors that is not
  the keyframe's measurements, reads 1e9.

`side` is what is judged: the program's outputs, or the control, the
reference put in its place at a lower precision, each stage fed the
control's own output of the stage before.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import association, cylinders, lm
from .reference.precision import exact

BAD = 1e9


def program_side(rec) -> dict:
    """The program's outputs kept by the solo loop, moved to the host. The
    record lets go of the tensors it kept for the per-layer readers and of
    its capture, so that the reference runs with them freed."""
    rec["profiled_dbscan"] = []
    capture, rec["capture"] = rec["capture"], None
    scans = []
    for s in capture["scans"]:
        if "dbscan" not in s or "obs" not in s:
            continue
        pts, valid, params, labels = s["dbscan"]
        sets = []
        for c in range(pts.shape[0]):
            v = valid[c].cpu().numpy()
            sets.append(dict(points=pts[c].cpu().numpy()[v],
                             labels=labels[c].cpu().numpy()[v]))
        scans.append(dict(kf=s["kf"], sets=sets, obs=s["obs"]))
    steps = []
    for s in capture["steps"]:
        n = int(s["cyl_count"])
        packed = s["packed"].cpu().numpy()
        ok = packed[:, 8] > 0.5
        steps.append(dict(
            kf=s["kf"], first=int(s["pose_count"]) == 0,
            prev_pose=s["prev_pose"].cpu().numpy(),
            landmarks=dict(root=s["root"][:n].cpu().numpy(),
                           ray=s["ray"][:n].cpu().numpy(),
                           label=s["label"][:n].cpu().numpy()),
            meas=dict(cyl_root=packed[ok, 0:3], cyl_ray=packed[ok, 3:6],
                      cyl_label=packed[ok, 7].astype(np.int64)),
            matches=s["matches"].cpu().numpy()[ok]))
    solve = capture["solve"]
    if solve is not None:
        solve = dict(solve, obs={s["kf"]: s["obs"] for s in scans})
    return dict(scans=scans, steps=steps, solve=solve)


FACTOR_TOL = 1e-3


def factor_gap(p: "lm.Problem", traffic, obs: dict) -> float:
    """The largest gap between the graph's factors and the traffic: each
    odometry factor against the relative motion of the odometry poses
    handed over (f64), and on each keyframe of `obs` (keyframe -> its
    measurement dict; every keyframe of a measurement stream) each
    cylinder factor [ray, root, radius] against the nearest measurement.
    Another number of factors than of measurements reads BAD."""
    odom = np.asarray(traffic.odom, np.float64)
    n = len(p.poses)
    gap = 0.0
    if len(p.od_j):
        rel = lm._compose(lm._inverse(odom[p.od_i]), odom[p.od_j])
        got = p.od_rel
        sign = np.where((got[:, :4] * rel[:, :4]).sum(1) < 0, -1.0, 1.0)
        gap = max(gap, float(np.abs(got[:, :4] * sign[:, None]
                                    - rel[:, :4]).max()),
                  float(np.abs(got[:, 4:] - rel[:, 4:]).max()))
    for k, o in obs.items():
        if k >= n:
            continue
        f = p.cf_meas[p.cf_pose == k]
        m = np.concatenate(
            [np.asarray(o[key], np.float64).reshape(-1, w)
             for key, w in (("cyl_ray", 3), ("cyl_root", 3),
                            ("cyl_radius", 1))], axis=1)
        if len(f) != len(m):
            return BAD
        for row in f:
            gap = max(gap, float(np.abs(m - row).max(axis=1).min()))
    return gap


def control_side(cfg, work, traffic, program: dict, rnd, device) -> dict:
    """The reference in the program's place, rounding with `rnd`: its
    DBSCAN on its own points, its fits on its own clusters, its decisions
    on the program's map and measurements (the state the reference
    follows), and its solve from the program's last full solve's input,
    its poses and landmarks held at the lower precision."""
    scans = []
    for s in program["scans"]:
        k = s["kf"]
        scan = traffic.scans[k]
        world = rnd(cylinders.world_points(scan.points, traffic.odom[k]))
        pts32 = {}
        for spec in cfg["classes"]["cylinders"]:
            idx = cylinders.class_points(world, scan.labels, traffic.odom[k],
                                         cfg["pipeline"], spec["label"])
            pts32[spec["label"]] = world[idx].astype(np.float32)
        lab = cylinders.cluster_scan(world, scan.labels, traffic.odom[k],
                                     cfg["pipeline"], cfg["classes"], device, rnd,
                                     points32=pts32)
        sets = [dict(points=pts32[c], labels=lab[c]) for c in lab]
        obs = cylinders.measurements(world, scan.labels, traffic.odom[k], lab,
                                     cfg["pipeline"], cfg["classes"], device, rnd)
        scans.append(dict(kf=k, sets=sets, obs=obs))
    steps = []
    slam = cfg["slam"]["association"]
    for s in program["steps"]:
        k = s["kf"]
        m, _, _ = association.associate(
            None if s["first"] else s["prev_pose"],
            traffic.odom[k - 1] if k else None, traffic.odom[k], s["meas"],
            s["landmarks"], slam["submap_k"], slam["match_thresh_m"], rnd)
        steps.append(dict(s, matches=m))
    solve = None
    if program["solve"] is not None:
        noise = cfg["slam"]["noise"]
        conv, info = lm.solve_reference(
            program["solve"]["state_in"], cyl_sigma=noise["cylinder"],
            bearing_sigma=noise["bearing"])
        p = lm.extract_problem(program["solve"]["state_in"],
                               noise["cylinder"], noise["bearing"])
        solve = dict(state_in=program["solve"]["state_in"],
                     kf=program["solve"]["kf"], obs=program["solve"]["obs"],
                     problem_out=lm.Problem(**{
                         **p.__dict__, "poses": rnd(conv[p.pose_slot]),
                         "cyl": rnd(info["landmarks"]["cyl"]),
                         "cub_pose": info["landmarks"]["cub_pose"],
                         "cub_scale": info["landmarks"]["cub_scale"],
                         "pt": info["landmarks"]["pt"]}))
    return dict(scans=scans, steps=steps, solve=solve)


def readings(cfg, work, traffic, side: dict, device) -> dict:
    """Each compared number of `side` against the exact reference."""
    pipe, classes = cfg["pipeline"], cfg["classes"]
    out = {}
    in_gap, mismatch, cyl_gap = 0.0, 0, 0.0
    for s in side["scans"]:
        k = s["kf"]
        scan = traffic.scans[k]
        world = cylinders.world_points(scan.points, traffic.odom[k])
        cands = {}
        for spec in classes["cylinders"]:
            idx, sure = cylinders.class_candidates(
                world, scan.labels, traffic.odom[k], pipe, spec["label"])
            if len(idx) >= spec["min_samples_cluster"]:
                cands[spec["label"]] = (idx, sure)
        pairs = list(zip(s["sets"], cands.items()))
        idx_of = {}
        for got, (lab, (idx, sure)) in pairs:
            keep, gap = cylinders.align(got["points"], world, idx, sure)
            if keep is not None:
                idx_of[lab] = keep
                in_gap = max(in_gap, gap)
        if len(s["sets"]) != len(cands) or len(idx_of) != len(pairs):
            # another set of points than the scan's: nothing after it
            # can be compared
            in_gap, cyl_gap = BAD, BAD
            mismatch = max(mismatch, int(BAD))
            continue
        ref_lab = cylinders.cluster_scan(
            world, scan.labels, traffic.odom[k], pipe, classes, device,
            exact, points32={lab: got["points"] for got, (lab, _) in pairs},
            idx_of=idx_of)
        for got, (lab, _) in pairs:
            mismatch += int((np.asarray(got["labels"]) != ref_lab[lab]).sum())
        side_lab = {lab: np.asarray(got["labels"])
                    for got, (lab, _) in pairs}
        ref_obs = cylinders.measurements(world, scan.labels, traffic.odom[k],
                                         side_lab, pipe, classes, device,
                                         idx_of=idx_of)
        got = s["obs"]
        n = len(got.get("cyl_radius", []))
        if n != len(ref_obs["cyl_radius"]) or (n and not np.array_equal(
                np.asarray(got["cyl_label"]), ref_obs["cyl_label"])):
            cyl_gap = BAD
            continue
        if n:
            cyl_gap = max(cyl_gap, float(max(
                np.abs(np.asarray(got["cyl_root"], np.float64)
                       - ref_obs["cyl_root"]).max(),
                np.abs(np.asarray(got["cyl_ray"], np.float64)
                       - ref_obs["cyl_ray"]).max(),
                np.abs(np.asarray(got["cyl_radius"], np.float64)
                       - ref_obs["cyl_radius"]).max())))
    if side["scans"]:
        out.update(input_gap_m=in_gap, label_mismatch=mismatch,
                   cylinder_gap_m=cyl_gap)
    assoc = cfg["slam"]["association"]
    amb = work["judge"]["ambiguous_m"]
    bad, left_out, decided = 0, 0, 0
    for s in side["steps"]:
        k = s["kf"]
        m, best, second = association.associate(
            None if s["first"] else s["prev_pose"],
            traffic.odom[k - 1] if k else None, traffic.odom[k], s["meas"],
            s["landmarks"], assoc["submap_k"], assoc["match_thresh_m"])
        clear = ((np.abs(best - assoc["match_thresh_m"]) >= amb)
                 & (second - best >= amb))
        got = np.asarray(s["matches"])
        if len(got) != len(m):
            bad += int(BAD)
            continue
        bad += int((got[clear] != m[clear]).sum())
        left_out += int((~clear).sum())
        decided += int(clear.sum())
    out.update(match_mismatch=bad if side["steps"] else None)
    out["_matches_decided"] = decided
    out["_matches_left_out"] = left_out
    if side["solve"] is not None:
        noise = cfg["slam"]["noise"]
        sv = side["solve"]
        conv, info = lm.solve_reference(sv["state_in"],
                                        cyl_sigma=noise["cylinder"],
                                        bearing_sigma=noise["bearing"])
        got = (sv["problem_out"] if "problem_out" in sv else
               lm.extract_problem(sv["state_out"], noise["cylinder"],
                                  noise["bearing"]))
        c_opt = info["final_cost"]
        out["solve_cost_excess"] = float((lm.cost(got) - c_opt)
                                         / max(c_opt, 1e-300))
        given = lm.extract_problem(sv["state_in"], noise["cylinder"],
                                   noise["bearing"])
        obs = sv["obs"] if traffic.obs is None else dict(
            enumerate(traffic.obs))
        out["_factor_gap"] = factor_gap(given, traffic, obs)
        # what a full solve that returned its input would read
        out["_solve_in_excess"] = float((lm.cost(given) - c_opt)
                                        / max(c_opt, 1e-300))
        if len(got.poses) != sv["kf"] + 1 or \
                out["_factor_gap"] > FACTOR_TOL:
            # the graph must hold every keyframe its mission integrated,
            # with the factors the traffic gave
            out["solve_cost_excess"] = BAD
        gap = np.linalg.norm(got.poses[:, 4:7] - conv[got.pose_slot, 4:7],
                             axis=1)
        out["_solve_gap_m"] = float(np.sqrt(np.mean(gap ** 2)))
        out["_solve_poses"] = len(got.poses)
        out["_lm_iters"] = info["iters"]
    return out

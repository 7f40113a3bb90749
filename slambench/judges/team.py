"""Whether a team run is correct: its closure and merge decisions held to
the plain reference, and its maps held to the traffic.

* decision_mismatch, merge_mismatch, closure_tf_gap_m,
  closure_yaw_gap_rad: judges/team_decisions.py's numbers, unchanged,
  over every decision the run captured, set-up's included.
* match_mismatch: the association decisions of the keyframes drawn from
  the seed that differ from reference/association.py's on the map, pose
  and measurements the step took; decisions within `ambiguous_m` of the
  threshold or of the runner-up are left out and counted apart. Two
  keyframes a robot (by each node's own count) of the resumed episode,
  after its merges (their submaps hold the peers' landmarks), and two of
  the first new episode where the window reaches it. A window that ends
  before every keyframe of the resumed episode drawn leaves the number
  out, and the run is not correct.
* solve_cost_excess: over each robot's first periodic full solve after
  the resume stamp, in the window, the largest
  (cost(solved) - cost(optimum)) / cost(optimum), the optimum the f64
  Levenberg-Marquardt of reference/lm.py on the same factors. That graph
  holds the robot's own chain, its peers' chains and the relative factors.
  First it is held to the traffic, and where it is not it reads BAD:
  - the node's keyframes are its robot's keyframes of the traffic
    (traffic/team.py `sequence`), stamp by stamp, and each chain holds one
    pose a keyframe of its robot;
  - each odometry factor, own or peer, is the relative motion of the two
    odometry poses the traffic handed that robot's node;
  - each pose's cylinder, cuboid and point factors are that keyframe's
    measurements in the robot's log, one each, as many as the node takes
    (the first `max_scan_objects` of a class), fewer only where the own
    step ran in a loop-closure region, which adds no landmark;
  - a between factor across two chains is a seeded sighting (both poses
    at its stamp, its relative pose); one within a chain is an intra
    closure whose SlideMatch transform the decision judge judged; every
    sighting of the node's robot older than SIGHTING_MARGIN_S whose peer
    keyframe the node folded FOLD_MARGIN_S of sim time before the solve
    has its factor;
  - every fold of a peer's keyframes before the solve used a transform
    that the judged merges give (a merge the node accepted, as polished,
    or its inverse or a composition of two, as the nodes' exchange passes
    them on), each folded pose that transform applied to the peer's key
    pose, and the peer's relative odometry the traffic's.
  A window that ends before a robot's solve leaves the number out, and the
  run is not correct.

The limits and the readings behind them: PERF.md section 2.
"""
from __future__ import annotations

import numpy as np

from ..reference import association, lm
from ..reference.precision import exact
from ..reference.slidematch import pose_matrix
from . import team_decisions

BAD = 1e9
# largest gap of a factor or a folded pose to the traffic (f32 copies of
# f32 inputs, and f32 compositions at 40-60 m: a few ulps of 4-8 um)
FACTOR_TOL = 1e-3
STAMP_TOL = 1e-3
# When a sighting's factor is due, in sim seconds before the solve. The
# input manager holds a sighting for its msg_delay_tolerance (3 s) and the
# node matches the ones it has released once a second
# (rel_inter_robot_factor_frequency): 4 s. A sighting's peer keyframe
# must be folded too, and is matched at one of the next two of those
# rounds after its fold (the rounds are staggered by robot): 2 s.
SIGHTING_MARGIN_S = 4.0
FOLD_MARGIN_S = 2.0
IDENTITY = np.array([1.0, 0, 0, 0, 0, 0, 0])


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _counts(cap: dict, marks: dict) -> dict:
    """Searches by kind, merge calls, merges accepted and polishes, in
    set-up and in the window (uncompared)."""
    out = {}
    for part, sl in (("setup", lambda k: cap[k][:marks.get(k, 0)]),
                     ("window", lambda k: cap[k][marks.get(k, 0):])):
        for s in sl("searches"):
            k = f"_{part}_{s['kind']}_searches"
            out[k] = out.get(k, 0) + 1
        out[f"_{part}_merge_calls"] = len(sl("merges"))
        out[f"_{part}_merges_accepted"] = sum(len(m["accepted"])
                                              for m in sl("merges"))
        out[f"_{part}_polishes"] = len(sl("refines"))
    return out


def program_side(rec) -> dict:
    """What the run kept, moved to the host; the record lets go of it."""
    keep = rec["map"]
    counts = _counts(rec["closures"], keep.get("setup_marks", {}))
    # the window's keyframes: the resumed episode's, then the new ones'
    window = keep.get("window_kf") or [0]
    counts.update(_window_kf_resumed=window[0],
                  _window_kf_new=sum(window[1:]),
                  _window_new_episodes=len(window) - 1)
    decisions = team_decisions.program_side(rec)
    rec["map"] = None
    steps = []
    for s in keep["steps"]:
        n = int(s["cyl_count"])
        packed = _host(s["packed"])
        ok = packed[:, 8] > 0.5
        steps.append(dict(
            robot=s["robot"], kf=s["kf"], episode=s["episode"],
            first=int(s["pose_count"]) == 0,
            prev_pose=_host(s["prev_pose"]),
            landmarks=dict(root=_host(s["root"])[:n],
                           ray=_host(s["ray"])[:n],
                           label=_host(s["label"])[:n]),
            meas=dict(cyl_root=packed[ok, 0:3], cyl_ray=packed[ok, 3:6],
                      cyl_label=packed[ok, 7].astype(np.int64)),
            matches=_host(s["matches"])[ok]))
    folds = []
    for f in keep["folds"]:
        peers = []
        for p in f["peers"]:
            rows = (np.concatenate([_host(r) for r in p["rows"]])
                    if p["rows"] else np.zeros((0, 2, 7), np.float32))
            peers.append(dict(p, rows=rows))
        folds.append(dict(f, peers=peers))
    solves = [dict(s, state_in=lm.host_state(s["state_in"]),
                   state_out=lm.host_state(s["state_out"]))
              for s in keep["solves"]]
    return dict(decisions=decisions, steps=steps, folds=folds,
                solves=solves, drops=dict(keep["drops"]),
                sampled=dict(keep["sampled"]),
                refines_first=keep.get("refines_first"), counts=counts)


def _between(a, b):
    return lm._compose(lm._inverse(np.asarray(a, np.float64)),
                       np.asarray(b, np.float64))


def _pose_gap(got, want) -> float:
    """Largest element gap of two poses (the quaternion up to sign)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sign = -1.0 if float(got[:4] @ want[:4]) < 0 else 1.0
    return max(float(np.abs(got[:4] * sign - want[:4]).max()),
               float(np.abs(got[4:] - want[4:]).max()))


def _mat_gap(a7, b) -> float:
    g, r = team_decisions.tf_gap(pose_matrix(a7), b)
    return max(g, r)


def _judged(side: dict) -> dict:
    """The decisions the graph was built from: the program's (a control
    puts its own decisions beside them, and the program's graph)."""
    return side.get("judged", side["decisions"])


def judged_transforms(side: dict):
    """{(node, peer): [4x4, ...]}: the merges the first episode's nodes
    accepted, as polished (the judged ones), their inverses, and each
    composition of two of these through a third robot."""
    refs = _judged(side)["refines"][:side["refines_first"]]
    tf = {}
    for r in refs:
        m = np.asarray(r["tf_out"], np.float64)
        tf.setdefault((r["node"], r["peer"]), []).append(m)
        tf.setdefault((r["peer"], r["node"]), []).append(np.linalg.inv(m))
    out = {k: list(v) for k, v in tf.items()}
    for (a, b), ab in tf.items():
        for (c, d), cd in tf.items():
            if c == b and d != a:
                out.setdefault((a, d), []).extend(x @ y for x in ab
                                                  for y in cd)
    return out


def _family_rows(obs, family):
    """A keyframe's measurement rows of a factor family, in the factor's
    layout."""
    f64 = lambda k, w: np.asarray(obs.get(k, np.zeros((0, w))),
                                  np.float64).reshape(-1, w)
    if family == "cf":
        return np.concatenate([f64("cyl_ray", 3), f64("cyl_root", 3),
                               f64("cyl_radius", 1)], axis=1)
    if family == "kf":
        return np.concatenate([f64("cub_pose", 7), f64("cub_scale", 3)],
                              axis=1)
    p = f64("ell_pose", 7)[:, 4:7]
    rng = np.linalg.norm(p, axis=1, keepdims=True)
    return np.concatenate([p / np.maximum(rng, 1e-9), rng], axis=1)


def _factor_rows(p: "lm.Problem", family):
    if family == "cf":
        return p.cf_pose, p.cf_meas
    if family == "kf":
        return p.kf_pose, np.concatenate([p.kf_meas_pose, p.kf_meas_scale],
                                         axis=1)
    return p.uf_pose, np.concatenate([p.uf_bearing, p.uf_range[:, None]],
                                     axis=1)


def factor_gap(solve: dict, side: dict, traffic, work, cfg) -> tuple:
    """(largest gap of the judged graph's factors and folds to the
    traffic, counts): BAD where a factor or a fold has no counterpart."""
    robot, hs = solve["robot"], solve["state_in"]
    p = lm.extract_problem(hs, cfg["slam"]["noise"]["cylinder"],
                           cfg["slam"]["noise"]["bearing"])
    R = len(hs.pose_count)
    P = hs.poses.shape[0] // R
    S = cfg["slam"]["association"]["max_scan_objects"]
    seq = {r: traffic.sequence(r) for r in range(R)}
    counts = {f"_chain{r}": int(hs.pose_count[r]) for r in range(R)}
    counts["_overflow"] = int(np.asarray(hs.overflow).sum())
    own = seq[robot]
    n_own = int(hs.pose_count[robot])
    stamps = solve["stamps"]
    if n_own != len(stamps) or n_own > len(own) or any(
            abs(a - b.stamp) > STAMP_TOL for a, b in zip(stamps, own)):
        return BAD, counts
    for r in range(R):
        if int(hs.pose_count[r]) > len(seq[r]):
            return BAD, counts
    gap = 0.0
    # odometry factors, own and peer chains
    for a, (i, j) in enumerate(zip(p.od_i, p.od_j)):
        r, k = divmod(int(p.pose_slot[j]), P)
        want = _between(seq[r][k - 1].odom, seq[r][k].odom)
        gap = max(gap, _pose_gap(p.od_rel[a], want))
    # measurement factors, pose by pose
    for family in ("cf", "kf", "uf"):
        at, rows = _factor_rows(p, family)
        for a, slot in enumerate(p.pose_slot):
            r, k = divmod(int(slot), P)
            got = rows[at == a]
            obs = seq[r][k].obs
            want = (np.zeros((0, got.shape[1])) if obs is None
                    else _family_rows(obs, family)[:S])
            dropped = r == robot and side["drops"].get((r, k), False)
            if len(got) > len(want) or (len(got) < len(want)
                                        and not dropped):
                return BAD, counts
            for row in got:
                gap = max(gap, float(np.abs(want - row).max(axis=1).min()))
    # between factors
    intra = [np.asarray(s["tf"], np.float64)
             for s in _judged(side)["searches"]
             if s["kind"] == "slidematch_intra" and s["found"]]
    sights = [s for o, s in traffic.sightings if o == robot]
    n_rel = 0
    for a in range(len(p.bf_i)):
        (ra, ia), (rb, ib) = (divmod(int(p.pose_slot[x]), P)
                              for x in (p.bf_i[a], p.bf_j[a]))
        if ra == rb:
            g = min((_mat_gap(p.bf_rel[a], m) for m in intra), default=BAD)
        else:
            n_rel += 1
            g = min((_pose_gap(p.bf_rel[a], s.relative_pose) for s in sights
                     if ra == robot and s.robot_index == rb
                     and abs(seq[ra][ia].stamp - s.stamp) <= STAMP_TOL
                     and abs(seq[rb][ib].stamp - s.stamp) <= STAMP_TOL),
                    default=BAD)
        gap = max(gap, g)
    # every sighting old enough, whose peer keyframe was folded early
    # enough, has its factor
    folds = [f for f in side["folds"][:solve["folds"]] if f["robot"] == robot]
    due = 0
    for s in sights:
        cover = [f["at"] for f in folds for x in f["peers"]
                 if x["peer"] == s.robot_index and len(x["stamps"])
                 and x["stamps"][-1] >= s.stamp]
        if cover and min(cover) <= stamps[-1] - FOLD_MARGIN_S and \
                s.stamp <= stamps[-1] - SIGHTING_MARGIN_S:
            due += 1
    counts.update(_rel_factors=n_rel, _rel_due=due, _folds=len(folds))
    if n_rel < due:
        return BAD, counts
    # the folds that built the peer chains
    judged = judged_transforms(side)
    for f in folds:
        for x in f["peers"]:
            q, tf = x["peer"], x["tf"]
            g = min((_mat_gap(tf, m) for m in judged.get((robot, q), [])),
                    default=BAD)
            rows = x["rows"]
            if len(rows) != len(x["stamps"]):
                return BAD, counts
            for i, (st, kp, ro, row) in enumerate(zip(
                    x["stamps"], x["key_pose"], x["rel_odom"], rows)):
                k = x["first"] + i
                if k >= len(seq[q]) or abs(seq[q][k].stamp - st) > STAMP_TOL:
                    return BAD, counts
                want = (IDENTITY if k == 0 else
                        _between(seq[q][k - 1].odom, seq[q][k].odom))
                g = max(g, _pose_gap(ro, want), _pose_gap(row[1], ro),
                        _pose_gap(row[0], lm._compose(tf, kp)))
            gap = max(gap, g)
    return gap, counts


def _solve_readings(solve, side, traffic, work, cfg, problem_out=None):
    noise = cfg["slam"]["noise"]
    conv, info = lm.solve_reference(solve["state_in"],
                                    cyl_sigma=noise["cylinder"],
                                    bearing_sigma=noise["bearing"])
    given = lm.extract_problem(solve["state_in"], noise["cylinder"],
                               noise["bearing"])
    got = problem_out if problem_out is not None else lm.extract_problem(
        solve["state_out"], noise["cylinder"], noise["bearing"])
    c_opt = max(info["final_cost"], 1e-300)
    fgap, counts = factor_gap(solve, side, traffic, work, cfg)
    out = dict(counts, excess=float((lm.cost(got) - info["final_cost"])
                                    / c_opt),
               in_excess=float((lm.cost(given) - info["final_cost"]) / c_opt),
               factor_gap=fgap, poses=len(got.poses), lm_iters=info["iters"],
               gap_m=float(np.sqrt(np.mean(np.linalg.norm(
                   got.poses[:, 4:7] - conv[got.pose_slot, 4:7],
                   axis=1) ** 2))))
    if fgap > FACTOR_TOL:
        out["excess"] = BAD
    return out, conv, info


def control_side(cfg, work, traffic, program: dict, rnd, rnd_decisions):
    """The reference in the program's place: its decisions with positions
    rounded by `rnd_decisions` (team_decisions.control_side), its
    associations and its solves' optima rounded by `rnd`."""
    side = dict(program, judged=program["decisions"],
                decisions=team_decisions.control_side(
                    cfg, work, traffic, program["decisions"], rnd_decisions))
    a = cfg["slam"]["association"]
    steps = []
    for s in program["steps"]:
        seq = traffic.sequence(s["robot"])
        k = s["kf"]
        m, _, _ = association.associate(
            None if s["first"] else s["prev_pose"],
            seq[k - 1].odom if k else None, seq[k].odom, s["meas"],
            s["landmarks"], a["submap_k"], a["match_thresh_m"], rnd)
        steps.append(dict(s, matches=m))
    side["steps"] = steps
    noise = cfg["slam"]["noise"]
    solves = []
    for s in program["solves"]:
        conv, info = lm.solve_reference(s["state_in"],
                                        cyl_sigma=noise["cylinder"],
                                        bearing_sigma=noise["bearing"])
        p = lm.extract_problem(s["state_in"], noise["cylinder"],
                               noise["bearing"])
        solves.append(dict(s, problem_out=lm.Problem(**{
            **p.__dict__, "poses": rnd(conv[p.pose_slot]),
            "cyl": rnd(info["landmarks"]["cyl"]),
            "cub_pose": rnd(info["landmarks"]["cub_pose"]),
            "cub_scale": rnd(info["landmarks"]["cub_scale"]),
            "pt": rnd(info["landmarks"]["pt"])})))
    side["solves"] = solves
    return side


def readings(cfg, work, traffic, side: dict, device=None) -> dict:
    """Each compared number of `side` against the exact reference, and
    uncompared counts (keys starting with `_`)."""
    out = team_decisions.readings(cfg, work, traffic, side["decisions"],
                                  device)
    out.update(side.get("counts", {}))
    a = cfg["slam"]["association"]
    amb = work["judge"]["ambiguous_m"]
    bad, left, decided = 0, 0, 0
    for s in side["steps"]:
        seq = traffic.sequence(s["robot"])
        k = s["kf"]
        m, best, second = association.associate(
            None if s["first"] else s["prev_pose"],
            seq[k - 1].odom if k else None, seq[k].odom, s["meas"],
            s["landmarks"], a["submap_k"], a["match_thresh_m"], exact)
        clear = ((np.abs(best - a["match_thresh_m"]) >= amb)
                 & (second - best >= amb))
        got = np.asarray(s["matches"])
        if len(got) != len(m):
            bad += int(BAD)
            continue
        bad += int((got[clear] != m[clear]).sum())
        left += int((~clear).sum())
        decided += int(clear.sum())
    resumed = sum(s["episode"] == 0 for s in side["steps"])
    out["match_mismatch"] = (bad if resumed == side["sampled"][0]
                             else None)
    out.update(_matches_decided=decided, _matches_left_out=left,
               _matched_keyframes=resumed,
               _matched_keyframes_new_episode=len(side["steps"]) - resumed)
    robots = cfg["slam"]["number_of_robots"]
    solved = {s["robot"]: s for s in side["solves"]}
    excess = []
    for r in sorted(solved):
        s = solved[r]
        vals, _, _ = _solve_readings(s, side, traffic, work, cfg,
                                     s.get("problem_out"))
        excess.append(vals["excess"])
        for k, v in vals.items():
            out[f"_robot{r}_{k.lstrip('_')}"] = v
    out["solve_cost_excess"] = (max(excess) if len(solved) == robots
                                else None)
    return out

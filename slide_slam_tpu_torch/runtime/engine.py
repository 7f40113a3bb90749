"""The per-keyframe engine step (PyTorch twin of the solo parts of
slide_slam_tpu/runtime/engine.py).

    submap top-K -> project scan to world -> NN data association ->
    landmark insert / hit update -> factor append -> warm-started GN solve.

The JAX version appends with `.at[dest].set(..., mode="drop")` and silently
drops two kinds of destination: the `1 << 30` sentinel of a masked-off row,
and any `count + cumsum - 1` at or past capacity. On CUDA an out-of-range
index is a device-side assert, so here every append is a masked gather
instead (`_append_rows`): row j of the array takes the (j - count)-th
selected source row when that exists, and keeps its value otherwise. Hit
counts use `index_put_(..., accumulate=True)` with masked rows adding 0.
Nothing is read back to the host, and the overflow counters count exactly
what the JAX version drops.

The state is functional: each step returns a new GraphState (the JAX
version donates the old buffers; here the old tensors are simply released).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..factorgraph import schur, solver
from ..factorgraph.graph import GraphState
from ..geometry import se3
from ..objects import Cuboids, Cylinders, Ellipsoids
from ..ops import association, distances, submap
from .profiling import phase


class StepOutput(NamedTuple):
    pose: torch.Tensor            # [7] optimized key pose
    slot: torch.Tensor            # pose slot used (int32 0-d)
    n_new_cyl: torch.Tensor
    n_new_cub: torch.Tensor
    n_new_pt: torch.Tensor
    cyl_matches: torch.Tensor     # [S] int32 global landmark idx or -1
    cub_matches: torch.Tensor
    pt_matches: torch.Tensor
    overflow: torch.Tensor        # [8] int32 cumulative drop counters


def _append_dests(count, mask):
    """Destinations count + cumsum(mask) - 1 of the masked rows (int64);
    rows past capacity are dropped by `_append_rows`."""
    return count.long() + torch.cumsum(mask.long(), 0) - 1


def _append_rows(arr, count, mask, vals):
    """arr with the masked rows of `vals` written, in order, from row
    `count` on; writes at or past arr's capacity are dropped."""
    n_sel = mask.long().sum()
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    k = torch.arange(arr.shape[0], device=arr.device) - count.long()
    take = (k >= 0) & (k < n_sel)
    src = order[torch.clamp(k, 0, mask.shape[0] - 1)]
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    rows = vals.expand((mask.shape[0],) + arr.shape[1:])[src]
    return torch.where(take.reshape((-1,) + (1,) * (arr.ndim - 1)), rows, arr)


def _add_hits(hits, matches):
    """hits[m] += 1 for every m >= 0 (duplicates accumulate)."""
    ok = matches >= 0
    return hits.index_put((torch.clamp(matches.long(), min=0),),
                          ok.to(hits.dtype), accumulate=True)


def _associate(map_objs, scan_w, dist_fn, k, query):
    idx, mask = submap.topk_nearest(map_objs.centroid(), map_objs.valid,
                                    query, k)
    sub = type(map_objs)(*(a[idx.long()] for a in map_objs))
    sub = sub._replace(valid=sub.valid & mask)
    return idx, dist_fn(scan_w, sub)


def unpack_scan(packed: torch.Tensor):
    """One [S, 33] f32 tensor -> (Cylinders, Cuboids, Ellipsoids).

    Layout (host packer in node._pack_obs): cyl[root3 ray3 radius label
    valid] cub[pose7 scale3 label valid] ell[pose7 scale3 label valid]."""
    i32 = torch.int32
    cyl = Cylinders(root=packed[:, 0:3], ray=packed[:, 3:6],
                    radius=packed[:, 6], label=packed[:, 7].to(i32),
                    valid=packed[:, 8] > 0.5)
    cub = Cuboids(pose=packed[:, 9:16], scale=packed[:, 16:19],
                  label=packed[:, 19].to(i32), valid=packed[:, 20] > 0.5)
    ell = Ellipsoids(pose=packed[:, 21:28], scale=packed[:, 28:31],
                     label=packed[:, 31].to(i32), valid=packed[:, 32] > 0.5)
    return cyl, cub, ell


def _insert_family(s, names, count, cap, ovf_slot, valid, m, no_new, vals):
    """Landmark insert + hit update for one family; returns (state,
    new-mask, destinations)."""
    new = valid & (m == -1) & ~no_new
    dest = _append_dests(count, new)
    n_new = new.to(torch.int32).sum()
    count_new = torch.clamp(count + n_new, max=cap).to(torch.int32)
    upd = {name: _append_rows(getattr(s, name), count, new, v)
           for name, v in zip(names, vals)}
    hits_name = names[0].split("_")[0] + "_hits"
    upd[hits_name] = _add_hits(_append_rows(getattr(s, hits_name), count, new,
                                            1), m)
    upd[names[0].split("_")[0] + "_count"] = count_new
    ovf = s.overflow.clone()
    ovf[ovf_slot] += n_new - (count_new - count)
    return s._replace(overflow=ovf, **upd), new, dest


def _append_factors(s, prefix, count, cap, ovf_slot, valid, lm_idx, lm_cap,
                    vals):
    """Factor append for one family (fields prefix_<name>)."""
    ok = valid & (lm_idx >= 0) & (lm_idx < lm_cap)
    n_ok = ok.to(torch.int32).sum()
    count_new = torch.clamp(count + n_ok, max=cap).to(torch.int32)
    upd = {f"{prefix}_{name}": _append_rows(getattr(s, f"{prefix}_{name}"),
                                            count, ok, v)
           for name, v in vals.items()}
    upd[f"{prefix}_count"] = count_new
    ovf = s.overflow.clone()
    ovf[ovf_slot] += (n_ok - (count_new - count)
                      + (valid & (lm_idx >= lm_cap)).to(torch.int32).sum())
    return s._replace(overflow=ovf, **upd)


def _keyframe_body(cfg: SlamConfig, state: GraphState, robot_id: int,
                   pose_estimate, rel_odom, scan_cyl, scan_cub, scan_ell,
                   drop_detections: bool, odom_noise, cube_noise,
                   set_prior: bool = True):
    """DA + insert + factor append for one keyframe (no solve).

    set_prior=False (the peer-replay path): a replayed chain gets no gauge
    anchor. Freezing its first pose at tf o key_pose would bake the merge
    TF's error into the graph for good; peer chains hang off shared
    landmarks and relative factors instead."""
    s = state
    cap = cfg.capacity
    P = cap.max_poses_per_robot
    dev = s.poses.device
    pose_ok = s.pose_count[robot_id] < P
    drop = torch.as_tensor(bool(drop_detections), device=dev)
    if cfg.lc_region_match_only:
        kill = ~pose_ok
        no_new = drop | ~pose_ok
    else:
        kill = drop | ~pose_ok
        no_new = kill
    scan_cyl = scan_cyl._replace(valid=scan_cyl.valid & ~kill)
    scan_cub = scan_cub._replace(valid=scan_cub.valid & ~kill)
    scan_ell = scan_ell._replace(valid=scan_ell.valid & ~kill)

    cyl_w = scan_cyl.project(pose_estimate)
    cub_w = scan_cub.project(pose_estimate)
    ell_w = scan_ell.project(pose_estimate)
    query = se3.trans(pose_estimate)

    def matches(map_objs, scan_w, dist_fn, k, thresh, scan_valid):
        idx, d = _associate(map_objs, scan_w, dist_fn, k, query)
        m = association.to_global_indices(
            association.match_nearest(d, thresh), idx)
        return torch.where(scan_valid, m, torch.full_like(m, -1))

    cyl_m = matches(
        Cylinders(s.cyl_root, s.cyl_ray, s.cyl_radius, s.cyl_label,
                  s.cyl_valid()),
        cyl_w, distances.cylinder_pairwise, cap.submap_k_cylinder,
        cfg.cylinder_match_thresh, scan_cyl.valid)
    cub_m = matches(
        Cuboids(s.cub_pose, s.cub_scale, s.cub_label, s.cub_valid()),
        cub_w, distances.cuboid_pairwise, cap.submap_k_cuboid,
        cfg.cuboid_match_thresh, scan_cub.valid)
    ident = torch.zeros_like(s.pt_pos[:, :1]).expand(-1, 4).clone()
    ident[:, 0] = 1.0
    pt_m = matches(
        Ellipsoids(se3.from_quat_trans(ident, s.pt_pos), s.pt_scale,
                   s.pt_label, s.pt_valid()),
        ell_w, distances.ellipsoid_pairwise, cap.submap_k_ellipsoid,
        cfg.ellipsoid_match_thresh, scan_ell.valid)

    # ---- landmark insert / hit update ---------------------------------
    s, new_cyl, cyl_dest = _insert_family(
        s, ("cyl_root", "cyl_ray", "cyl_radius", "cyl_label"), s.cyl_count,
        cap.max_cylinders, 1, scan_cyl.valid, cyl_m, no_new,
        (cyl_w.root, cyl_w.ray, cyl_w.radius, cyl_w.label))
    s, new_cub, cub_dest = _insert_family(
        s, ("cub_pose", "cub_scale", "cub_label"), s.cub_count,
        cap.max_cuboids, 2, scan_cub.valid, cub_m, no_new,
        (cub_w.pose, cub_w.scale, cub_w.label))
    s, new_pt, pt_dest = _insert_family(
        s, ("pt_pos", "pt_scale", "pt_label"), s.pt_count, cap.max_points, 3,
        scan_ell.valid, pt_m, no_new,
        (ell_w.centroid(), ell_w.scale, ell_w.label))

    # ---- pose insert + odometry factor ---------------------------------
    count_r = s.pose_count[robot_id]
    slot = robot_id * P + torch.clamp(count_r.long(), max=P - 1)
    first = count_r == 0
    odom_sig = odom_noise * torch.clamp(
        torch.linalg.norm(se3.trans(rel_odom)), min=0.1)

    def put(arr, val):
        row = torch.where(pose_ok, torch.as_tensor(val, dtype=arr.dtype,
                                                   device=dev), arr[slot])
        return arr.index_put((slot[None],), row[None])

    one = torch.ones((), dtype=torch.int32, device=dev)
    pose_count = s.pose_count.clone()
    pose_count[robot_id] += pose_ok.to(torch.int32)
    prior_pose, prior_valid = s.prior_pose, s.prior_valid
    if set_prior:
        prior_pose, prior_valid = prior_pose.clone(), prior_valid.clone()
        prior_pose[robot_id] = torch.where(first, pose_estimate,
                                           s.prior_pose[robot_id])
        prior_valid[robot_id] = s.prior_valid[robot_id] | first
    ovf = s.overflow.clone()
    ovf[0] += one - pose_ok.to(torch.int32)
    s = s._replace(
        poses=put(s.poses, pose_estimate),
        keypose_xyz=put(s.keypose_xyz, se3.trans(pose_estimate)),
        odom_rel=put(s.odom_rel, rel_odom),
        odom_sigma=put(s.odom_sigma, odom_sig),
        pose_count=pose_count, prior_pose=prior_pose, prior_valid=prior_valid,
        overflow=ovf)

    # ---- factor appends --------------------------------------------------
    slot32 = slot.to(torch.int32)
    cyl_lm = torch.where(new_cyl, cyl_dest, cyl_m.long())
    s = _append_factors(
        s, "cf", s.cf_count, cap.max_cylinder_factors, 4, scan_cyl.valid,
        cyl_lm, cap.max_cylinders,
        {"pose": slot32, "lm": cyl_lm.to(torch.int32),
         "meas": torch.cat([scan_cyl.ray, scan_cyl.root,
                            scan_cyl.radius[:, None]], dim=-1)})
    cub_lm = torch.where(new_cub, cub_dest, cub_m.long())
    cub_rng = torch.linalg.norm(se3.trans(scan_cub.pose), dim=-1)
    s = _append_factors(
        s, "kf", s.kf_count, cap.max_cuboid_factors, 5, scan_cub.valid,
        cub_lm, cap.max_cuboids,
        {"pose": slot32, "lm": cub_lm.to(torch.int32),
         "meas_pose": scan_cub.pose, "meas_scale": scan_cub.scale,
         "sigma": cube_noise[None, :] * torch.clamp(cub_rng, min=0.1)[:, None]})
    pt_lm = torch.where(new_pt, pt_dest, pt_m.long())
    p_body = se3.trans(scan_ell.pose)
    rng = torch.linalg.norm(p_body, dim=-1)
    s = _append_factors(
        s, "uf", s.uf_count, cap.max_point_factors, 6, scan_ell.valid,
        pt_lm, cap.max_points,
        {"pose": slot32, "lm": pt_lm.to(torch.int32),
         "bearing": p_body / torch.clamp(rng[:, None], min=1e-9),
         "range": rng})

    out = StepOutput(
        pose=s.poses[slot], slot=slot32,
        n_new_cyl=new_cyl.sum(), n_new_cub=new_cub.sum(),
        n_new_pt=new_pt.sum(),
        cyl_matches=cyl_m, cub_matches=cub_m, pt_matches=pt_m,
        overflow=s.overflow)
    return s, out


def _solve_budget(cfg: SlamConfig, state: GraphState, outer_iters, pcg_iters,
                  pcg_tol, line_search: bool = True,
                  step_tol: float = 0.0) -> GraphState:
    """The Schur solve, or the unified-variable one where
    SolverConfig.use_schur is False (both with exact f32 sums)."""
    # exact f32 solver math on the card (see schur.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (schur.solve if cfg.solver.use_schur else solver.solve)(
        state, cyl_sigma=cfg.noise.cylinder, bearing_sigma=cfg.noise.bearing,
        outer_iters=int(outer_iters), pcg_iters=int(pcg_iters),
        pcg_tol=float(pcg_tol), line_search=line_search,
        block_precond=cfg.solver.use_block_jacobi, step_tol=step_tol)


def keyframe_step(cfg: SlamConfig, state: GraphState, robot_id: int,
                  pose_estimate, rel_odom, scan_cyl: Cylinders,
                  scan_cub: Cuboids, scan_ell: Ellipsoids,
                  drop_detections: bool, do_solve: bool,
                  odom_noise: torch.Tensor, cube_noise: torch.Tensor,
                  enable_solve: bool = True):
    """DA + insert for one keyframe at `pose_estimate` (prevKeyPose o
    relOdom, or tf o keyPose for a replay), then, where `do_solve` (a host
    bool, or a 0-d tensor read once) and `enable_solve`, the incremental
    solve of the JAX `_keyframe_body`. Returns (state, StepOutput)."""
    with phase("step.body"):
        s, out = _keyframe_body(cfg, state, robot_id, pose_estimate,
                                rel_odom, scan_cyl, scan_cub, scan_ell,
                                drop_detections, odom_noise, cube_noise)
    if enable_solve and bool(do_solve):
        sc = cfg.solver
        s = _solve_budget(cfg, s, sc.incremental_outer_iterations,
                          sc.pcg_max_iterations, sc.pcg_tol,
                          line_search=sc.incremental_line_search,
                          step_tol=sc.incremental_step_tol)
        out = out._replace(pose=s.poses[out.slot.long()],
                           overflow=s.overflow)
    return s, out


def keyframe_step_packed(cfg: SlamConfig, state: GraphState, robot_id: int,
                         pose_and_rel: torch.Tensor,
                         packed_scan: torch.Tensor, flags,
                         odom_noise: torch.Tensor, cube_noise: torch.Tensor,
                         enable_solve: bool = True):
    """keyframe_step on one [S, 33] packed scan: pose_and_rel [2, 7]
    (pose estimate, rel odom), flags [2] (drop_detections, do_solve)."""
    cyl, cub, ell = unpack_scan(packed_scan)
    drop, do_solve = (bool(f) for f in flags)
    return keyframe_step(cfg, state, robot_id, pose_and_rel[0],
                         pose_and_rel[1], cyl, cub, ell, drop, do_solve,
                         odom_noise, cube_noise, enable_solve)


def keyframe_step_fused(cfg: SlamConfig, state: GraphState, robot_id: int,
                        odom_and_rel: torch.Tensor, packed_scan: torch.Tensor,
                        drop_detections: bool, solver_budget,
                        odom_noise: torch.Tensor, cube_noise: torch.Tensor):
    """Pose-estimate chaining (prev optimized pose ∘ rel odom, or the raw
    odometry pose for the first keyframe), DA + insert, and the warm-started
    incremental solve. `solver_budget` = (outer_iters, pcg_iters, pcg_tol)."""
    P = cfg.capacity.max_poses_per_robot
    count_r = state.pose_count[robot_id]
    prev_pose = state.poses[robot_id * P + torch.clamp(count_r.long() - 1,
                                                       min=0)]
    rel = odom_and_rel[1]
    pose_est = torch.where(count_r == 0, odom_and_rel[0],
                           se3.compose(prev_pose, rel))
    with phase("step.body"):
        cyl, cub, ell = unpack_scan(packed_scan)
        s, out = _keyframe_body(cfg, state, robot_id, pose_est, rel, cyl,
                                cub, ell, drop_detections, odom_noise,
                                cube_noise)
    outer, pcg_iters, pcg_tol = solver_budget
    s = _solve_budget(cfg, s, outer, pcg_iters, pcg_tol,
                      line_search=cfg.solver.incremental_line_search,
                      step_tol=cfg.solver.incremental_step_tol)
    return s, out._replace(pose=s.poses[out.slot.long()])


def keyframe_batch_fused(cfg: SlamConfig, state: GraphState, robot_id: int,
                         odom_and_rel: torch.Tensor,
                         packed_scans: torch.Tensor, drop_detections,
                         solver_budget, odom_noise: torch.Tensor,
                         cube_noise: torch.Tensor):
    """B keyframe_step_fused bodies in order (pose chaining, DA + insert and
    the incremental solve per keyframe, exactly as one call each).

    The JAX version scans over a padded [B] batch with a `valid` mask; here
    the host loops over the B rows it is given, so there are no padding
    rows. odom_and_rel [B, 2, 7], packed_scans [B, S, 33], drop_detections
    [B] host bools. Returns (state, stacked per-keyframe poses [B, 7])."""
    poses = []
    for i in range(odom_and_rel.shape[0]):
        state, out = keyframe_step_fused(
            cfg, state, robot_id, odom_and_rel[i], packed_scans[i],
            bool(drop_detections[i]), solver_budget, odom_noise, cube_noise)
        poses.append(out.pose)
    return state, torch.stack(poses)


def replay_batch(cfg: SlamConfig, state: GraphState, robot_id: int,
                 poses_and_rels: torch.Tensor, packed_scans: torch.Tensor,
                 odom_noise: torch.Tensor,
                 cube_noise: torch.Tensor) -> GraphState:
    """Fold a chunk of PEER keyframes into chain `robot_id`: the DA + insert
    body per keyframe (no solve, no gauge anchor; the caller solves once
    after all chunks). poses_and_rels [N, 2, 7] (pose in the host frame,
    rel odom), packed_scans [N, S, 33]; the host loops over the N rows it
    is given (the JAX version's padding rows are absent)."""
    for i in range(poses_and_rels.shape[0]):
        with phase("step.body"):
            cyl, cub, ell = unpack_scan(packed_scans[i])
            state, _ = _keyframe_body(
                cfg, state, robot_id, poses_and_rels[i, 0],
                poses_and_rels[i, 1], cyl, cub, ell, False, odom_noise,
                cube_noise, set_prior=False)
    return state


def solve_full(cfg: SlamConfig, state: GraphState) -> GraphState:
    """Thorough solve: guarded line search, no step-norm exit (the JAX
    version also switches to exact curvature sums; the port's are always
    exact)."""
    sc = cfg.solver
    return _solve_budget(cfg, state, sc.max_outer_iterations,
                         sc.pcg_max_iterations, sc.pcg_tol)


def solve_incremental(cfg: SlamConfig, state: GraphState) -> GraphState:
    """Warm-started per-keyframe budget."""
    sc = cfg.solver
    return _solve_budget(cfg, state, sc.incremental_outer_iterations,
                         sc.incremental_pcg_iterations,
                         sc.incremental_pcg_tol,
                         line_search=sc.incremental_line_search,
                         step_tol=sc.incremental_step_tol)


def compact_map_rows(cfg: SlamConfig, state: GraphState,
                     min_hits: int) -> torch.Tensor:
    """All landmark families as [NC+NK+NU, 8] rows
    [label, x, y, z, dim1, dim2, dim3, valid]."""
    s = state
    f = s.cyl_root.dtype

    def fam(count, hits, lab, xyz, dims):
        valid = ((torch.arange(lab.shape[0], device=lab.device) < count)
                 & (hits >= min_hits))
        return torch.cat([lab[:, None].to(f), xyz, dims, valid[:, None].to(f)],
                         dim=1)

    cyl_dims = torch.cat([s.cyl_radius[:, None],
                          torch.zeros_like(s.cyl_root[:, :2])], dim=1)
    return torch.cat([
        fam(s.cyl_count, s.cyl_hits, s.cyl_label, s.cyl_root, cyl_dims),
        fam(s.cub_count, s.cub_hits, s.cub_label, s.cub_pose[:, 4:7],
            s.cub_scale),
        fam(s.pt_count, s.pt_hits, s.pt_label, s.pt_pos, s.pt_scale),
    ], dim=0)


def add_between_factor(cfg: SlamConfig, state: GraphState, slot_i: int,
                       slot_j: int, rel: torch.Tensor,
                       sigma: torch.Tensor) -> GraphState:
    """Append a loop-closure / relative-measurement between factor
    (graph.cpp:233-258). A full between-factor array drops the append and
    counts overflow[7]; the write is masked on the device (no host read)."""
    s = state
    k = s.bf_count
    ok = k < s.bf_i.shape[0]
    row = torch.clamp(k.long(), max=s.bf_i.shape[0] - 1)[None]

    def put(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        return arr.index_put((row,), torch.where(ok, val, arr[row[0]])[None])

    ovf = s.overflow.clone()
    ovf[7] += 1 - ok.to(torch.int32)
    return s._replace(
        bf_i=put(s.bf_i, slot_i), bf_j=put(s.bf_j, slot_j),
        bf_rel=put(s.bf_rel, rel), bf_sigma=put(s.bf_sigma, sigma),
        bf_count=k + ok.to(torch.int32), overflow=ovf)

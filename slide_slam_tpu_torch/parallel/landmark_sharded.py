"""Landmark-sharded bundle adjustment (PyTorch twin of
slide_slam_tpu/parallel/landmark_sharded.py).

The factor-sharded tier (distributed_ba.py) replicates the variables. This
one partitions the landmark arrays: each shard owns a contiguous block of
every landmark family and exactly the factors that reference its
landmarks, with their landmark indices rebased to the block:

* poses and the odometry chain: replicated (odom sigmas inflated by
  sqrt(n), so the summed chain information counts once);
* between factors: on shard 0 only;
* cylinders, cuboids, points and their factors: a local block per shard.

The solve is the Schur-eliminated one (factorgraph/schur.py) with a
`reduce`: each shard eliminates its landmarks, the replicated pose system's
PCG sums the shards' Schur corrections, and the back-substitution is local.
The shards run in one process as a leading axis of the stacked state
(threads in lockstep on one device), or one per process of a
torch.distributed group.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..factorgraph import schur
from ..factorgraph.graph import GraphState
from .reduce import all_reduce_sum, run_in_lockstep

# landmark families: (array fields, count field, factor fields, factor count)
_FAMILIES = (
    (("cyl_ray", "cyl_root", "cyl_radius", "cyl_label", "cyl_hits"),
     "cyl_count", ("cf_pose", "cf_lm", "cf_meas"), "cf_count"),
    (("cub_pose", "cub_scale", "cub_label", "cub_hits"), "cub_count",
     ("kf_pose", "kf_lm", "kf_meas_pose", "kf_meas_scale", "kf_sigma"),
     "kf_count"),
    (("pt_pos", "pt_scale", "pt_label", "pt_hits"), "pt_count",
     ("uf_pose", "uf_lm", "uf_bearing", "uf_range"), "uf_count"),
)
_BF_FIELDS = ("bf_i", "bf_j", "bf_rel", "bf_sigma")


def shard_state_by_landmark(state: GraphState, n: int) -> GraphState:
    """n per-shard states stacked along a leading axis, the landmark arrays
    block-partitioned: landmark l of a family with shard capacity C lives
    on shard l // C at slot l % C, and its factors are routed there (order
    kept) with rebased indices. A shard's factor capacity is its routed
    count rounded up to a multiple of 64."""
    host = convert.state_to_numpy(state)
    out = {}
    for lm_fields, lm_count, f_fields, f_count in _FAMILIES:
        cap = host[lm_fields[0]].shape[0]
        shard_cap = -(-cap // n)
        for f in lm_fields:
            a = host[f]
            padded = np.concatenate(
                [a, np.zeros((shard_cap * n - cap,) + a.shape[1:], a.dtype)])
            out[f] = padded.reshape((n, shard_cap) + a.shape[1:])
        out[lm_count] = np.clip(int(host[lm_count]) - shard_cap * np.arange(n),
                                0, shard_cap).astype(np.int32)
        fcnt = int(host[f_count])
        lm_field = f_fields[1]
        owner = host[lm_field][:fcnt] // shard_cap
        per_shard = (np.bincount(owner, minlength=n) if fcnt
                     else np.zeros(n, int))
        local_cap = max(64, int(-(-int(per_shard.max(initial=0)) // 64) * 64))
        for f in f_fields:
            out[f] = np.zeros((n, local_cap) + host[f].shape[1:],
                              host[f].dtype)
        for shard in range(n):
            sel = np.nonzero(owner == shard)[0]
            for f in f_fields:
                vals = host[f][sel]
                if f == lm_field:
                    vals = vals - shard * shard_cap
                out[f][shard, :len(sel)] = vals
        out[f_count] = per_shard.astype(np.int32)
    for f in _BF_FIELDS:
        out[f] = np.zeros((n,) + host[f].shape, host[f].dtype)
        out[f][0] = host[f]
    out["bf_count"] = np.asarray([int(host["bf_count"])] + [0] * (n - 1),
                                 np.int32)
    for f in GraphState._fields:
        if f in out:
            continue
        a = host[f]
        if f == "odom_sigma":
            a = (a * np.sqrt(float(n))).astype(a.dtype)
        out[f] = np.broadcast_to(a, (n,) + a.shape)
    dev = state.poses.device
    return GraphState(**{f: torch.as_tensor(np.ascontiguousarray(out[f]),
                                            device=dev)
                         for f in GraphState._fields})


def unshard_state_by_landmark(stacked: GraphState,
                              original: GraphState) -> GraphState:
    """The poses from shard 0 (replicated), the landmark blocks put back in
    the original layout; the original factor arrays and counts."""
    lm_fields = {f for fam in _FAMILIES for f in fam[0]}
    pose_fields = {"poses", "pose_count", "prior_pose", "prior_valid",
                   "keypose_xyz"}
    out = {}
    for f in GraphState._fields:
        a = getattr(stacked, f)
        if f in lm_fields:
            cap = getattr(original, f).shape[0]
            out[f] = a.reshape((-1,) + tuple(a.shape[2:]))[:cap]
        elif f in pose_fields:
            out[f] = a[0]
        else:
            out[f] = getattr(original, f)
    return GraphState(**out)


def _solve(cfg: SlamConfig, local: GraphState, reduce) -> GraphState:
    return schur.solve(
        local, cyl_sigma=cfg.noise.cylinder, bearing_sigma=cfg.noise.bearing,
        outer_iters=cfg.solver.max_outer_iterations,
        pcg_iters=cfg.solver.pcg_max_iterations, pcg_tol=cfg.solver.pcg_tol,
        reduce=reduce)


def build_landmark_sharded_solve(cfg: SlamConfig, group=None):
    """The landmark-sharded Schur solve: stacked GraphState [n, ...] -> the
    same (n shards in lockstep in this process), or with a torch.distributed
    group this process's shard -> its solved shard."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if group is not None:
        reduce = all_reduce_sum(group)
        return lambda local: _solve(cfg, local, reduce)

    def solve_stacked(stacked: GraphState) -> GraphState:
        n = stacked.poses.shape[0]
        shards = run_in_lockstep(
            lambda i, reduce: _solve(
                cfg, GraphState(*(f[i] for f in stacked)), reduce), n)
        return GraphState(*(torch.stack(f) for f in zip(*shards)))
    return solve_stacked


def landmark_sharded_solve(state: GraphState, cfg: SlamConfig,
                           n_shards: int = 4, group=None) -> GraphState:
    """Shard by landmark -> solve -> unshard, n_shards in this process or
    one shard per process of a torch.distributed group (every process
    passes the same state; each gets the whole result)."""
    if group is None:
        solved = build_landmark_sharded_solve(cfg)(
            shard_state_by_landmark(state, n_shards))
        return unshard_state_by_landmark(solved, state)
    import torch.distributed as dist
    from .multiprocess import local_batch_to_global
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    local = GraphState(*(f[rank] for f in shard_state_by_landmark(state, n)))
    solved = build_landmark_sharded_solve(cfg, group)(local)
    # every shard's landmark block, stacked in rank order
    gathered = GraphState(*(local_batch_to_global(f[None], group)
                            for f in solved))
    return unshard_state_by_landmark(gathered, state)
